"""``parallel/mapping`` against the reference: the global map of two
sequences field by field, loop detection over it, the pose graph plus
sharded BA over ``gloo`` process groups, and the cloud alignment.

The two per-sequence states come from the JAX runner (the configuration of
tests/test_mapping.py) and are carried across with ``state_from_numpy``, so
both packages build their maps from identical inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.config import SvoConfig as JCfg
from stereo_svo_tpu.engine import runner as jrunner
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu.parallel import mapping as jmapping
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import state as state_mod
from stereo_svo_tpu_torch.geometry import se3
from stereo_svo_tpu_torch.parallel import mapping
from stereo_svo_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)

CAM_KW = dict(fx=160.0, fy=160.0, cx=94.0, cy=60.0, baseline=0.11,
              width=188, height=120)
CFG_KW = dict(grid_rows=6, grid_cols=8, max_features=48, num_levels=3,
              align_levels=3, klt_levels=2, stereo_max_disp=32,
              kf_min_tracked=15, border_margin=8, max_keyframes=4,
              ba_iters=3)
JCFG = JCfg(camera=JCam(**CAM_KW), **CFG_KW)
CFG = SvoConfig(camera=CameraConfig(**CAM_KW), **CFG_KW)
SPAWN_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def two_states():
    """Final states of two 10-frame JAX runs (seeds 0 and 4), as JAX
    pytrees and as port states on the CPU."""
    jstates = []
    for seed in (0, 4):
        lefts, rights, _ = jsynth.make_sequence(JCFG.camera, 10, dt=0.15,
                                                kind="arc", seed=seed)
        svo = jrunner.StereoSvo(JCFG)
        for l, r in zip(lefts, rights):
            svo.new_image(l, r)
        jstates.append(svo.state)
    states = [state_mod.state_from_numpy(jax.tree.map(np.asarray, s),
                                         device="cpu") for s in jstates]
    return jstates, states


@pytest.fixture(scope="module")
def gmaps(two_states):
    jstates, states = two_states
    return (jmapping.build_global_map(JCFG, jstates),
            mapping.build_global_map(CFG, states))


@pytest.mark.parametrize("field", mapping.GlobalMap._fields)
def test_build_global_map_field_by_field(gmaps, field):
    jgmap, gmap = gmaps
    ours, ref = getattr(gmap, field).numpy(), np.asarray(getattr(jgmap, field))
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    if field == "X":
        # world_points: a backprojection and a rigid transform in float32
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(ours, ref)


def test_global_map_is_block_diagonal(gmaps):
    _, gmap = gmaps
    B, K, N = 2, CFG.max_keyframes, CFG.max_features
    assert gmap.kf_T_wk.shape == (B * K, 3, 4)
    assert gmap.obs_uv.shape == (B * K, B * N, 2)
    assert not gmap.obs_mask[:K, N:].any() and not gmap.obs_mask[K:, :N].any()
    assert not gmap.obs_uv[:K, N:].any() and not gmap.obs_disp[K:, :N].any()
    assert int(gmap.kf_valid.sum()) >= 2 and int(gmap.X_mask.sum()) > 5
    assert gmap.kf_seq.tolist() == [0] * K + [1] * K


def test_detect_loop_edges_matches_reference(gmaps):
    """The same proposals and gates over the global bank: accepted edges
    as a set (order among rejected ties is free), their measurements
    within the thumbnail alignment's float32 tolerance."""
    jgmap, gmap = gmaps
    graph, meas = mapping.detect_loop_edges(CFG, gmap)
    jgraph, jmeas = jmapping.detect_loop_edges(JCFG, jgmap)
    assert graph.edges_ij.shape == tuple(jgraph.edges_ij.shape)
    ours = {tuple(e) for e, w in zip(graph.edges_ij.tolist(),
                                     graph.weight.tolist()) if w > 0}
    ref = {tuple(e) for e, w in zip(np.asarray(jgraph.edges_ij).tolist(),
                                    np.asarray(jgraph.weight).tolist())
           if w > 0}
    assert ours == ref
    assert torch.isfinite(meas.Z).all()


def _check_geometry(gmap, T_new, X_new, pg_cost):
    """tests/test_mapping.py's requirement: the input was consistent, so
    no valid pose moves by more than a small correction."""
    for k in np.where(gmap.kf_valid.numpy())[0]:
        _, dt = se3.distance(torch.as_tensor(T_new[k]), gmap.kf_T_wk[k])
        assert float(dt) < 0.05, f"KF{k} jumped {float(dt)} m"
    assert np.isfinite(pg_cost) and np.isfinite(X_new).all()
    assert np.isfinite(T_new).all()


@pytest.fixture()
def world_of_one():
    """A gloo process group of world size 1 inside the test process."""
    mesh_mod.initialize_multihost(device="cpu")
    yield mesh_mod.make(1, axis_name="kf")
    mesh_mod.shutdown()


def test_optimize_global_map_world_size_one(gmaps, world_of_one):
    _, gmap = gmaps
    refined, pg_cost = mapping.optimize_global_map(
        world_of_one, CFG.camera, CFG, gmap)
    _check_geometry(gmap, refined.kf_T_wk.numpy(), refined.X.numpy(),
                    float(pg_cost))
    assert refined.X.shape == gmap.X.shape
    for name in ("kf_valid", "obs_uv", "kf_desc"):     # carried unchanged
        assert getattr(refined, name) is getattr(gmap, name)
    # with loop edges appended (all rejected here: weight 0 changes nothing)
    graph, _ = mapping.detect_loop_edges(CFG, gmap)
    again, _ = mapping.optimize_global_map(
        world_of_one, CFG.camera, CFG, gmap,
        loop_edges=graph._replace(weight=torch.zeros_like(graph.weight)))
    np.testing.assert_allclose(again.kf_T_wk.numpy(),
                               refined.kf_T_wk.numpy(), atol=1e-5)


def test_optimize_global_map_matches_reference(gmaps, world_of_one):
    """Against the JAX function on its 8-device CPU mesh: the pose graph
    and 3 sharded BA iterations over 96 landmarks; poses within 1e-4 m
    (float32 Gauss-Newton chains on both sides), landmarks within 1e-3."""
    from stereo_svo_tpu.parallel import mesh as jmesh
    jgmap, gmap = gmaps
    jrefined, jcost = jmapping.optimize_global_map(
        jmesh.make(8, axis_name="kf"), JCFG.camera, JCFG, jgmap)
    refined, cost = mapping.optimize_global_map(
        world_of_one, CFG.camera, CFG, gmap)
    valid = gmap.kf_valid.numpy()
    np.testing.assert_allclose(refined.kf_T_wk.numpy()[valid],
                               np.asarray(jrefined.kf_T_wk)[valid],
                               atol=1e-4)
    keep = gmap.X_mask.numpy()
    np.testing.assert_allclose(refined.X.numpy()[keep],
                               np.asarray(jrefined.X)[keep], atol=1e-3)
    assert abs(float(cost) - float(jcost)) < 1e-6


def test_optimize_global_map_over_two_ranks(gmaps, world_of_one):
    """Two spawned ranks shard the 96 landmarks; each returns the whole
    refined map, equal to the one-rank result up to reduction order."""
    _, gmap = gmaps
    gmap_np = {k: v.numpy() for k, v in gmap._asdict().items()}
    ranks = mesh_mod.spawn_local(workers.optimize_map, 2,
                                 (CFG.camera, CFG, gmap_np),
                                 timeout_s=SPAWN_TIMEOUT_S)
    (T0, X0, c0), (T1, X1, c1) = ranks
    np.testing.assert_array_equal(T0, T1)
    np.testing.assert_array_equal(X0, X1)
    assert c0 == c1
    _check_geometry(gmap, T0, X0, c0)
    one, _ = mapping.optimize_global_map(world_of_one, CFG.camera, CFG, gmap)
    # float32 partial sums in another order, 3 iterations
    np.testing.assert_allclose(T0, one.kf_T_wk.numpy(), atol=1e-5)
    np.testing.assert_allclose(X0, one.X.numpy(), atol=1e-4)


def test_align_maps_umeyama_matches_reference():
    rng = np.random.default_rng(7)
    X_b = rng.normal(size=(60, 3)) * 3.0
    w = np.array([0.2, -0.1, 0.3])
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = np.array([1.0, -2.0, 0.5])
    X_a = X_b @ R.T + t + rng.normal(0, 1e-3, X_b.shape)
    ours = mapping.align_maps_umeyama(torch.from_numpy(X_a), X_b)
    ref = np.asarray(jmapping.align_maps_umeyama(X_a, X_b))
    assert ours.dtype == torch.float32 and ours.shape == (3, 4)
    # the same float64 SVD on both sides, rounded to float32 at the end
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_allclose(ours.numpy()[:, :3], R, atol=1e-3)
    np.testing.assert_allclose(ours.numpy()[:, 3], t, atol=5e-3)
