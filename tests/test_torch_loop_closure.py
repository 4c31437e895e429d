"""The port's loop closure (``backend/loop_closure.py``: query variants,
edge proposals, thumbnail edge measurement, ``close_loops``,
``refine_trajectory``) against the JAX reference on the fixtures of
tests/test_loop_closure.py and tests/test_online_loop.py.

JAX runs on the CPU; the port runs on ``device="cpu"``, where kernels B2-B4
take their plain versions. ``torch.topk`` and ``lax.top_k`` may order equal
scores differently, so proposals are compared as sets of valid edges with
their scores; edges below the score gate are only checked to be finite
(ROADMAP W10).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.backend import loop_closure as jlc
from stereo_svo_tpu.engine import state as jstate
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu_torch.backend import loop_closure as lc
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import state as state_mod
from test_loop_closure import CFG as JCFG
from test_loop_closure import _edge_fixture, _grid_obs, _render
from test_online_loop import _small_cfg as _jsmall_cfg

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

DRIFT = [0.03, -0.02, 0.04, 0.01, -0.012, 0.008]
# the reference functions jitted once per configuration and shape: eager
# JAX compiles the vmapped alignment op by op, ~4x slower
JIT_MEASURE = jax.jit(jlc.measure_edges, static_argnums=0)
JIT_CLOSE = jax.jit(jlc.close_loops, static_argnums=0)


def _port_cfg(jcfg):
    """The port's SvoConfig with every field of a JAX one."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["camera"] = CameraConfig(**dataclasses.asdict(jcfg.camera))
    return SvoConfig(**kw)


CFG = _port_cfg(JCFG)


def _t(a):
    return torch.from_numpy(np.array(a))


def _valid_set(props, digits=5):
    """{(i, j): score} of the proposals above the gate."""
    return {tuple(int(x) for x in e): round(float(s), digits)
            for e, s, v in zip(np.asarray(props.edges_ij),
                               np.asarray(props.score),
                               np.asarray(props.valid)) if v}


@pytest.fixture(scope="module")
def fixture():
    """_edge_fixture's two keyframes (KF1's stored pose drifted), numpy."""
    return [np.asarray(a) for a in _edge_fixture(DRIFT)]


def test_query_descriptors_match_reference():
    _, img = _render(0.6)
    img = np.asarray(img)
    for n_rot in (0, 2):
        ours = lc.query_descriptors(_t(img), 6, 8, n_rot=n_rot)
        ref = jlc.query_descriptors(jnp.asarray(img), 6, 8, n_rot=n_rot)
        assert ours.shape == (9 + 2 * n_rot, 48)
        # the shifts: float32 pooled means and norms, a few ulps apart; the
        # rotations resample bilinearly at float32 coordinates
        np.testing.assert_allclose(ours[:9].numpy(), np.asarray(ref[:9]),
                                   atol=5e-6)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("shifted", [False, True])
def test_propose_edges_matches_reference(shifted):
    """A bank of 8 views with revisits: the same valid edges and scores
    (within 1e-5), with and without the per-keyframe query variants."""
    times = [0.0, 0.5, 1.0, 1.5, 0.02, 0.52, 2.5, 1.02]
    thumbs = np.stack([np.asarray(_render(t)[1]) for t in times])
    desc = np.stack([np.asarray(jlc.descriptor(jnp.asarray(th), 6, 8))
                     for th in thumbs])
    valid = np.array([True] * 7 + [False])
    stamp = (np.arange(8) * 10).astype(np.int32)
    seq = np.zeros(8, np.int32)
    shift = None
    if shifted:
        shift = np.stack([np.asarray(jlc.query_descriptors(
            jnp.asarray(th), 6, 8, n_rot=2)) for th in thumbs])
    kw = dict(min_score=0.6, min_gap=15, max_edges=6)
    ref = jlc.propose_edges(
        jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(stamp),
        jnp.asarray(seq), desc_shift=None if shift is None
        else jnp.asarray(shift), **kw)
    ours = lc.propose_edges(
        _t(desc), _t(valid), _t(stamp), _t(seq),
        desc_shift=None if shift is None else _t(shift), **kw)
    got, want = _valid_set(ours), _valid_set(ref)
    assert len(want) >= 2, want          # the revisits (0,4), (1,5) at least
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert torch.all(torch.isfinite(ours.score))
    assert ours.edges_ij.dtype == torch.int32


def test_propose_online_matches_reference():
    """test_online_loop.py's bank of random thumbnails, queried with slot
    3's own thumbnail: slot 3 first, the gap respected, in both packages."""
    jcfg = _jsmall_cfg()
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(0)
    M = cfg.mem_keyframes
    th, tw = cfg.thumb_shape
    thumbs = rng.uniform(0, 255, (M, th, tw)).astype(np.float32)
    desc = np.stack([np.asarray(jlc.descriptor(jnp.asarray(t),
                                               cfg.loop_desc_rows,
                                               cfg.loop_desc_cols))
                     for t in thumbs])
    valid = np.ones(M, bool)
    stamp = (np.arange(M) * 10).astype(np.int32)
    ref = jlc.propose_online(jcfg, jnp.asarray(desc), jnp.asarray(valid),
                             jnp.asarray(stamp), jnp.asarray(M - 1, jnp.int32),
                             jnp.asarray(thumbs[3]))
    ours = lc.propose_online(cfg, _t(desc), _t(valid), _t(stamp),
                             torch.tensor(M - 1, dtype=torch.int32),
                             _t(thumbs[3]))
    assert ours.edges_ij[0].tolist() == [3, M - 1]
    assert bool(ours.valid[0])
    assert _valid_set(ours) == _valid_set(ref)
    for e in range(cfg.online_loop_edges):
        if bool(ours.valid[e]):
            assert abs(int(stamp[ours.edges_ij[e, 0]]) - 110) >= \
                cfg.loop_min_gap


def _measure_both(cfg, jcfg, props_np, kf_T_wk, thumbs, obs_uv, obs_mask,
                  obs_disp):
    ref = JIT_MEASURE(
        jcfg, jlc.LoopProposals(*map(jnp.asarray, props_np)),
        *map(jnp.asarray, (kf_T_wk, thumbs, obs_uv, obs_mask, obs_disp,
                           obs_mask)))
    ours = lc.measure_edges(
        cfg, lc.LoopProposals(*map(_t, props_np)),
        *map(_t, (kf_T_wk, thumbs, obs_uv, obs_mask, obs_disp, obs_mask)))
    return ours, ref


def _props(edges, valid):
    return (np.asarray(edges, np.int32), np.ones(len(edges), np.float32),
            np.asarray(valid, bool))


def _assert_measurement_close(ours, ref):
    # 20 single-level Gauss-Newton passes whose float32 sums run in another
    # order than XLA's: the poses agree to ~1e-5, the fractions to one pixel
    np.testing.assert_allclose(ours.Z.numpy(), np.asarray(ref.Z), atol=1e-4)
    np.testing.assert_allclose(ours.inlier_frac.numpy(),
                               np.asarray(ref.inlier_frac), atol=2e-3)
    np.testing.assert_allclose(ours.rt_t.numpy(), np.asarray(ref.rt_t),
                               atol=1e-4)
    np.testing.assert_allclose(ours.rt_r.numpy(), np.asarray(ref.rt_r),
                               atol=1e-4)
    np.testing.assert_allclose(ours.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-3)
    np.testing.assert_array_equal(ours.accept.numpy(),
                                  np.asarray(ref.accept))


def test_measure_edges_matches_reference(fixture):
    """The drifted two-keyframe fixture: Z recovers the ground truth (as
    the reference's test asks) and agrees with the reference's Z."""
    kf_T_wk, thumbs, _, obs_uv, obs_mask, obs_disp, Z_true = fixture
    ours, ref = _measure_both(CFG, JCFG, _props([[0, 1]], [True]), kf_T_wk,
                              thumbs, obs_uv, obs_mask, obs_disp)
    _assert_measurement_close(ours, ref)
    assert bool(ours.accept[0])
    dr, dt = jse3.distance(jnp.asarray(ours.Z[0].numpy()),
                           jnp.asarray(Z_true))
    assert float(dt) < 0.02 and float(dr) < 0.01
    assert float(ours.rt_t[0]) < 0.5 * CFG.loop_rt_max_t


def test_roundtrip_gate_rejects_false_proposal(fixture):
    """tests/test_loop_closure.py:321-357: KF1's thumbnail and snapshot
    show another part of the world; both packages reject the edge."""
    kf_T_wk, thumbs, _, obs_uv, obs_mask, obs_disp, _ = fixture
    T_far, img_far = _render(3.0)
    from stereo_svo_tpu.ops import pyramid as jpyramid
    thumbs = thumbs.copy()
    obs_uv, obs_disp = obs_uv.copy(), obs_disp.copy()
    thumbs[1] = np.asarray(jpyramid.build(img_far, JCFG.num_levels)[
        JCFG.thumb_level])
    uv_far, disp_far = _grid_obs(T_far)
    obs_uv[1], obs_disp[1] = np.asarray(uv_far), np.asarray(disp_far)
    ours, ref = _measure_both(CFG, JCFG, _props([[0, 1]], [True]), kf_T_wk,
                              thumbs, obs_uv, obs_mask, obs_disp)
    assert not bool(ref.accept[0]) and not bool(ours.accept[0])
    # the false edge's alignments wander far from the drift scale, where
    # the two float32 chains part: compare the gate's inputs coarsely
    assert (float(ours.rt_t[0]) >= CFG.loop_rt_max_t
            or float(ours.rt_r[0]) >= CFG.loop_rt_max_r
            or min(float(ours.inlier_frac[0]), 1.0) < CFG.loop_accept_frac)


def test_invalid_proposal_returns_initial_pose(fixture):
    """An edge below the gate runs on an all-false mask: finite, Z is the
    stored relative pose (T_init) in both packages, never accepted."""
    kf_T_wk, thumbs, _, obs_uv, obs_mask, obs_disp, _ = fixture
    ours, ref = _measure_both(CFG, JCFG, _props([[0, 1]], [False]),
                              kf_T_wk, thumbs, obs_uv, obs_mask, obs_disp)
    for f in ours:
        assert torch.all(torch.isfinite(f.float())), f
    Z_init = np.asarray(jse3.compose(jse3.inverse(jnp.asarray(kf_T_wk[0])),
                                     jnp.asarray(kf_T_wk[1])))
    np.testing.assert_allclose(ours.Z[0].numpy(), Z_init, atol=1e-6)
    np.testing.assert_allclose(ours.Z.numpy(), np.asarray(ref.Z), atol=1e-6)
    assert not ours.accept.any()
    np.testing.assert_array_equal(ours.inlier_frac.numpy(), 0.0)


def test_close_loops_matches_reference(fixture):
    """The fixture as a two-keyframe bank 100 frames apart: the same
    accepted loop edge and measurement in both packages."""
    kf_T_wk, thumbs, descs, obs_uv, obs_mask, obs_disp, _ = fixture
    jcfg = dataclasses.replace(JCFG, loop_min_gap=5, loop_max_edges=2)
    cfg = _port_cfg(jcfg)
    valid = np.ones(2, bool)
    stamp = np.array([0, 100], np.int32)
    seq = np.zeros(2, np.int32)
    args = (kf_T_wk, valid, descs, thumbs, stamp, seq, obs_uv, obs_mask,
            obs_disp, obs_mask)
    g_ref, m_ref = JIT_CLOSE(jcfg, *map(jnp.asarray, args))
    g, m = lc.close_loops(cfg, *map(_t, args))
    assert float(g.weight.sum()) == float(g_ref.weight.sum()) == 1.0
    k = int(np.argmax(np.asarray(g_ref.weight)))
    k_ours = int(torch.argmax(g.weight))
    assert g.edges_ij[k_ours].tolist() == np.asarray(g_ref.edges_ij[k]).tolist()
    np.testing.assert_allclose(g.Z[k_ours].numpy(), np.asarray(g_ref.Z[k]),
                               atol=1e-4)
    assert torch.all(torch.isfinite(g.Z)) and torch.all(torch.isfinite(m.cost))


def _bank_state(jcfg):
    """A JAX SlamState whose memory bank holds six keyframes of a drifted
    out-and-back run: views at t = 0, 0.5, 1.0, 1.5, then revisits of
    0.02 and 0.52, each stored with the drift accumulated by then."""
    times = [0.0, 0.5, 1.0, 1.5, 0.02, 0.52]
    st = jstate.init_state(jcfg)
    M = jcfg.mem_keyframes
    N = jcfg.max_features
    T_wk = np.tile(np.asarray(jse3.identity()), (M, 1, 1))
    thumb = np.zeros((M,) + jcfg.thumb_shape, np.float32)
    desc = np.zeros((M, jcfg.desc_dim), np.float32)
    uv = np.zeros((M, N, 2), np.float32)
    disp = np.zeros((M, N), np.float32)
    mask = np.zeros((M, N), bool)
    from stereo_svo_tpu.ops import pyramid as jpyramid
    for k, t in enumerate(times):
        T_wc, img = _render(t)
        drift = jse3.exp(jnp.asarray(np.asarray(DRIFT, np.float32) * k / 5))
        T_wk[k] = np.asarray(jse3.compose(T_wc, drift))
        pyr = jpyramid.build(img, jcfg.num_levels)
        thumb[k] = np.asarray(pyr[jcfg.thumb_level])
        desc[k] = np.asarray(jlc.descriptor(pyr[jcfg.num_levels - 1],
                                            jcfg.loop_desc_rows,
                                            jcfg.loop_desc_cols))
        u, d = _grid_obs(T_wc)
        n = min(N, u.shape[0])
        uv[k, :n], disp[k, :n], mask[k, :n] = u[:n], d[:n], True
    valid = np.zeros(M, bool)
    valid[:len(times)] = True
    stamp = np.zeros(M, np.int32)
    stamp[:len(times)] = np.arange(len(times)) * 10
    st = st._replace(mem_T_wk=jnp.asarray(T_wk), mem_valid=jnp.asarray(valid),
                     mem_stamp=jnp.asarray(stamp), mem_desc=jnp.asarray(desc),
                     mem_thumb=jnp.asarray(thumb), mem_uv=jnp.asarray(uv),
                     mem_mask=jnp.asarray(mask), mem_disp=jnp.asarray(disp),
                     mem_dmask=jnp.asarray(mask),
                     mem_next=jnp.asarray(len(times), jnp.int32))
    return jax.tree.map(np.asarray, st)


def test_refine_trajectory_matches_reference(monkeypatch):
    """Offline loop closing on a JAX final state converted with
    state_from_numpy: the same accepted edges, optimised bank poses and
    refined trajectory (60 frames, each keyframe's correction applied from
    its stamp on). The reference's close_loops runs jitted."""
    monkeypatch.setattr(jlc, "close_loops", JIT_CLOSE)
    jcfg = dataclasses.replace(JCFG, max_features=108, mem_keyframes=8,
                               loop_min_gap=15, loop_min_score=0.8,
                               loop_max_edges=3)
    cfg = _port_cfg(jcfg)
    st_np = _bank_state(jcfg)
    traj = np.stack([np.asarray(_render(0.025 * i)[0]) for i in range(60)])
    ref_traj, ref_T, ref_n = jlc.refine_trajectory(
        jcfg, jax.tree.map(jnp.asarray, st_np), traj)
    ours_traj, ours_T, n = lc.refine_trajectory(
        cfg, state_mod.state_from_numpy(st_np, device="cpu"), traj)
    assert n == ref_n >= 1
    assert isinstance(ours_traj, np.ndarray) and isinstance(ours_T,
                                                            np.ndarray)
    assert np.isfinite(ours_traj).all() and np.isfinite(ours_T).all()
    # ten Gauss-Newton steps of a 48-parameter graph with the 1e12 gauge
    # pin, solved by two LU factorisations (LAPACK here, XLA there)
    np.testing.assert_allclose(ours_T, np.asarray(ref_T), atol=2e-4)
    np.testing.assert_allclose(ours_traj, np.asarray(ref_traj), atol=2e-4)
    moved = np.abs(ours_traj - traj).max()
    assert moved > 1e-3, "the loop edges corrected the trajectory"
