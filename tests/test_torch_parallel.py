"""``parallel/`` on ``torch.distributed``: the sharded bundle adjustment
over 1, 2 and 4 spawned ``gloo`` CPU ranks against the port's
single-process iterations and the reference's, the process-group helpers,
and the package's entry points.

The reference's ``bundle_adjust_sharded`` needs a device mesh; here its
unsharded equal stands in: ``stereo_svo_tpu.backend.ba.ba_iteration`` with
``reduce_fn=None``, ``cfg.ba_iters`` times under the same gauge, which is
what its ``shard_map`` body computes when the shards are summed.

Every test that spawns processes has a time limit of its own: ranks still
running after it are killed and the test fails.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from stereo_svo_tpu.backend import ba as jba
from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.config import SvoConfig as JCfg
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu_torch import entry
from stereo_svo_tpu_torch.backend import ba
from stereo_svo_tpu_torch.backend import loop_closure
from stereo_svo_tpu_torch.geometry import se3
from stereo_svo_tpu_torch.parallel import dist_ba
from stereo_svo_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 120.0


def _problem(case: str):
    """The dry run's seeded geometry at 32 landmarks (so that 1, 2 and 4
    shards cut the same problem), as a dict of numpy arrays.

    "mono": the dry run itself: every keyframe sees every landmark, no
      disparities, default gauge.
    "stereo": measured disparities on 3 of 4 observations, one invalid
      keyframe slot and a few masked landmarks.
    "two_blocks": with disparities; keyframes 0-1 see landmarks 0-15 only
      and keyframes 2-3 the rest: two disconnected pose blocks, one pinned
      keyframe each.
    """
    cam, cfg, T_wk, X, obs_uv = dist_ba.dryrun_problem(4)
    K, N = T_wk.shape[0], X.shape[0]
    rng = np.random.default_rng(1)
    whole = dict(kf_T_wk=T_wk, kf_valid=np.ones(K, bool), X=X,
                 X_mask=np.ones(N, bool), obs_uv=obs_uv,
                 obs_mask=np.ones((K, N), bool))
    if case != "mono":
        X_true = torch.from_numpy(X - 0.01)
        z = np.stack([se3.transform(se3.inverse(torch.from_numpy(T_wk[k])),
                                    X_true)[:, 2].numpy() for k in range(K)])
        whole["obs_disp"] = (cam.fx * cam.baseline / z).astype(np.float32)
        whole["obs_dmask"] = rng.uniform(size=(K, N)) < 0.75
    if case == "stereo":
        whole["kf_valid"] = np.array([True, True, False, True])
        whole["X_mask"] = rng.uniform(size=N) < 0.9
    if case == "two_blocks":
        mask = np.zeros((K, N), bool)
        mask[:2, :16] = True
        mask[2:, 16:] = True
        whole["obs_mask"] = mask
        whole["fixed_mask"] = np.array([1, 0, 1, 0], np.float32)
    return cam, cfg, whole


def _single_process(cam, cfg, whole):
    """The port's ``ba_iteration`` on the whole problem, no reduction."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in whole.items()}
    K = t["kf_T_wk"].shape[0]
    disp = t.get("obs_disp", torch.zeros(t["obs_mask"].shape))
    dmask = t.get("obs_dmask", torch.zeros_like(t["obs_mask"]))
    fixed = t.get("fixed_mask")
    if fixed is None:
        first = torch.argmax(t["kf_valid"].to(torch.int32))
        fixed = ((torch.arange(K) == first) | ~t["kf_valid"]).float()
    T_kw, X = se3.inverse(t["kf_T_wk"]), t["X"]
    w_rows = ba.obs_weights(t["kf_valid"], t["X_mask"], t["obs_mask"], dmask)
    for _ in range(cfg.ba_iters):
        T_kw, X, _ = ba.ba_iteration(cam, cfg, T_kw, X, t["obs_uv"],
                                     t["obs_uv"][..., 0] - disp, w_rows,
                                     fixed, solver="direct")
    return se3.inverse(T_kw).numpy(), X.numpy()


def _reference(cam, cfg, whole):
    """The same iterations with the JAX package (``reduce_fn=None``)."""
    jcam = JCam(**dataclasses.asdict(cam))
    jcfg = JCfg(camera=jcam, ba_iters=cfg.ba_iters,
                max_keyframes=cfg.max_keyframes)
    j = {k: jnp.asarray(v) for k, v in whole.items()}
    K = j["kf_T_wk"].shape[0]
    disp = j.get("obs_disp", jnp.zeros(j["obs_mask"].shape, jnp.float32))
    dmask = j.get("obs_dmask", jnp.zeros(j["obs_mask"].shape, bool))
    fixed = j.get("fixed_mask")
    if fixed is None:
        fixed = ((jnp.arange(K) == jnp.argmax(j["kf_valid"]))
                 | ~j["kf_valid"]).astype(jnp.float32)
    T_kw, X = jse3.inverse(j["kf_T_wk"]), j["X"]
    w_rows = jba.obs_weights(j["kf_valid"], j["X_mask"], j["obs_mask"], dmask)
    for _ in range(jcfg.ba_iters):
        T_kw, X, _ = jba.ba_iteration(jcam, jcfg, T_kw, X, j["obs_uv"],
                                      j["obs_uv"][..., 0] - disp, w_rows,
                                      fixed, solver="direct")
    return np.asarray(jse3.inverse(T_kw)), np.asarray(X)


@pytest.mark.parametrize("case", ["mono", "stereo", "two_blocks"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_ba_matches_single_process_and_reference(n, case):
    cam, cfg, whole = _problem(case)
    ranks = dist_ba.bundle_adjust_local(n, cam, cfg,
                                        timeout_s=SPAWN_TIMEOUT_S, **whole)
    assert len(ranks) == n
    T = ranks[0][0]
    X = np.concatenate([x for _, x in ranks])
    assert np.isfinite(T).all() and np.isfinite(X).all()
    # every rank solves the same reduced system: the same poses, bit for bit
    for T_r, X_r in ranks[1:]:
        np.testing.assert_array_equal(T_r, T)
        assert X_r.shape == (whole["X"].shape[0] // n, 3)
    T_one, X_one = _single_process(cam, cfg, whole)
    if n == 1:
        # one shard: the all-reduce adds nothing, the sums are the same
        np.testing.assert_array_equal(T, T_one)
        np.testing.assert_array_equal(X, X_one)
    # Up to reduction order: the pose-side blocks are float32 sums over 32
    # landmarks taken in 2 or 4 partial sums, then a 24×24 solve and two
    # iterations; poses are O(0.1 m), landmarks up to 6 m away (one float32
    # ulp there is 5e-7). Measured with disparities: 2.8e-7 on the poses
    # and 1.2e-5 on the landmarks at most; without them (see below) 6.7e-6
    # and 9.7e-5.
    well = case != "mono"
    np.testing.assert_allclose(T, T_one, atol=1e-6 if well else 5e-5)
    np.testing.assert_allclose(X, X_one, atol=3e-5 if well else 5e-4)
    # Against the JAX package the einsum orders differ as well. With
    # disparities the problem is well conditioned (measured: 3e-7 on the
    # poses, 9e-6 on the landmarks). Without them the window's scale is a
    # free direction held only by the damping: the two packages' single-
    # process results already differ by a scale factor of 0.9989 (2.1e-4
    # on the poses, 6.2e-3 on landmarks 2-6 m away), which is the
    # problem's conditioning and no property of the sharding.
    T_ref, X_ref = _reference(cam, cfg, whole)
    if case == "mono":
        np.testing.assert_allclose(T, T_ref, atol=1e-3)
        np.testing.assert_allclose(X, X_ref, rtol=5e-3, atol=5e-3)
    else:
        np.testing.assert_allclose(T, T_ref, atol=5e-6)
        np.testing.assert_allclose(X, X_ref, atol=5e-5)
    # the solve brought the landmarks back from their 1 cm offset
    if well:
        keep = whole["X_mask"]
        assert np.abs(X - (whole["X"] - 0.01))[keep].mean() < 1e-4
    if case == "stereo":                   # masked slots stay as they were
        np.testing.assert_array_equal(T[2], whole["kf_T_wk"][2])
    if case == "two_blocks":               # the two pinned keyframes
        np.testing.assert_allclose(T[[0, 2]], whole["kf_T_wk"][[0, 2]],
                                   atol=1e-6)


def test_reduce_fn_leaves_its_argument_untouched():
    assert mesh_mod.spawn_local(workers.reduce_leaves_argument, 2,
                                timeout_s=SPAWN_TIMEOUT_S) == [True, True]


def test_mesh_2d_groups():
    """(data, kf) = (2, 2) over 4 ranks: rank = data·2 + kf; the kf group
    joins a row, the data group a column; ``make(3)`` leaves rank 3 out."""
    got = mesh_mod.spawn_local(workers.mesh_2d_coordinates, 4, (2, 2),
                               timeout_s=SPAWN_TIMEOUT_S)
    for rank, (d, k, sums, outside) in enumerate(got):
        assert (d, k) == (rank // 2, rank % 2)
        assert sums["kf"] == {0: 11.0, 1: 1100.0}[d]
        assert sums["data"] == {0: 101.0, 1: 1010.0}[k]
        assert outside == (rank == 3)


def test_spawn_local_kills_hung_ranks_at_its_time_limit():
    with pytest.raises(TimeoutError, match="still running"):
        mesh_mod.spawn_local(workers.hang, 2, timeout_s=8.0)


def test_spawn_local_raises_a_rank_failure():
    with pytest.raises(Exception, match="rank 1 fails"):
        mesh_mod.spawn_local(workers.fail_on_rank_one, 2,
                             timeout_s=SPAWN_TIMEOUT_S)


def test_shard_cuts_the_landmark_axis():
    _, _, whole = _problem("stereo")
    parts = [dist_ba.shard(i, 4, whole["X"], whole["X_mask"],
                           whole["obs_uv"], whole["obs_mask"],
                           whole["obs_disp"], whole["obs_dmask"])
             for i in range(4)]
    for j, name in enumerate(("X", "X_mask")):
        np.testing.assert_array_equal(
            np.concatenate([p[j] for p in parts]), whole[name])
    for j, name in ((2, "obs_uv"), (3, "obs_mask"), (4, "obs_disp"),
                    (5, "obs_dmask")):
        np.testing.assert_array_equal(
            np.concatenate([p[j] for p in parts], 1), whole[name])
    assert dist_ba.shard(0, 2, whole["X"], whole["X_mask"], whole["obs_uv"],
                         whole["obs_mask"])[4:] == (None, None)
    with pytest.raises(ValueError):
        dist_ba.shard(0, 5, whole["X"], whole["X_mask"], whole["obs_uv"],
                      whole["obs_mask"])


@pytest.mark.parametrize("n", [2, 4])
def test_dist_ba_dryrun(n):
    dist_ba.dryrun(n, timeout_s=SPAWN_TIMEOUT_S)


def test_dryrun_multichip_4(capsys):
    entry.dryrun_multichip(4, timeout_s=SPAWN_TIMEOUT_S)
    assert "dryrun_multichip(4): OK" in capsys.readouterr().out


def test_entry_takes_one_step_on_the_cpu():
    """``entry(device="cpu")``: the flagship step at 752×480 on seeded
    noise frames bootstraps a keyframe; without a card the default
    raises."""
    fn, args = entry.entry(device="cpu")
    state, left, right, flags = args
    assert left.shape == (480, 752) and not flags.booted
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        left.numpy(), rng.uniform(0, 255, (480, 752)).astype(np.float32))
    new_state, out, new_flags = fn(*args)
    assert bool(out.kf_inserted) and new_flags.booted
    assert int(new_state.frame_idx) == 1
    assert torch.isfinite(out.T_wc).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            entry.entry()


def test_similarity_matches_reference():
    from stereo_svo_tpu.backend import loop_closure as jloop
    rng = np.random.default_rng(2)
    bank = rng.normal(size=(12, 48)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    desc = bank[5]
    ours = loop_closure.similarity(torch.from_numpy(desc),
                                   torch.from_numpy(bank)).numpy()
    ref = np.asarray(jloop.similarity(jnp.asarray(desc), jnp.asarray(bank)))
    # one 48-term float32 dot product per score
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    assert ours.argmax() == 5 and abs(ours[5] - 1.0) < 1e-6
