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
from stereo_svo_tpu_torch.ops import kernels
from stereo_svo_tpu_torch.ops.kernels import pyramid_kernel
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


def _float64(cam, cfg, whole):
    """The port's single-process iterations on float64 tensors."""
    return _single_process(cam, cfg, {
        k: v.astype(np.float64) if v.dtype == np.float32 else v
        for k, v in whole.items()})


def _unscaled(T, X, T_to, X_to):
    """(T, X) with the best-fit scale towards (T_to, X_to) taken out: one
    scalar s about the pinned keyframe's centre c, fitted over every
    keyframe centre and landmark (p − c ≈ s·(p_to − c)); rotations are
    left as they are. Returns (T', X', s)."""
    c = T_to[0, :, 3].astype(np.float64)
    P = np.concatenate([T[:, :, 3], X]).astype(np.float64) - c
    P_to = np.concatenate([T_to[:, :, 3], X_to]).astype(np.float64) - c
    s = float(np.sum(P * P_to) / np.sum(P_to * P_to))
    T = T.astype(np.float64).copy()
    T[:, :, 3] = c + (T[:, :, 3] - c) / s
    return T, c + (X.astype(np.float64) - c) / s, s


def _relative_difference(T, X, T_to, X_to) -> float:
    """||state(T, X) - state(T_to, X_to)|| / ||state(T_to, X_to)||, the
    state every pose's entries and landmark, positions about the pinned
    keyframe's centre in (T_to, X_to)."""
    c = T_to[0, :, 3].astype(np.float64)

    def state(T, X):
        T = T.astype(np.float64).copy()
        T[:, :, 3] -= c
        return np.concatenate([T.ravel(), (X.astype(np.float64) - c).ravel()])
    return float(np.linalg.norm(state(T, X) - state(T_to, X_to))
                 / np.linalg.norm(state(T_to, X_to)))


@pytest.mark.parametrize("case", ["mono", "stereo", "two_blocks"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_ba_matches_single_process_and_reference(n, case):
    cam, cfg, whole = _problem(case)
    ranks = dist_ba.bundle_adjust_local(n, cam, cfg,
                                        timeout_s=SPAWN_TIMEOUT_S,
                                        device="cpu", **whole)
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
    # and 1.2e-5 on the landmarks at most.
    well = case != "mono"
    if well:
        np.testing.assert_allclose(T, T_one, atol=1e-6)
        np.testing.assert_allclose(X, X_one, atol=3e-5)
    else:
        # Without disparities the window's scale is a free direction, held
        # only by the damping: the damped reduced system's weakest
        # eigenvalue is 4.3 (the scale about the pinned keyframe), the next
        # 142 and the largest 4.0e5. To first order, rounding the sums to
        # float32 (unit roundoff u = 2^-24 = 6.0e-8) moves the solution by
        # kappa * u of the state's size along each direction, kappa =
        # 4.0e5 / eigenvalue: 9.3e4 * u = 5.5e-3 along the scale and 2.8e3
        # * u = 1.7e-4 along every other direction. Which way the scale
        # moves depends on the order of the sums, so both bounds are two-
        # sided. The state here: keyframe poses and landmarks, positions
        # about the pinned keyframe (landmarks 2.0-6.6 m away), norm 25.9.
        # Measured against the same iterations in float64: scales of
        # 1 + 0.41e-3 (the JAX package) ... 1.56e-3 (4 shards), the rest
        # 0.4e-5 ... 7.3e-5 of the state's norm once the scale is taken
        # out. So sharded and single-process results differ by up to 1.1e-4
        # on the poses and 3.0e-3 on the landmarks (4 shards), almost all
        # of it a scale of 1 + 5.5e-4 (the rest 4.0e-5): two float32 sides
        # are held to twice each bound.
        u = np.finfo(np.float32).eps / 2
        scale_tol, rest_tol = 4.0e5 / 4.3 * u, 4.0e5 / 142 * u
        T64, X64 = _float64(cam, cfg, whole)
        for T_side, X_side in ((T, X), (T_one, X_one)):
            T_u, X_u, s64 = _unscaled(T_side, X_side, T64, X64)
            assert abs(s64 - 1.0) < scale_tol
            assert _relative_difference(T_u, X_u, T64, X64) < rest_tol
        T_u, X_u, s = _unscaled(T, X, T_one, X_one)
        assert abs(s - 1.0) < 2 * scale_tol
        assert _relative_difference(T_u, X_u, T_one, X_one) < 2 * rest_tol
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
                                timeout_s=SPAWN_TIMEOUT_S,
                                device="cpu") == [True, True]


def test_mesh_2d_groups():
    """(data, kf) = (2, 2) over 4 ranks: rank = data·2 + kf; the kf group
    joins a row, the data group a column; ``make(3)`` leaves rank 3 out."""
    got = mesh_mod.spawn_local(workers.mesh_2d_coordinates, 4, (2, 2),
                               timeout_s=SPAWN_TIMEOUT_S, device="cpu")
    for rank, (d, k, sums, outside) in enumerate(got):
        assert (d, k) == (rank // 2, rank % 2)
        assert sums["kf"] == {0: 11.0, 1: 1100.0}[d]
        assert sums["data"] == {0: 101.0, 1: 1010.0}[k]
        assert outside == (rank == 3)


def test_spawn_local_kills_hung_ranks_at_its_time_limit():
    with pytest.raises(TimeoutError, match="still running"):
        mesh_mod.spawn_local(workers.hang, 2, timeout_s=8.0, device="cpu")


def test_spawn_local_raises_a_rank_failure():
    with pytest.raises(Exception, match="rank 1 fails"):
        mesh_mod.spawn_local(workers.fail_on_rank_one, 2,
                             timeout_s=SPAWN_TIMEOUT_S, device="cpu")


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
    dist_ba.dryrun(n, timeout_s=SPAWN_TIMEOUT_S, device="cpu")


def test_dryrun_multichip_4(capsys):
    reports = entry.dryrun_multichip(4, timeout_s=SPAWN_TIMEOUT_S,
                                     device="cpu")
    assert "dryrun_multichip(4): OK" in capsys.readouterr().out
    # gloo CPU ranks run the kernels' plain versions: no launch is counted
    for rep in reports:
        assert (rep["backend"], rep["device"]) == ("gloo", "cpu")
        assert set(rep["launches"]) == {"halfsample", "gradients",
                                        "sample_patches", "gn_accumulate",
                                        "align_levels", "refine_pose",
                                        "klt_track"}
        assert not any(rep["launches"].values())


@pytest.fixture()
def no_process(monkeypatch):
    """``torch.multiprocessing.spawn`` made to fail the test: a call that
    must raise first starts no process."""
    import torch.multiprocessing as mp

    def spawn(*args, **kwargs):
        raise AssertionError("a rank process was started")
    monkeypatch.setattr(mp, "spawn", spawn)


def _multi_rank_call(name: str):
    """Each entry point that spawns ranks, called with 2 ranks on its
    default device."""
    cam, cfg, whole = _problem("mono")
    return {
        "spawn_local": lambda: mesh_mod.spawn_local(workers.fail_on_rank_one,
                                                    2),
        "dist_ba.dryrun": lambda: dist_ba.dryrun(2),
        "bundle_adjust_local": lambda: dist_ba.bundle_adjust_local(
            2, cam, cfg, **whole),
        "dryrun_multichip": lambda: entry.dryrun_multichip(2),
    }[name]


MULTI_RANK_CALLS = ("spawn_local", "dist_ba.dryrun", "bundle_adjust_local",
                    "dryrun_multichip")


@pytest.mark.parametrize("name", MULTI_RANK_CALLS)
def test_multi_rank_entry_points_raise_without_cuda(name, no_process,
                                                    monkeypatch):
    """The default device is the card: without CUDA each raises before a
    process starts, with no fallback to gloo CPU ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _multi_rank_call(name)()


@pytest.mark.parametrize("name", MULTI_RANK_CALLS)
def test_multi_rank_entry_points_need_a_card_a_rank(name, no_process,
                                                    monkeypatch):
    """2 ranks on a machine with 1 GPU: RuntimeError naming the card
    count before a process starts (NCCL puts no two ranks on one card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 GPUs.*this "
                                           "machine has 1"):
        _multi_rank_call(name)()


@pytest.mark.parametrize("device", ["cuda:1", "cpu:0"])
def test_spawn_local_refuses_a_device_index(device, no_process,
                                            monkeypatch):
    """Rank r always takes cuda:r, so an index in ``device`` would be
    ignored: it raises before a process starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="rank r always runs on cuda:r"):
        mesh_mod.spawn_local(workers.fail_on_rank_one, 1, device=device)


def test_rank_device_is_the_cpu_in_a_gloo_rank():
    assert mesh_mod.spawn_local(workers.backend_and_device, 2,
                                timeout_s=SPAWN_TIMEOUT_S, device="cpu") \
        == [("gloo", "cpu")] * 2


@pytest.mark.parametrize("argv, cards, want", [
    (["--device", "cpu"], 0, (8, "cpu")),      # the reference's 8 devices
    (["3", "--device", "cpu"], 0, (3, "cpu")),
    ([], 4, (4, "cuda")),                      # every card of the machine
    (["2"], 4, (2, "cuda")),
])
def test_entry_arguments(argv, cards, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert entry.parse_args(argv) == want


@pytest.fixture(scope="module")
def dryrun_calls():
    """chip_smoke phase 17 (a)'s record of the dry run's steps (rank 0 of
    one), here on the CPU, where each op runs its plain version."""
    import chip_smoke
    cfg = entry._tiny_cfg()
    outs, calls = chip_smoke.kernel_calls(lambda: entry._dryrun_steps(
        cfg, *entry._dryrun_frames(cfg, 1, 0, "cpu"), "cpu"))
    assert torch.isfinite(outs.T_wc).all()
    return calls


def test_phase17_dryrun_kernel_calls_at_their_shapes(dryrun_calls):
    """Every kernel's calls in the dry run are recorded at the tiny
    configuration's shapes (a 96×128 pyramid of 2 levels, N = 16, P = 4
    and 8, one problem) and pass the check against the plain versions."""
    import chip_smoke
    rows = chip_smoke.check_kernel_calls(dryrun_calls)
    # on the CPU the alignment is the chain of B3 and B4 calls, the KLT the
    # chain of B3 calls and the pose refinement its chain of ops (on the
    # card one align_levels, one klt_track and one refine_pose launch)
    assert set(rows) == set(kernels.KERNELS) - {"align_levels",
                                                "refine_pose", "klt_track"}
    assert rows["halfsample"]["shapes"] == [[[1, 96, 128], 2]]
    assert rows["gradients"]["shapes"] == [[[1, 96, 128], 2]]
    assert {tuple(s[0]) for s in rows["sample_patches"]["shapes"]} == {
        (1, 1, 96, 128), (1, 3, 96, 128), (1, 1, 48, 64), (1, 3, 48, 64)}
    assert {s[2] for s in rows["sample_patches"]["shapes"]} == {4, 8}
    assert {tuple(s[0]) for s in rows["gn_accumulate"]["shapes"]} == {
        (1, 96, 128), (1, 48, 64)}
    for name in ("sample_patches", "gn_accumulate"):   # N = 16 centres
        assert {tuple(s[1]) for s in rows[name]["shapes"]} == {(1, 16, 2)}
    for row in rows.values():
        assert row["max_abs_err"] == 0.0 and row["calls"] >= 1


@pytest.mark.parametrize("kernel", ["halfsample", "gradients",
                                    "sample_patches", "gn_accumulate"])
def test_phase17_dryrun_check_fails_a_wrong_kernel(dryrun_calls, kernel):
    """One recorded result of one kernel made wrong by 1e-3 of its largest
    entry: the check fails, naming that kernel."""
    import chip_smoke
    op = {"halfsample": "svo::pyramid", "gradients": "svo::pyramid",
          "sample_patches": "svo::sample_patches",
          "gn_accumulate": "svo::gn_accumulate"}[kernel]
    i = next(i for i, c in enumerate(dryrun_calls) if c[0] == op)
    name, args, out = dryrun_calls[i]
    wrong = out.clone()
    part = wrong                                # a view of what is checked
    if op == "svo::pyramid":                    # level 1: image, then gx
        img, levels = args
        part = pyramid_kernel.level_views(wrong, *img.shape[-2:], levels)[1][
            ..., 0 if kernel == "halfsample" else 1, :, :]
    elif op == "svo::gn_accumulate":
        part = wrong[..., :43]                  # H, g and cost
    part[(0,) * part.dim()] += 1e-3 * float(part.abs().max())
    calls = list(dryrun_calls)
    calls[i] = (name, args, wrong)
    with pytest.raises(chip_smoke.SmokeFailure, match=kernel):
        chip_smoke.check_kernel_calls(calls)


def test_entry_takes_one_step_on_the_cpu():
    """``entry(device="cpu")``: the flagship step at 752×480 on seeded
    noise frames bootstraps a keyframe; without a card the default
    raises."""
    fn, args = entry.entry(device="cpu")
    state, left, right = args
    assert left.shape == (480, 752) and not bool(state.kf_valid.any())
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        left.numpy(), rng.uniform(0, 255, (480, 752)).astype(np.float32))
    new_state, out = fn(*args)
    assert bool(out.kf_inserted) and bool(new_state.kf_valid.any())
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
