"""The fused pose refinement ``svo::refine_pose`` (``refine_pose_kernel``):
on the CPU the op is ``frontend/pose_refine.refine_plain``, problem by
problem; on the card (``cuda`` marker: skipped without one) the kernel
against that chain at the shipped shapes and with each optional term off,
its problem axis, its repeatability, and the graphed step that runs it.

The inputs are real: the arguments of the eager step's refinement call on
the third frame of an ``io/synthetic`` sequence (:func:`_problem`).
"""

import dataclasses

import pytest
import torch

from stereo_svo_tpu_torch.config import (CameraConfig, SvoConfig,
                                         kitti_config, stress_config)
from stereo_svo_tpu_torch.engine import graphed, runner
from stereo_svo_tpu_torch.engine import step as step_mod
from stereo_svo_tpu_torch.engine.state import init_state
from stereo_svo_tpu_torch.frontend import pose_refine
from stereo_svo_tpu_torch.geometry import se3
from stereo_svo_tpu_torch.io import synthetic
from stereo_svo_tpu_torch.ops.kernels import refine_kernel as rk

# the 376x240 test rig (chip_smoke.HARD_CAM / HARD_CFG)
RIG = SvoConfig(camera=CameraConfig(fx=240.0, fy=240.0, cx=188.0, cy=120.0,
                                    baseline=0.11, width=376, height=240),
                grid_rows=10, grid_cols=13, max_features=130, num_levels=3,
                align_levels=3, klt_levels=3, stereo_max_disp=64,
                kf_min_tracked=40, border_margin=10)
DT = 0.05
OPTIONAL = ("obs_sigma", "T_prior", "disp_obs", "disp_mask", "obs_sigma_d")


def _problem(cfg: SvoConfig, device, frames: int = 3, seed: int = 0):
    """(camera, configuration, arguments) of the eager step's refinement
    call on frame ``frames - 1``: T_cw, X_world, uv_obs, mask and the
    optional ones by name."""
    lefts, rights, _ = synthetic.make_sequence(cfg.camera, frames, dt=DT,
                                               seed=seed, device=device)
    step = step_mod.make_step(cfg)
    state = init_state(cfg, device)
    for t in range(frames - 1):
        state, _, _ = step(state, lefts[t], rights[t])
    calls = []
    original = pose_refine.refine

    def recorded(cam, cfg_, *args, **kwargs):
        calls.append((cam, cfg_, args, kwargs))
        return original(cam, cfg_, *args, **kwargs)

    pose_refine.refine = recorded
    try:
        step(state, lefts[-1], rights[-1])
    finally:
        pose_refine.refine = original
    cam, cfg_, args, kwargs = calls[0]
    return cam, cfg_, args, kwargs


def _replace(problem, cfg=None, args=None, **kwargs):
    """``problem`` with its configuration, positional arguments or named
    arguments replaced."""
    cam, cfg0, args0, kw0 = problem
    return (cam, cfg or cfg0, args if args is not None else args0,
            {**kw0, **kwargs})


def _op(problem):
    cam, cfg, args, kwargs = problem
    return rk.refine_pose(cam, cfg, *args, **kwargs)


def _plain(problem):
    cam, cfg, args, kwargs = problem
    return pose_refine.refine_plain(cam, cfg, *args, **kwargs)


def _equal(got, want):
    T, inl, st = got
    pT, pinl, pst = want
    assert torch.equal(T, pT)
    assert torch.equal(inl, pinl)
    assert torch.equal(st["refine_rms_px"], pst["refine_rms_px"])
    assert torch.equal(st["refine_inliers"], pst["refine_inliers"])
    assert st["refine_inliers"].dtype == torch.int32


def _perturbed(T, n):
    """n initial poses around T (problem 0 is T)."""
    g = torch.Generator().manual_seed(5)
    xi = 0.01 * torch.randn(n, 6, generator=g).to(T.device)
    xi[0] = 0.0
    return torch.stack([se3.compose(se3.exp(xi[b]), T) for b in range(n)])


# the variants every test runs: as the step calls it, and each optional
# term off (the kernel adapts to what it is given)
VARIANTS = {
    "step": {},
    "no_prior": {"T_prior": None},
    "no_disparity": {"disp_obs": None, "disp_mask": None},
    "no_sigmas": {"obs_sigma": None, "obs_sigma_d": None},
    "prior_sigma_0": {"cfg": {"refine_prior_t_sig": 0.0}},
    "stereo_weight_0": {"cfg": {"refine_stereo_weight": 0.0}},
}


def _variant(problem, name):
    kw = dict(VARIANTS[name])
    cfg = kw.pop("cfg", None)
    if cfg is not None:
        cfg = dataclasses.replace(problem[1], **cfg)
    return _replace(problem, cfg=cfg, **kw)


# ---- on the CPU -----------------------------------------------------------

@pytest.fixture(scope="module")
def rig_problem():
    return _problem(RIG, "cpu")


def test_the_step_calls_refine_with_every_term(rig_problem):
    _, cfg, args, kwargs = rig_problem
    assert all(kwargs[k] is not None for k in OPTIONAL)
    assert args[0].shape == (3, 4) and args[1].shape == (cfg.max_features, 3)
    assert int(args[3].sum()) > 20


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_refine_pose_on_cpu_is_the_plain_chain(rig_problem, variant):
    prob = _variant(rig_problem, variant)
    want = _plain(prob)
    _equal(_op(prob), want)
    # pose_refine.refine takes the chain on the CPU
    _equal(pose_refine.refine(prob[0], prob[1], *prob[2], **prob[3]), want)
    # and the refinement moved the pose
    assert not torch.equal(want[0], prob[2][0])


def test_refine_pose_vmap_is_each_problem_alone(rig_problem):
    cam, cfg, args, kwargs = rig_problem
    Ts = _perturbed(args[0], 3)
    batch = torch.func.vmap(
        lambda T: _op((cam, cfg, (T,) + args[1:], kwargs)))(Ts)
    assert batch[0].shape == (3, 3, 4)
    assert batch[1].shape == (3, cfg.max_features)
    assert batch[2]["refine_rms_px"].shape == (3,)
    assert batch[2]["refine_inliers"].shape == (3,)
    for b in range(3):
        one = _op((cam, cfg, (Ts[b],) + args[1:], kwargs))
        assert torch.equal(batch[0][b], one[0])
        assert torch.equal(batch[1][b], one[1])
        for key in one[2]:
            assert torch.equal(batch[2][key][b], one[2][key])


def test_refine_pose_vmap_batches_every_argument(rig_problem):
    """Every tensor argument batched (the batched step's case): problem b
    is its own call."""
    cam, cfg, args, kwargs = rig_problem
    B = 2
    Ts = _perturbed(args[0], B)
    stacked = [torch.stack([a] * B) for a in args[1:]]
    kw = {k: torch.stack([v] * B) for k, v in kwargs.items()}
    kw["obs_sigma"] = kw["obs_sigma"] * torch.tensor([1.0, 2.0])[:, None]
    batch = torch.func.vmap(
        lambda T, X, uv, m, kw: _op((cam, cfg, (T, X, uv, m), kw)))(
            Ts, *stacked, kw)
    for b in range(B):
        one = _op((cam, cfg, (Ts[b],) + tuple(s[b] for s in stacked),
                   {k: v[b] for k, v in kw.items()}))
        assert torch.equal(batch[0][b], one[0])
        assert torch.equal(batch[1][b], one[1])


def test_refine_pose_fake_shapes(rig_problem):
    """``register_fake``: (*B,13), (*B,) int32, (*B,N) bool for any
    leading problem dims."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cam, cfg, args, kwargs = rig_problem
    N = args[1].shape[0]
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        for lead in ((), (3,), (2, 4)):
            def ex(t):
                return None if t is None else mode.from_tensor(
                    t.expand(lead + t.shape))
            out, cnt, inl = rk.refine_pose_op(
                *(ex(a) for a in args), *(ex(kwargs[k]) for k in OPTIONAL),
                *rk._static(cam, cfg))
            assert out.shape == lead + (rk.REFINE_OUT,)
            assert out.dtype == torch.float32
            assert cnt.shape == lead and cnt.dtype == torch.int32
            assert inl.shape == lead + (N,) and inl.dtype == torch.bool


def test_static_arguments_are_the_schedule():
    chunks_inner = rk._static(RIG.camera, SvoConfig())[2]
    assert chunks_inner == [3, 2]      # 10 iterations in 3 refreshes
    cfg = dataclasses.replace(SvoConfig(), refine_max_iters=2,
                              refine_irls_chunks=3)
    assert rk._static(RIG.camera, cfg)[2] == [2, 0]
    cam, back = rk._configs(*rk._static(RIG.camera, SvoConfig()))
    assert (back.refine_irls_chunks, back.refine_max_iters) == (3, 9)
    assert cam.fx == RIG.camera.fx and cam.baseline == RIG.camera.baseline


def test_refine_pose_all_masked_keeps_the_pose_on_cpu(rig_problem):
    cam, cfg, args, kwargs = rig_problem
    masked = (args[0], args[1], args[2], torch.zeros_like(args[3]))
    prob = (cam, cfg, masked, {**kwargs, "T_prior": None})
    T, inl, st = _op(prob)
    assert torch.allclose(T, args[0], atol=1e-6)
    assert not bool(inl.any()) and int(st["refine_inliers"]) == 0
    assert float(st["refine_rms_px"]) == 0.0
    _equal((T, inl, st), _plain(prob))


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: refine_pose_kernel has no CPU mode")
    return torch.device("cuda")


SHAPES = {"euroc": SvoConfig(), "kitti": kitti_config(),
          "stress": stress_config()}
# The kernel against the chain of ops on the card. Both are float32 with
# the same operations; only the order of the sums over features differs
# (and the chain's FMAs, cuBLAS's and inv_ex's rounding). That moves H and
# g by ~1e-7 relative, the pose by ~1e-7: held within 1e-5 (rad, m). The
# inlier mask and count: equal but for features whose error lies within
# 1e-3 px of the threshold (none at these shapes). The RMS error, a mean of
# squared errors at the refined pose, within 1e-4 relative or 1e-5 px,
# whichever is larger: a pose gap under 1e-5 moves a 0.02-px error of a
# few features by ~5e-6 px (six features on an H100: 4.8e-6 px, 2.7e-4
# relative).
POSE_TOL = 1e-5
RMS_TOL = 1e-4
RMS_TOL_PX = 1e-5


def _pose_gap(A, B):
    rot, trans = se3.distance(A, B)
    return float(rot.max()), float(trans.max())


def _close(got, want, prob):
    T, inl, st = got
    pT, pinl, pst = want
    rot, trans = _pose_gap(T, pT)
    assert rot <= POSE_TOL and trans <= POSE_TOL, (rot, trans)
    diff = inl != pinl
    if bool(diff.any()):
        # only features at the threshold may turn over
        cam, cfg, args, kwargs = prob
        x_c = se3.transform(pT, args[1])
        uv = torch.stack([cam.fx * x_c[:, 0] / x_c[:, 2] + cam.cx,
                          cam.fy * x_c[:, 1] / x_c[:, 2] + cam.cy], -1)
        err = (uv - args[2]).norm(dim=-1)
        sig = kwargs.get("obs_sigma")
        thr = cfg.refine_outlier_px * (sig if sig is not None else 1.0)
        assert float((err - thr)[diff].abs().max()) < 1e-3
    assert abs(int(st["refine_inliers"]) - int(pst["refine_inliers"])) \
        == int(diff.sum())
    rms, prms = float(st["refine_rms_px"]), float(pst["refine_rms_px"])
    assert abs(rms - prms) <= max(RMS_TOL * prms, RMS_TOL_PX), (rms, prms)


@pytest.fixture(scope="module")
def card_problems():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: refine_pose_kernel has no CPU mode")
    return {k: _problem(cfg, torch.device("cuda"))
            for k, cfg in SHAPES.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_refine_pose_matches_the_chain(card_problems, shape):
    prob = card_problems[shape]
    before = rk.LAUNCHES["refine_pose"]
    got = _op(prob)
    assert rk.LAUNCHES["refine_pose"] == before + 1
    _close(got, _plain(prob), prob)
    assert int(got[2]["refine_inliers"]) >= 10
    # pose_refine.refine launches the kernel on the card
    again = pose_refine.refine(prob[0], prob[1], *prob[2], **prob[3])
    _equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "step"])
def test_cuda_refine_pose_with_a_term_off(card_problems, variant):
    prob = _variant(card_problems["euroc"], variant)
    _close(_op(prob), _plain(prob), prob)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["euroc", "kitti"])
def test_cuda_refine_pose_whitened_by_depth(cuda_device, shape):
    cfg = dataclasses.replace(SHAPES[shape], refine_whiten_depth=True)
    prob = _problem(cfg, cuda_device)
    # the whitening reaches the refiner through its sigmas
    assert not torch.equal(prob[3]["obs_sigma"], prob[3]["obs_sigma_d"])
    _close(_op(prob), _plain(prob), prob)


@pytest.mark.cuda
def test_cuda_refine_pose_batch_of_8_is_each_launch(card_problems):
    cam, cfg, args, kwargs = card_problems["euroc"]
    Ts = _perturbed(args[0], 8)
    before = rk.LAUNCHES["refine_pose"]
    batch = torch.func.vmap(
        lambda T: _op((cam, cfg, (T,) + args[1:], kwargs)))(Ts)
    assert rk.LAUNCHES["refine_pose"] == before + 1
    for b in range(8):
        one = _op((cam, cfg, (Ts[b],) + args[1:], kwargs))
        assert torch.equal(batch[0][b], one[0]), b
        assert torch.equal(batch[1][b], one[1]), b
        for key in one[2]:
            assert torch.equal(batch[2][key][b], one[2][key]), b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_refine_pose_repeats(card_problems, shape):
    prob = card_problems[shape]
    _equal(_op(prob), _op(prob))


@pytest.mark.cuda
def test_cuda_refine_pose_all_masked(card_problems):
    cam, cfg, args, kwargs = card_problems["euroc"]
    prob = (cam, cfg, args[:3] + (torch.zeros_like(args[3]),), kwargs)
    T, inl, st = _op(prob)
    pT, pinl, pst = _plain(prob)
    # only the motion prior and the regulariser act: the same step
    rot, trans = _pose_gap(T, pT)
    assert rot <= POSE_TOL and trans <= POSE_TOL, (rot, trans)
    assert not bool(inl.any()) and int(st["refine_inliers"]) == 0
    assert torch.equal(st["refine_rms_px"], pst["refine_rms_px"])


@pytest.mark.cuda
def test_cuda_refine_pose_fewer_than_10_inliers(card_problems):
    cam, cfg, args, kwargs = card_problems["euroc"]
    keep = torch.zeros_like(args[3])
    keep[torch.nonzero(args[3])[:6, 0]] = True
    prob = (cam, cfg, args[:3] + (keep,), kwargs)
    got = _op(prob)
    _close(got, _plain(prob), prob)
    assert int(got[2]["refine_inliers"]) < 10


@pytest.mark.cuda
def test_cuda_refine_pose_non_finite_pose(card_problems):
    cam, cfg, args, kwargs = card_problems["euroc"]
    T_bad = args[0].clone()
    T_bad[0, 3] = float("nan")
    prob = (cam, cfg, (T_bad,) + args[1:], kwargs)
    T, inl, st = _op(prob)
    pT, pinl, pst = _plain(prob)
    assert not bool(torch.isfinite(T).all())
    assert torch.equal(torch.isfinite(T), torch.isfinite(pT))
    assert torch.equal(inl, pinl) and not bool(inl.any())
    assert int(st["refine_inliers"]) == int(pst["refine_inliers"]) == 0


@pytest.mark.cuda
def test_cuda_graphed_step_launches_one_refine_a_tracked_frame(cuda_device):
    cfg = SvoConfig()
    lefts, rights, _ = synthetic.make_sequence(cfg.camera, 12, dt=DT,
                                               device=cuda_device)
    step = graphed.make_graphed_step(cfg, cuda_device)
    for body in ("A_ok", "A_fail"):
        assert step.kernel_nodes[body]["refine_pose"] == 1
    graphed.settle()
    before = rk.LAUNCHES["refine_pose"]
    r0 = step.replays
    runner.run_frames(step, lefts, rights)
    graphed.settle()
    r1 = step.replays
    tracked = sum(r1[g] - r0[g] for g in ("A_ok", "A_fail"))
    assert tracked == len(lefts) - 1        # frame 0 bootstraps
    assert rk.LAUNCHES["refine_pose"] - before == tracked


@pytest.mark.cuda
def test_cuda_300_frames_keep_the_chain_decisions(cuda_device, monkeypatch):
    """300 graphed frames with the kernel keep the tracking and keyframe
    decisions of the same step with the chain, on every frame (the
    benchmark's planes scene on the loop trajectory at 20 Hz)."""
    cfg = SvoConfig()
    lefts, rights, _ = synthetic.make_sequence(cfg.camera, 300, dt=DT,
                                               kind="loop",
                                               device=cuda_device)
    _, fused = runner.run_sequence_scan(cfg, lefts, rights, cuda_device)
    with monkeypatch.context() as m:
        m.setattr(pose_refine, "refine", pose_refine.refine_plain)
        _, chain = runner.run_sequence_scan(cfg, lefts, rights, cuda_device)
    assert torch.equal(fused.tracking_ok, chain.tracking_ok)
    assert torch.equal(fused.kf_inserted, chain.kf_inserted)
    assert bool(fused.tracking_ok[1:].all())
    gap = (se3.translation(fused.T_wc) - se3.translation(chain.T_wc)).norm(
        dim=-1)
    assert float(gap.max()) < 2e-3
