"""The fused alignment ``svo::align_levels`` (``align_levels_kernel``): on
the CPU the op is ``ops/align``'s chain, problem by problem; on the card
(``cuda`` marker: skipped without one) the kernel against that chain at
the shipped shapes, its problem axis, its repeatability, and the graphed
step that runs it.

The inputs are real: the eager step's template after two frames of an
``io/synthetic`` sequence and the pyramid of the third frame, from the
constant-velocity prior (:func:`_problem`).
"""

import dataclasses

import pytest
import torch

from stereo_svo_tpu_torch.backend import loop_closure
from stereo_svo_tpu_torch.config import (CameraConfig, SvoConfig,
                                         kitti_config, stress_config)
from stereo_svo_tpu_torch.engine import graphed, runner
from stereo_svo_tpu_torch.engine import step as step_mod
from stereo_svo_tpu_torch.engine.state import init_state
from stereo_svo_tpu_torch.geometry import se3
from stereo_svo_tpu_torch.io import synthetic
from stereo_svo_tpu_torch.ops import align, pyramid
from stereo_svo_tpu_torch.ops.kernels import align_kernel as ak

# the 376x240 test rig (chip_smoke.HARD_CAM / HARD_CFG)
RIG = SvoConfig(camera=CameraConfig(fx=240.0, fy=240.0, cx=188.0, cy=120.0,
                                    baseline=0.11, width=376, height=240),
                grid_rows=10, grid_cols=13, max_features=130, num_levels=3,
                align_levels=3, klt_levels=3, stereo_max_disp=64,
                kf_min_tracked=40, border_margin=10)
DT = 0.05


def _problem(cfg: SvoConfig, device, thumb: bool = False, seed: int = 0):
    """(levels of frame 2, the template of frame 1, T_init, camera,
    configuration) of one alignment; ``thumb``: the loop closure's
    one-level alignment at the keyframe thumbnail instead (frame 1's
    features at thumbnail scale against frame 2's thumbnail)."""
    lefts, rights, _ = synthetic.make_sequence(cfg.camera, 3, dt=DT,
                                               seed=seed, device=device)
    step = step_mod.make_step(cfg)
    state = init_state(cfg, device)
    for t in range(2):
        state, _, _ = step(state, lefts[t], rights[t])
    T_init = se3.exp(state.vel)
    if not thumb:
        levels = pyramid.build_with_gradients(lefts[2], cfg.num_levels)[0]
        return levels, state.tmpl, T_init, cfg.camera, cfg
    cam_t, cfg_t = loop_closure._thumb_cfg(cfg)
    lv = cfg.thumb_level
    im, gx, gy = (x[lv] for x in pyramid.build_with_gradients(
        lefts[1], cfg.num_levels))
    ok = (state.status > 0) & (state.mu > 1e-3)
    z = torch.where(ok, 1.0 / torch.clamp(state.mu, min=1e-3),
                    torch.ones_like(state.mu))
    tmpl = align.make_template((im,), (gx,), (gy,), cam_t, cfg_t,
                               state.feat_uv * (1.0 / 2 ** lv), z, ok)
    target = pyramid.build_with_gradients(lefts[2], cfg.num_levels)[0][lv]
    return (target,), tmpl, T_init, cam_t, cfg_t


def _op(levels, tmpl, T_init, cam, cfg, **fields):
    """(T, cost, inlier share) of ``align_kernel.align_levels`` on
    ``ops/align.spec(cam, cfg)``'s levels, template fields replaced by
    ``fields``."""
    s = align.spec(cam, cfg)
    t = tmpl._replace(**fields)
    return ak.align_levels([levels[lv] for lv in s.levels], t.p_ref,
                           t.patches, t.jac, t.mask, T_init, s)


def _plain(levels, tmpl, T_init, cam, cfg):
    T, stats = align.align_plain(levels, tmpl, cam, cfg, T_init)
    return T, stats["align_cost"], stats["align_inlier_frac"]


def _perturbed(T_init, n):
    """n initial poses around T_init (problem 0 is T_init)."""
    g = torch.Generator().manual_seed(5)
    xi = 0.01 * torch.randn(n, 6, generator=g).to(T_init.device)
    xi[0] = 0.0
    return torch.stack([se3.compose(se3.exp(xi[b]), T_init)
                        for b in range(n)])


# ---- on the CPU -----------------------------------------------------------

@pytest.fixture(scope="module")
def rig_problem():
    return _problem(RIG, "cpu")


@pytest.mark.parametrize("illum_affine", [True, False])
def test_align_levels_on_cpu_is_the_plain_chain(rig_problem, illum_affine):
    levels, tmpl, T_init, cam, cfg = rig_problem
    cfg = dataclasses.replace(cfg, illum_affine=illum_affine)
    got = _op(levels, tmpl, T_init, cam, cfg)
    want = _plain(levels, tmpl, T_init, cam, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # align.align takes the chain on the CPU
    T, stats = align.align(levels, tmpl, cam, cfg, T_init)
    assert torch.equal(T, want[0])
    assert torch.equal(stats["align_cost"], want[1])
    # and the alignment moved the pose
    assert not torch.equal(T, T_init)


def test_align_levels_vmap_is_each_problem_alone(rig_problem):
    levels, tmpl, T_init, cam, cfg = rig_problem
    Ts = _perturbed(T_init, 3)
    batch = torch.func.vmap(
        lambda T: _op(levels, tmpl, T, cam, cfg))(Ts)
    for b in range(3):
        one = _op(levels, tmpl, Ts[b], cam, cfg)
        for x, y in zip(batch, one):
            assert torch.equal(x[b], y)


def test_align_levels_fake_shapes(rig_problem):
    """``register_fake``: (*B, 14) for any leading problem dims."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    levels, tmpl, T_init, cam, cfg = rig_problem
    s = align.spec(cam, cfg)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        for lead in ((), (3,), (2, 4)):
            def ex(t):
                return mode.from_tensor(t.expand(lead + t.shape))
            out = ak.align_levels_op(
                [ex(levels[lv]) for lv in s.levels], ex(tmpl.p_ref),
                ex(tmpl.patches), ex(tmpl.jac), ex(tmpl.mask), ex(T_init),
                [x for i in s.intrinsics for x in i],
                [x for b in s.bounds for x in b],
                [x for sc in s.schedule for x in sc], s.patch, s.huber_k,
                s.illum_affine)
            assert out.shape == lead + (ak.ALIGN_OUT,)
            assert out.dtype == torch.float32


def test_align_levels_all_masked_keeps_the_pose_on_cpu(rig_problem):
    levels, tmpl, T_init, cam, cfg = rig_problem
    mask = torch.zeros_like(tmpl.mask)
    T, cost, frac = _op(levels, tmpl, T_init, cam, cfg, mask=mask)
    assert torch.equal(T, T_init)
    assert float(cost) == 0.0 and float(frac) == 0.0


def test_spec_is_the_configuration_schedule():
    s = align.spec(RIG.camera, SvoConfig())
    assert s.levels == (3, 2, 1, 0)
    # (2, 3, 4, 8): 7 refresh passes, 8 inner passes
    assert s.schedule == ((1, 1), (1, 2), (2, 1), (3, 1))
    assert sum(c * (1 + i) for c, i in s.schedule) == 15
    assert s.bounds[0] == (376 // 8 - 2.0, 240 // 8 - 2.0)
    cam_t, cfg_t = loop_closure._thumb_cfg(SvoConfig())
    # loop_align_iters 20 on one level: 3 refresh passes, 5 inner each
    assert align.spec(cam_t, cfg_t).schedule == ((3, 5),)


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: align_levels_kernel has no CPU "
                    "mode")
    return torch.device("cuda")


SHAPES = {"euroc": (SvoConfig(), False), "kitti": (kitti_config(), False),
          "stress": (stress_config(), False), "thumb": (SvoConfig(), True)}


def _pose_gap(A, B):
    rot, trans = se3.distance(A, B)
    return float(rot.max()), float(trans.max())


def _rel(a, b):
    return float(((a - b).abs() / b.abs().clamp(min=1e-12)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_align_levels_matches_the_chain(cuda_device, shape):
    """The kernel against the chain of ops, B3 and B4 on the card: pose
    within 1e-5 (rad, m), inlier share within 1e-5 relative; the cost,
    a mean of squared residuals at the converged pose, within 1e-4
    relative (the poses' float32 gap alone moves it by 1e-5 to 3.2e-5)."""
    cfg, thumb = SHAPES[shape]
    prob = _problem(cfg, cuda_device, thumb=thumb)
    before = ak.LAUNCHES["align_levels"]
    T, cost, frac = _op(*prob)
    assert ak.LAUNCHES["align_levels"] == before + 1
    pT, pcost, pfrac = _plain(*prob)
    rot, trans = _pose_gap(T, pT)
    assert rot <= 1e-5 and trans <= 1e-5, (rot, trans)
    assert _rel(cost, pcost) <= 1e-4, _rel(cost, pcost)
    assert _rel(frac, pfrac) <= 1e-5, _rel(frac, pfrac)
    assert float(frac) > 0.5 and not torch.equal(T, prob[2])
    # align.align launches the kernel on the card
    T2, _ = align.align(prob[0], prob[1], prob[3], prob[4], prob[2])
    assert torch.equal(T2, T)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["euroc", "thumb"])
def test_cuda_align_levels_batch_of_8_is_each_launch(cuda_device, shape):
    cfg, thumb = SHAPES[shape]
    levels, tmpl, T_init, cam, cfg = _problem(cfg, cuda_device, thumb=thumb)
    Ts = _perturbed(T_init, 8)
    before = ak.LAUNCHES["align_levels"]
    batch = torch.func.vmap(lambda T: _op(levels, tmpl, T, cam, cfg))(Ts)
    assert ak.LAUNCHES["align_levels"] == before + 1
    for b in range(8):
        one = _op(levels, tmpl, Ts[b], cam, cfg)
        for x, y in zip(batch, one):
            assert torch.equal(x[b], y), b


@pytest.mark.cuda
def test_cuda_align_levels_repeats(cuda_device):
    prob = _problem(SvoConfig(), cuda_device)
    first, again = _op(*prob), _op(*prob)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_align_levels_all_masked(cuda_device):
    levels, tmpl, T_init, cam, cfg = _problem(SvoConfig(), cuda_device)
    masked = tmpl._replace(mask=torch.zeros_like(tmpl.mask))
    T, cost, frac = _op(levels, masked, T_init, cam, cfg)
    assert torch.equal(T, T_init)
    _, pcost, pfrac = _plain(levels, masked, T_init, cam, cfg)
    assert torch.equal(cost, pcost) and torch.equal(frac, pfrac)


@pytest.mark.cuda
def test_cuda_graphed_step_launches_one_align_a_tracked_frame(cuda_device):
    cfg = SvoConfig()
    lefts, rights, _ = synthetic.make_sequence(cfg.camera, 12, dt=DT,
                                               device=cuda_device)
    step = graphed.make_graphed_step(cfg, cuda_device)
    for body in ("A_ok", "A_fail"):
        assert step.kernel_nodes[body]["align_levels"] == 1
        assert step.kernel_nodes[body]["gn_accumulate"] == 0
    graphed.settle()
    before = ak.LAUNCHES["align_levels"]
    r0 = step.replays
    runner.run_frames(step, lefts, rights)
    graphed.settle()
    r1 = step.replays
    tracked = sum(r1[g] - r0[g] for g in ("A_ok", "A_fail"))
    assert tracked == len(lefts) - 1        # frame 0 bootstraps
    assert ak.LAUNCHES["align_levels"] - before == tracked


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
        m.setattr(align, "align", align.align_plain)
        _, chain = runner.run_sequence_scan(cfg, lefts, rights, cuda_device)
    assert torch.equal(fused.tracking_ok, chain.tracking_ok)
    assert torch.equal(fused.kf_inserted, chain.kf_inserted)
    assert bool(fused.tracking_ok[1:].all())
    gap = (se3.translation(fused.T_wc) - se3.translation(chain.T_wc)).norm(
        dim=-1)
    assert float(gap.max()) < 2e-3
