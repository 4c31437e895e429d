"""The fused KLT ``svo::klt_track`` (``klt_track_kernel``): on the CPU the op
is ``ops/klt.track_plain``, problem by problem; on the card (``cuda``
marker: skipped without one) the kernel against that chain at the shipped
shapes, with each optional term off, at the border, masked and not finite,
its problem axis, its repeatability, its early exit, and the graphed step
that runs it.

The inputs are real: the arguments of the eager step's KLT call on the
third frame of an ``io/synthetic`` sequence (:func:`_problem`).
"""

import dataclasses

import pytest
import torch

from stereo_svo_tpu_torch.config import (CameraConfig, SvoConfig,
                                         kitti_config, stress_config)
from stereo_svo_tpu_torch.engine import graphed, runner
from stereo_svo_tpu_torch.engine import step as step_mod
from stereo_svo_tpu_torch.engine.state import init_state
from stereo_svo_tpu_torch.io import synthetic
from stereo_svo_tpu_torch.ops import klt
from stereo_svo_tpu_torch.ops.kernels import klt_kernel as kk

# the 376x240 test rig (chip_smoke.HARD_CAM / HARD_CFG)
RIG = SvoConfig(camera=CameraConfig(fx=240.0, fy=240.0, cx=188.0, cy=120.0,
                                    baseline=0.11, width=376, height=240),
                grid_rows=10, grid_cols=13, max_features=130, num_levels=3,
                align_levels=3, klt_levels=3, stereo_max_disp=64,
                kf_min_tracked=40, border_margin=10)
DT = 0.05


class Problem:
    """One KLT call: the tracked levels (level 0 first), the template, the
    configuration, the initial positions and the optional arguments."""

    def __init__(self, levels, tmpl, cfg, uv_init, edge_dir=None,
                 is_edgelet=None, A_inv=None):
        self.levels, self.tmpl, self.cfg = list(levels), tmpl, cfg
        self.uv_init = uv_init
        self.kw = dict(edge_dir=edge_dir, is_edgelet=is_edgelet, A_inv=A_inv)

    def replace(self, cfg=None, tmpl=None, uv_init=None, **kw):
        return Problem(self.levels, tmpl if tmpl is not None else self.tmpl,
                       cfg or self.cfg,
                       uv_init if uv_init is not None else self.uv_init,
                       **{**self.kw, **kw})

    def op(self):
        return kk.klt_track(self.levels, self.tmpl, self.cfg, self.uv_init,
                            **self.kw)

    def plain(self):
        return klt.track_plain(self.levels, self.tmpl, self.cfg,
                               self.uv_init, **self.kw)

    def track(self):
        return klt.track(self.levels, self.tmpl, self.cfg, self.uv_init,
                         **self.kw)


def _problem(cfg: SvoConfig, device, frames: int = 3, seed: int = 0
             ) -> Problem:
    """The eager step's KLT call on frame ``frames - 1`` of a synthetic
    sequence."""
    lefts, rights, _ = synthetic.make_sequence(cfg.camera, frames, dt=DT,
                                               seed=seed, device=device)
    step = step_mod.make_step(cfg)
    state = init_state(cfg, device)
    for t in range(frames - 1):
        state, _, _ = step(state, lefts[t], rights[t])
    calls = []
    original = klt.track

    def recorded(levels, tmpl, cfg_, uv_init, **kwargs):
        calls.append(Problem(levels[:cfg_.klt_levels], tmpl, cfg_, uv_init,
                             **kwargs))
        return original(levels, tmpl, cfg_, uv_init, **kwargs)

    klt.track = recorded
    try:
        step(state, lefts[-1], rights[-1])
    finally:
        klt.track = original
    return calls[0]


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w) or torch.equal(g.isnan(), w.isnan()) and \
            torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    assert got[1].dtype == torch.bool and got[3].dtype == torch.int32


def _with_border(prob: Problem) -> Problem:
    """Features at the border: some out of ``in_b`` at the coarse levels
    only (u = 2P + 1), some at the last pixel, some outside the image."""
    uv = prob.uv_init.clone()
    W = prob.cfg.camera.width
    P = prob.cfg.klt_patch
    uv[0::6, 0] = 2.0 * P + 1.0
    uv[1::6, 0] = W - 1.0
    uv[2::6, 1] = -3.0
    uv[3::6, 0] = P + 0.25
    return prob.replace(uv_init=uv)


def _non_finite(prob: Problem) -> Problem:
    uv = prob.uv_init.clone()
    uv[0::9] = float("nan")
    uv[1::9, 1] = float("inf")
    return prob.replace(uv_init=uv)


def _edgelets(prob: Problem) -> Problem:
    """Every third feature an edgelet, along a unit direction of its own
    (the synthetic scenes' first frames have none)."""
    is_edgelet = torch.zeros_like(prob.tmpl.mask)
    is_edgelet[0::3] = True
    ang = torch.arange(is_edgelet.shape[0], dtype=torch.float32).to(
        is_edgelet.device) * 0.7
    edge_dir = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    return prob.replace(edge_dir=edge_dir, is_edgelet=is_edgelet)


def _masked(prob: Problem) -> Problem:
    return prob.replace(tmpl=prob.tmpl._replace(
        mask=torch.zeros_like(prob.tmpl.mask)))


# the variants every test runs: as the step calls it, and each optional
# term off (the kernel adapts to what it is given)
VARIANTS = {
    "step": lambda p: p,
    "no_illum": lambda p: p.replace(
        cfg=dataclasses.replace(p.cfg, illum_affine=False)),
    "no_edgelets": lambda p: p.replace(edge_dir=None, is_edgelet=None),
    "edgelets": _edgelets,
    "edgelets_without_dir": lambda p: _edgelets(p).replace(edge_dir=None),
    "border": _with_border,
    "non_finite": _non_finite,
    "all_masked": _masked,
}


def _affine(prob: Problem) -> Problem:
    """A ``klt_affine_warp`` problem with some features outside
    ``big_ok`` at every level."""
    big_ok = prob.tmpl.big_ok.clone()
    big_ok[:, 0::7] = False
    return prob.replace(tmpl=prob.tmpl._replace(big_ok=big_ok))


# ---- on the CPU -----------------------------------------------------------

@pytest.fixture(scope="module")
def rig_problem():
    return _problem(RIG, "cpu")


@pytest.fixture(scope="module")
def rig_affine_problem():
    return _affine(_problem(dataclasses.replace(RIG, klt_affine_warp=True),
                            "cpu"))


def test_the_step_calls_track_with_its_terms(rig_problem, rig_affine_problem):
    p = rig_problem
    assert p.kw["edge_dir"] is not None and p.kw["A_inv"] is None
    assert p.kw["is_edgelet"] is not None
    assert len(p.levels) == RIG.klt_levels
    assert int(p.tmpl.mask.sum()) > 20 and p.tmpl.big.shape[-1] == 1
    a = rig_affine_problem
    assert a.kw["A_inv"] is not None
    assert a.tmpl.big.shape[-1] == (2 * RIG.klt_patch) ** 2


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_klt_track_on_cpu_is_the_plain_chain(rig_problem, variant):
    prob = VARIANTS[variant](rig_problem)
    want = prob.plain()
    _equal(prob.op(), want)
    # klt.track takes the chain on the CPU
    _equal(prob.track(), want)
    if variant == "all_masked":
        assert not bool(want[1].any()) and not bool(want[2].any())
        assert torch.equal(want[0], prob.uv_init)
    elif variant != "non_finite":
        assert int(want[1].sum()) > 10


def test_klt_track_on_cpu_affine_warp(rig_affine_problem):
    prob = rig_affine_problem
    want = prob.plain()
    _equal(prob.op(), want)
    assert 0 < int(want[3]) < len(prob.levels) * int(prob.tmpl.mask.sum())


def test_klt_track_vmap_is_each_problem_alone(rig_problem):
    p = rig_problem
    uvs = torch.stack([p.uv_init + d for d in (0.0, 0.7, -1.3)])
    batch = torch.func.vmap(
        lambda uv: p.replace(uv_init=uv).op())(uvs)
    N = p.uv_init.shape[0]
    assert [tuple(x.shape) for x in batch] == [(3, N, 2), (3, N), (3, N),
                                               (3,)]
    for b in range(3):
        _equal([x[b] for x in batch], p.replace(uv_init=uvs[b]).op())


def test_klt_track_vmap_batches_every_argument(rig_affine_problem):
    """Every tensor argument batched (the batched step's case), the levels
    and the warp included: problem b is its own call."""
    p = rig_affine_problem
    B = 2
    levels = [torch.stack([x, x * 1.1]) for x in p.levels]
    tmpl = type(p.tmpl)(*(torch.stack([t, t]) for t in p.tmpl))
    uvs = torch.stack([p.uv_init, p.uv_init + 0.5])
    kw = {k: torch.stack([v, v]) for k, v in p.kw.items()}

    def one(levels, tmpl, uv, kw):
        return kk.klt_track(levels, tmpl, p.cfg, uv, **kw)

    batch = torch.func.vmap(one)(levels, tmpl, uvs, kw)
    for b in range(B):
        want = kk.klt_track([x[b] for x in levels],
                            type(tmpl)(*(t[b] for t in tmpl)), p.cfg, uvs[b],
                            **{k: v[b] for k, v in kw.items()})
        _equal([x[b] for x in batch], want)


def test_klt_track_fake_shapes(rig_affine_problem):
    """``register_fake``: (*B,N,2), (*B,N) bool, (*B,N), (*B,) int32 for
    any leading problem dims."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    p = rig_affine_problem
    N = p.uv_init.shape[0]
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        for lead in ((), (3,), (2, 4)):
            def ex(t):
                return None if t is None else mode.from_tensor(
                    t.expand(lead + t.shape))
            uv, ok, res, nw = kk.klt_track_op(
                [ex(x) for x in p.levels], *(ex(t) for t in p.tmpl),
                ex(p.uv_init), *(ex(p.kw[k]) for k in (
                    "edge_dir", "is_edgelet", "A_inv")), p.cfg.klt_patch,
                p.cfg.klt_max_iters, p.cfg.klt_conv_eps, p.cfg.illum_affine)
            assert uv.shape == lead + (N, 2) and uv.dtype == torch.float32
            assert ok.shape == lead + (N,) and ok.dtype == torch.bool
            assert res.shape == lead + (N,) and res.dtype == torch.float32
            assert nw.shape == lead and nw.dtype == torch.int32


def _track_leaving_early(prob: Problem):
    """The kernel's control flow over ``track_plain``'s arithmetic: at each
    level a feature stays in the level's loop only while it is active, and
    once it leaves (out of bounds or converged) it is never tested again.
    Each iteration is ``track_plain`` for one iteration at the level, on
    level coordinates (a power-of-two scale: the same rounding) and with the
    features still in the loop as its mask."""
    cfg, tmpl = prob.cfg, prob.tmpl
    P = cfg.klt_patch
    one_step = dataclasses.replace(cfg, klt_levels=1, klt_max_iters=1)
    uv = prob.uv_init
    left = 0   # (feature, level) pairs that left the level's loop
    res = torch.zeros(uv.shape[0])
    converged = torch.zeros(uv.shape[0], dtype=torch.bool)
    for lv in range(cfg.klt_levels - 1, -1, -1):
        img = prob.levels[lv]
        H, W = img.shape
        scale = 1.0 / (2 ** lv)
        in_loop = tmpl.mask.clone()
        converged = torch.zeros_like(converged)
        for _ in range(cfg.klt_max_iters):
            us, vs = uv[:, 0] * scale, uv[:, 1] * scale
            in_loop = in_loop & (us > P) & (us < W - P) & (vs > P) & (
                vs < H - P)
            level = klt.KltTemplate(*(x[lv:lv + 1] for x in (
                tmpl.patches, tmpl.jac, tmpl.hinv)), in_loop,
                tmpl.big[lv:lv + 1], tmpl.big_ok[lv:lv + 1])
            uv_l, conv, r, _ = klt.track_plain(
                [img], level, one_step, uv * scale,
                edge_dir=prob.kw["edge_dir"],
                is_edgelet=prob.kw["is_edgelet"])
            uv = torch.where(in_loop[:, None], uv_l * (2 ** lv), uv)
            res = torch.where(in_loop, r, res)
            converged = converged | (in_loop & conv)
            in_loop = in_loop & ~conv
        left += int((tmpl.mask & ~in_loop).sum())
    moved2 = torch.sum((uv - prob.uv_init) ** 2, -1)
    ok = tmpl.mask & converged & (moved2 < (4.0 * P) ** 2)
    return uv, ok, res, left


@pytest.mark.parametrize("variant", ["step", "border", "edgelets",
                                     "no_illum"])
def test_leaving_a_level_early_changes_nothing(rig_problem, variant):
    """The kernel's early exit, on the CPU: a feature inactive at a level
    stays inactive there (its uv no longer moves), so a run that leaves
    each level at a feature's first inactive iteration gives the chain's
    outputs, which run every iteration of every level, bit for bit."""
    prob = VARIANTS[variant](rig_problem)
    uv, ok, res, _ = prob.plain()
    e_uv, e_ok, e_res, left = _track_leaving_early(prob)
    assert left > 0
    assert torch.equal(uv, e_uv)
    assert torch.equal(ok, e_ok)
    assert torch.equal(res, e_res)


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: klt_track_kernel has no CPU mode")
    return torch.device("cuda")


SHAPES = {"euroc": SvoConfig(), "kitti": kitti_config(),
          "stress": stress_config(),
          "affine": SvoConfig(klt_affine_warp=True)}
# The kernel against the chain of ops on the card. Both are float32 with
# the same operations; only the order of the sums over each patch differs
# (and cuBLAS's rounding of the chain's 2x2 products), by ~1e-7 relative a
# step. That can move a feature across the convergence test |delta|^2 <
# klt_conv_eps^2 one iteration earlier or later, and the extra step is
# below klt_conv_eps 2^lv px. So: positions within UV_TOL px (the widest
# gaps seen on an H100, with no flag turned over: 3.1e-5 px at these
# shapes, 2.6e-4 px on chip_smoke's noisier problems; 18 dependent
# iterations through each feature's inverse Hessian carry the sums'
# rounding), the mean residual within RES_TOL of the larger one (or
# RES_TOL_ABS); the ok flag may turn over in at most OK_FLIPS of the
# features, each within UV_FLIP px; n_warped within WARP_TOL pairs (a
# sample at the edge of the big patch, |r| = (B - 1) / 2 within rounding).
UV_TOL = 1e-3
UV_FLIP = 0.2
RES_TOL, RES_TOL_ABS = 1e-3, 1e-4
OK_FLIPS = 0.02
WARP_TOL = 2


def _max(t) -> float:
    return float(t.max()) if t.numel() else 0.0


def _close(got, want):
    uv, ok, res, nw = got
    puv, pok, pres, pnw = want
    fin = torch.isfinite(puv).all(-1)
    assert torch.equal(torch.isfinite(uv).all(-1), fin)
    assert torch.equal(uv[~fin].isnan(), puv[~fin].isnan())
    flips = ok != pok
    gap = (uv - puv).abs().amax(-1)[fin]
    assert int(flips.sum()) <= max(1, OK_FLIPS * ok.numel()), int(
        flips.sum())
    steady = (~flips)[fin]
    assert _max(gap[steady]) <= UV_TOL, _max(gap[steady])
    assert _max(gap) <= UV_FLIP, _max(gap)
    rgap = (res - pres).abs()
    assert bool((rgap <= torch.clamp(RES_TOL * torch.maximum(
        res.abs(), pres.abs()), min=RES_TOL_ABS))[~flips & fin].all()), \
        _max(rgap)
    assert abs(int(nw) - int(pnw)) <= WARP_TOL, (int(nw), int(pnw))


@pytest.fixture(scope="module")
def card_problems():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: klt_track_kernel has no CPU mode")
    probs = {k: _problem(cfg, torch.device("cuda"))
             for k, cfg in SHAPES.items()}
    probs["affine"] = _affine(probs["affine"])
    return probs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_klt_track_matches_the_chain(card_problems, shape):
    prob = card_problems[shape]
    before = kk.LAUNCHES["klt_track"]
    got = prob.op()
    assert kk.LAUNCHES["klt_track"] == before + 1
    _close(got, prob.plain())
    assert int(got[1].sum()) > 10
    if shape == "affine":
        assert int(got[3]) > 0
    # klt.track launches the kernel on the card
    _equal(prob.track(), got)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "step"])
def test_cuda_klt_track_variant(card_problems, variant):
    prob = VARIANTS[variant](card_problems["euroc"])
    got, want = prob.op(), prob.plain()
    _close(got, want)
    if variant == "all_masked":
        _equal(got, want)


@pytest.mark.cuda
def test_cuda_klt_track_batch_of_8_is_each_launch(card_problems):
    p = card_problems["euroc"]
    uvs = torch.stack([p.uv_init + 0.3 * b for b in range(8)])
    before = kk.LAUNCHES["klt_track"]
    batch = torch.func.vmap(lambda uv: p.replace(uv_init=uv).op())(uvs)
    assert kk.LAUNCHES["klt_track"] == before + 1
    for b in range(8):
        _equal([x[b] for x in batch], p.replace(uv_init=uvs[b]).op())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_klt_track_repeats(card_problems, shape):
    prob = card_problems[shape]
    _equal(prob.op(), prob.op())


@pytest.mark.cuda
def test_cuda_graphed_step_launches_one_klt_a_tracked_frame(cuda_device):
    cfg = SvoConfig()
    lefts, rights, _ = synthetic.make_sequence(cfg.camera, 12, dt=DT,
                                               device=cuda_device)
    step = graphed.make_graphed_step(cfg, cuda_device)
    for body in ("A_ok", "A_fail"):
        assert step.kernel_nodes[body]["klt_track"] == 1
    graphed.settle()
    before = kk.LAUNCHES["klt_track"]
    r0 = step.replays
    runner.run_frames(step, lefts, rights)
    graphed.settle()
    r1 = step.replays
    tracked = sum(r1[g] - r0[g] for g in ("A_ok", "A_fail"))
    assert tracked == len(lefts) - 1        # frame 0 bootstraps
    assert kk.LAUNCHES["klt_track"] - before == tracked


def _keeps_the_chain_decisions(cfg, lefts, rights, device, monkeypatch,
                               gap_m):
    _, fused = runner.run_sequence_scan(cfg, lefts, rights, device)
    with monkeypatch.context() as m:
        m.setattr(klt, "track", klt.track_plain)
        _, chain = runner.run_sequence_scan(cfg, lefts, rights, device)
    assert torch.equal(fused.tracking_ok, chain.tracking_ok)
    assert torch.equal(fused.kf_inserted, chain.kf_inserted)
    assert bool(fused.tracking_ok[1:].all())
    from stereo_svo_tpu_torch.geometry import se3
    gap = (se3.translation(fused.T_wc) - se3.translation(chain.T_wc)).norm(
        dim=-1)
    assert float(gap.max()) < gap_m


@pytest.mark.cuda
def test_cuda_300_euroc_frames_keep_the_chain_decisions(cuda_device,
                                                        monkeypatch):
    """300 graphed frames with the kernel keep the tracking and keyframe
    decisions of the same step with the chain, on every frame (the
    benchmark's planes scene on the loop trajectory at 20 Hz); positions
    within the benchmark's EuRoC limit."""
    cfg = SvoConfig()
    lefts, rights, _ = synthetic.make_sequence(cfg.camera, 300, dt=DT,
                                               kind="loop",
                                               device=cuda_device)
    _keeps_the_chain_decisions(cfg, lefts, rights, cuda_device, monkeypatch,
                               2e-3)


@pytest.mark.cuda
def test_cuda_25_kitti_frames_keep_the_chain_decisions(cuda_device,
                                                       monkeypatch):
    """25 graphed KITTI frames (the benchmark's road scene on the kitti
    trajectory at 10 Hz) keep the chain's decisions; positions within the
    benchmark's KITTI limit."""
    import bench_torch
    cfg = kitti_config()
    lefts, rights, _ = bench_torch.render_sequence(
        cfg.camera, 25, "road", "kitti", seed=0, dt=0.1, device=cuda_device)
    _keeps_the_chain_decisions(cfg, lefts, rights, cuda_device, monkeypatch,
                               7.5e-3)
