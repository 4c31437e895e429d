"""The graph-captured step (``engine/graphed.py``) against the eager step
and the JAX package's jitted ``StereoSvo``.

On the CPU the graphed step runs the frame graph's plain version: its
bodies directly on its static buffers, each conditional one where its
device predicate holds. So every copy into the buffers — into the staged
state ``S'``, from ``S'`` back into itself (the keyframe phase) and back
into the live state ``S`` — and every predicate is exercised here: it
must equal the eager ``step.make_step`` bit for bit over frames that take
every branch — the bootstrap (the ``boot`` body), keyframe frames (the
``K`` body: insertion and window BA), with the online loop on a due
keyframe (the ``K_loop`` body), a blackout of two frames (the ``A_fail``
variant on the frame after a failure), a ``resume`` from a mid-run state
and a ``svo.state =`` assignment — and each body's run counter must
equal what the FrameOut flags imply.

The ``cuda`` tests (skipped without a card) capture the bodies into the
frame graph and hold its launches to the eager step on the card, bit for
bit, across keyframe frames and a due online loop; launch the same frame
twice (B4's ticket counter resets itself) and add each body's kernel
nodes, read through libcuda, times its runs to the launch counters; and
show that a body that synchronises, or a counted launch that the body
does not hold, makes capture raise, with no eager fallback. On the card's
machine, which has no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_graphed.py``.

The small camera and settings are those of tests/test_torch_tracking_loss.py
(376×240), whose tolerances the comparison with JAX uses.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import graphed, runner
from stereo_svo_tpu_torch.engine import step as step_mod
from stereo_svo_tpu_torch.engine.state import FrameOut, init_state
from stereo_svo_tpu_torch.geometry import se3
from stereo_svo_tpu_torch.io import synthetic
from stereo_svo_tpu_torch.ops import kernels
from stereo_svo_tpu_torch.ops.kernels import align_kernel

try:
    from stereo_svo_tpu.config import CameraConfig as JCam
    from stereo_svo_tpu.config import SvoConfig as JCfg
    from stereo_svo_tpu.engine import runner as jrunner
    from stereo_svo_tpu.io import synthetic as jsynth
except ImportError:    # the card's machine: only the ``cuda`` tests run
    jrunner = None

torch.set_num_threads(1)

CAM_KW = dict(fx=240.0, fy=240.0, cx=188.0, cy=120.0, baseline=0.11,
              width=376, height=240)
CFG_KW = dict(grid_rows=10, grid_cols=13, max_features=130, num_levels=3,
              align_levels=3, klt_levels=3, stereo_max_disp=64,
              kf_min_tracked=40, border_margin=10)
CFG = SvoConfig(camera=CameraConfig(**CAM_KW), **CFG_KW)
# the online loop on every second keyframe created, over a 12-slot bank:
# due at the first keyframe after the bootstrap, not at the second
LOOP_CFG = dataclasses.replace(CFG, online_loop_every=2, mem_keyframes=12)
N_FRAMES, DT, BLACK = 30, 0.12, (6, 7)
RESUME_AT, ASSIGN_AT = 12, 18
POSE_ATOL = 2e-4           # tests/test_torch_tracking_loss.py
DRIFT = [0.01, -0.005, 0.0, 0.0, 0.002, 0.0]


def _frames(device="cpu"):
    lefts, rights, gt = synthetic.make_sequence(CFG.camera, N_FRAMES, dt=DT,
                                                kind="arc", seed=0,
                                                device=device)
    for i in BLACK:
        lefts[i] = 0.0
        rights[i] = 0.0
    return lefts, rights, gt


def _nudge(state):
    """What a caller may assign to ``svo.state`` mid-run: the current and
    previous poses moved by a small rigid offset."""
    D = se3.exp(torch.tensor(DRIFT, dtype=torch.float32,
                             device=state.T_cw.device))
    return state._replace(T_cw=se3.compose(state.T_cw, D),
                          T_pw=se3.compose(state.T_pw, D))


def _clone(tree):
    return type(tree)(*(_clone(v) if isinstance(v, tuple) else v.clone()
                        for v in tree))


def _eager(cfg):
    """The eager ``step.make_step`` with the graphed step's signature,
    ``step(state, img_l, img_r) -> (state, FrameOut)``: its host flags
    read from the state on every frame."""
    inner = step_mod.make_step(cfg)

    def step(state, img_l, img_r):
        state, out, _ = inner(state, img_l, img_r)
        return state, out
    return step


def _run(step, state, lefts, rights, resume_state=None):
    """Drive ``step`` (eager or graphed) over the frames, with a resume
    from ``resume_state`` before RESUME_AT (when given) and the nudge
    assigned before ASSIGN_AT; (per-frame FrameOuts, the state kept at
    RESUME_AT, the final state), every output cloned."""
    outs, kept = [], None
    for i in range(len(lefts)):
        if i == RESUME_AT:
            kept = _clone(state)
            if resume_state is not None:
                state = resume_state
        if i == ASSIGN_AT:
            state = _nudge(state)
        state, out = step(state, lefts[i], rights[i])
        outs.append(_clone(out))
    return outs, kept, _clone(state)


def _assert_equal_runs(a, b):
    outs_a, kept_a, final_a = a
    outs_b, kept_b, final_b = b
    for i, (x, y) in enumerate(zip(outs_a, outs_b, strict=True)):
        for name, u, v in zip(FrameOut._fields, x, y):
            assert torch.equal(u.cpu(), v.cpu()), (i, name)
    for tree_a, tree_b in ((kept_a, kept_b), (final_a, final_b)):
        for u, v in zip(graphed._leaves(tree_a), graphed._leaves(tree_b),
                        strict=True):
            assert torch.equal(u.cpu(), v.cpu())


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def eager_run(frames):
    lefts, rights, _ = frames
    return _run(_eager(CFG), init_state(CFG, "cpu"), lefts, rights)


def test_the_frames_take_every_branch(eager_run):
    """Bootstrap, keyframe frames after it, the blackout's failed frames
    and the A_fail variant on the frame after each failure."""
    outs = eager_run[0]
    ok = np.array([bool(o.tracking_ok) for o in outs])
    kf = np.array([bool(o.kf_inserted) for o in outs])
    expected = np.ones(N_FRAMES, bool)
    expected[list(BLACK)] = False
    np.testing.assert_array_equal(ok, expected)
    assert kf[0] and kf[1:].sum() >= 2
    assert kf[ASSIGN_AT:].any()


def test_graphed_cpu_equals_eager_bit_for_bit(frames, eager_run):
    lefts, rights, _ = frames
    step = graphed.make_graphed_step(CFG, "cpu")
    got = _run(step, init_state(CFG, "cpu"), lefts, rights)
    _assert_equal_runs(got, eager_run)
    # S' has a buffer of its own for every field
    live = {graphed._storage(x) for x in step._s}
    assert not live & {graphed._storage(x) for x in step._s1}
    # every keyframe frame after the bootstrap went through the K body
    kf = [bool(o.kf_inserted) for o in eager_run[0]]
    assert step.replays["K"] == sum(kf[1:]) and step.replays["K_loop"] == 0
    assert "K_loop" not in step.graph_names


def test_body_counters_equal_the_flags(frames, eager_run):
    """Each body's run counter, counted on the device, against what the
    FrameOut flags imply: one bootstrap, K plus K_loop the keyframes after
    it, A_fail the frames after a failed frame, B every other frame."""
    lefts, rights, _ = frames
    step = graphed.make_graphed_step(CFG, "cpu")
    _run(step, init_state(CFG, "cpu"), lefts, rights)
    ok = np.array([bool(o.tracking_ok) for o in eager_run[0]])
    kf = np.array([bool(o.kf_inserted) for o in eager_run[0]])
    runs = step.replays
    assert runs["P"] == runs["flags"] == N_FRAMES
    assert runs["boot"] == 1
    assert runs["K"] + runs["K_loop"] == kf[1:].sum()
    assert runs["A_fail"] == (~ok[1:-1]).sum() == len(BLACK)
    assert runs["A_ok"] + runs["A_fail"] == runs["B"] == N_FRAMES - 1


def _loop_calls(monkeypatch):
    """Count the calls of ``step.run_online_loop`` (``kf_phase`` looks it
    up at each call) without reading the device: a call may be captured."""
    calls = []
    orig = step_mod.run_online_loop

    def counted(cfg, st):
        calls.append(1)
        return orig(cfg, st)

    monkeypatch.setattr(step_mod, "run_online_loop", counted)
    return calls


def test_graphed_cpu_online_loop_through_k_loop_bit_for_bit(frames,
                                                            monkeypatch):
    """With the online loop on, a keyframe frame where the loop is due
    goes through the K_loop body and the others through K: bit for bit the
    eager step, and the replays count the keyframe and loop frames."""
    lefts, rights, _ = frames
    calls = _loop_calls(monkeypatch)
    eager = _run(_eager(LOOP_CFG), init_state(LOOP_CFG, "cpu"), lefts,
                 rights)
    n_loop = len(calls)
    step = graphed.make_graphed_step(LOOP_CFG, "cpu")
    got = _run(step, init_state(LOOP_CFG, "cpu"), lefts, rights)
    _assert_equal_runs(got, eager)
    n_kf = sum(bool(o.kf_inserted) for o in eager[0][1:])
    assert n_loop >= 1 and n_kf - n_loop >= 1       # both bodies ran
    assert step.replays["K_loop"] == n_loop == len(calls) - n_loop
    assert step.replays["K"] == n_kf - n_loop
    assert step.replays["B"] == N_FRAMES - 1


def test_graphed_cpu_resume_and_assignment_bit_for_bit(frames, eager_run):
    """A fresh graphed step resumed from the eager run's state at
    RESUME_AT continues exactly as the eager run does."""
    lefts, rights, _ = frames
    kept = eager_run[1]
    step = graphed.make_graphed_step(CFG, "cpu")
    got = _run(step, init_state(CFG, "cpu"), lefts, rights,
               resume_state=_clone(kept))
    _assert_equal_runs(got, eager_run)


def test_stereo_svo_state_semantics(frames, eager_run):
    """``svo.state`` is the live buffers (the next frame overwrites them);
    assigning copies into them; ``resume`` re-reads the host flags; the
    FrameOut and poses that leave StereoSvo are its own copies."""
    lefts, rights, _ = frames
    outs, kept, _ = eager_run
    svo = runner.StereoSvo(CFG, device="cpu")
    live = svo.state
    svo.resume(_clone(kept))
    assert svo.state is live and svo.tracking_ok
    assert torch.equal(svo.state.mu, kept.mu)
    first = svo.new_image(lefts[RESUME_AT], rights[RESUME_AT])
    T0 = first.T_wc.clone()
    svo.new_image(lefts[RESUME_AT + 1], rights[RESUME_AT + 1])
    assert torch.equal(first.T_wc, T0)          # not overwritten
    np.testing.assert_array_equal(
        svo.trajectory(),
        torch.stack([o.T_wc for o in outs[RESUME_AT:RESUME_AT + 2]]).numpy())
    svo.state = _nudge(svo.state)
    assert svo.state is live


@pytest.mark.skipif(jrunner is None, reason="needs the JAX package")
def test_stereo_svo_cpu_matches_jax_stereo_svo():
    """The port's StereoSvo (graphed, on the CPU) and the reference's
    jitted StereoSvo on the same frames: the same decisions on every frame,
    poses within the tracking-loss tests' tolerance. The frames are the
    JAX renderer's, as there."""
    jcfg = JCfg(camera=JCam(**CAM_KW), **CFG_KW)
    lefts, rights, _ = jsynth.make_sequence(jcfg.camera, N_FRAMES, dt=DT,
                                            kind="arc", seed=0)
    lefts, rights = np.array(lefts), np.array(rights)
    lefts[list(BLACK)] = 0.0
    rights[list(BLACK)] = 0.0
    jsvo = jrunner.StereoSvo(jcfg)
    svo = runner.StereoSvo(CFG, device="cpu")
    for l, r in zip(lefts, rights):
        jsvo.new_image(l, r)
        svo.new_image(l, r)
    m, jm = svo.metrics(), jsvo.metrics()
    for name in ("tracking_ok", "kf_inserted"):
        np.testing.assert_array_equal(m[name], np.asarray(jm[name]))
    traj, jtraj = svo.trajectory(), np.asarray(jsvo.trajectory())
    assert np.isfinite(traj).all()
    np.testing.assert_allclose(traj, jtraj, atol=POSE_ATOL)


def test_run_sequence_scan_equals_stereo_svo(frames):
    """run_sequence_scan keeps every frame's output although the step
    hands back one static FrameOut."""
    lefts, rights, _ = frames
    n = BLACK[0]           # moving frames only: every pose differs
    _, outs = runner.run_sequence_scan(CFG, lefts[:n], rights[:n],
                                       device="cpu")
    traj, _ = runner.run_sequence(CFG, lefts[:n], rights[:n], device="cpu")
    np.testing.assert_array_equal(outs.T_wc.numpy(), traj)
    assert len({tuple(t.flatten().tolist()) for t in outs.T_wc}) == n


def test_counter_of_reads_libcuda_and_profiler_names():
    """The kernel of each launch counter is found by its CUDA function's
    name as libcuda gives it (mangled, in the sources' anonymous
    namespace, templated) and as torch.profiler does (demangled); other
    functions count for none."""
    names = {
        "halfsample": ("_ZN12_GLOBAL__N_121pyramid_levels_kernelEPKfNS_5Ch"
                       "ainE",
                       "(anonymous namespace)::pyramid_levels_kernel(float "
                       "const*, (anonymous namespace)::Chain)"),
        "gradients": ("_ZN12_GLOBAL__N_123gradients_levels_kernelENS_8Gra"
                      "dWorkE",
                      "(anonymous namespace)::gradients_levels_kernel("
                      "(anonymous namespace)::GradWork)"),
        "sample_patches": ("_ZN12_GLOBAL__N_119sample_patch_kernelEPKfiii",
                           "(anonymous namespace)::sample_patch_kernel(float "
                           "const*, int, int, int)"),
        "gn_accumulate": ("_ZN12_GLOBAL__N_120gn_accumulate_kernelILi4EEvPKf",
                          "void (anonymous namespace)::gn_accumulate_kernel"
                          "<4>(float const*)"),
        "align_levels": ("_ZN12_GLOBAL__N_119align_levels_kernelILi4EEEvNS_9"
                         "AlignArgsEi",
                         "void (anonymous namespace)::align_levels_kernel<4>"
                         "((anonymous namespace)::AlignArgs, int)"),
        "refine_pose": ("_ZN12_GLOBAL__N_118refine_pose_kernelILi256EEEvNS_10"
                        "RefineArgsE",
                        "void (anonymous namespace)::refine_pose_kernel<256>"
                        "((anonymous namespace)::RefineArgs)"),
        "klt_track": ("_ZN12_GLOBAL__N_116klt_track_kernelILi8EEEvNS_7KltArgs"
                      "Ei",
                      "void (anonymous namespace)::klt_track_kernel<8>("
                      "(anonymous namespace)::KltArgs, int)"),
    }
    assert set(names) == set(kernels.KERNELS)
    for key, forms in names.items():
        for name in forms:
            assert graphed.counter_of(name) == key, name
    for other in ("_ZN2at6native29vectorized_elementwise_kernelILi4EEEviT0_",
                  "void at::native::reduce_kernel<512, 1>(float*)",
                  "_Z20xgradients_kernel_2v", "my_gradients_kernel_v2(int)",
                  # the one-launch-per-level B2 of earlier trees
                  "_ZN12_GLOBAL__N_116gradients_kernelEPKfPfS2_ii",
                  "cudaLaunchKernel"):
        assert graphed.counter_of(other) is None, other


def test_a_dropped_step_is_freed_by_reference_counting(frames):
    """A step holds no reference cycle, so dropping it frees it (on the
    card: destroys its graphs) at once. Freed later by the cyclic
    collector, it could destroy its graphs during another step's capture,
    which invalidates that capture."""
    lefts, rights, _ = frames
    collecting = gc.isenabled()
    gc.disable()
    try:
        for make in (lambda: graphed.make_graphed_step(LOOP_CFG, "cpu"),
                     lambda: graphed.make_graphed_batched_step(CFG, 2,
                                                               "cpu")):
            step = make()
            ref = weakref.ref(step)
            if isinstance(step, graphed.GraphedStep):
                for i in range(2):
                    step(step.state, lefts[i], rights[i])
            del step
            assert ref() is None
    finally:
        if collecting:
            gc.enable()


def test_static_buffers_refuse_a_wrong_image_or_field():
    step = graphed.make_graphed_step(CFG, "cpu")
    img = torch.zeros(CFG.camera.height, CFG.camera.width + 1)
    with pytest.raises(ValueError):
        step(step.state, img, img)
    with pytest.raises(ValueError):
        step.load(step.state._replace(mu=step.state.mu.double()))


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs capture CUDA work")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_on_the_card_equals_eager_bit_for_bit(cuda_device):
    lefts, rights, _ = _frames(cuda_device)
    eager = _run(_eager(CFG), init_state(CFG, cuda_device), lefts, rights)
    step = graphed.make_graphed_step(CFG, cuda_device)
    # the online loop is off: no K_loop
    assert set(step.graphs) == set(graphed.GRAPHS) - {"K_loop"}
    got = _run(step, init_state(CFG, cuda_device), lefts, rights,
               resume_state=_clone(eager[1]))
    _assert_equal_runs(got, eager)
    kf = [bool(o.kf_inserted) for o in eager[0]]
    assert step.replays["K"] == sum(kf[1:])


@pytest.mark.cuda
def test_graphed_on_the_card_online_loop_bit_for_bit(cuda_device,
                                                     monkeypatch):
    """Keyframe frames replay K (insertion, window BA: cuSOLVER's Cholesky
    under capture) and the due one K_loop (the online loop: jacfwd and
    solve_ex under capture), bit for bit the eager step."""
    lefts, rights, _ = _frames(cuda_device)
    calls = _loop_calls(monkeypatch)
    eager = _run(_eager(LOOP_CFG), init_state(LOOP_CFG, cuda_device), lefts,
                 rights)
    n_loop = len(calls)
    step = graphed.make_graphed_step(LOOP_CFG, cuda_device)
    assert set(step.graphs) == set(graphed.GRAPHS)
    got = _run(step, init_state(LOOP_CFG, cuda_device), lefts, rights)
    _assert_equal_runs(got, eager)
    n_kf = sum(bool(o.kf_inserted) for o in eager[0][1:])
    # the online loop ran eagerly only in the warm-up and the capture
    assert n_loop >= 1 and len(calls) == n_loop + 2
    assert step.replays["K_loop"] == n_loop
    assert step.replays["K"] == n_kf - n_loop >= 1


@pytest.mark.cuda
def test_keyframe_graphs_hold_their_kernels(cuda_device):
    """K holds the insertion's B3 launches (the stereo match); K_loop adds
    the online loop's B2, B3 and fused alignment at the thumbnail. Each body's kernel
    nodes equal what its capture counted (capture raises otherwise), and
    settling the counters adds each body's kernel nodes times its runs."""
    lefts, rights, _ = _frames(cuda_device)
    step = graphed.make_graphed_step(LOOP_CFG, cuda_device)
    k, kl = step.kernel_nodes["K"], step.kernel_nodes["K_loop"]
    assert k["sample_patches"] > 0 and k["halfsample"] == 0
    assert all(kl[x] > k[x]
               for x in ("gradients", "sample_patches", "align_levels"))
    graphed.settle()
    c0 = graphed._counts()
    for i in range(len(lefts)):
        step(step.state, lefts[i], rights[i])
    graphed.settle()
    c1 = graphed._counts()
    runs = step.replays
    assert runs["K_loop"] >= 1 and runs["K"] >= 1
    assert {key: c1[key] - c0[key] for key in c0} == {
        key: sum(runs[g] * step.kernel_nodes[g][key] for g in step.graphs)
        for key in c0}


@pytest.mark.cuda
def test_replays_count_launches_and_repeat(cuda_device):
    """The same frame launched twice from the same state gives the same
    result (no kernel keeps state between calls) and adds
    the kernel nodes of the bodies it ran, read through libcuda, each
    time."""
    lefts, rights, _ = _frames(cuda_device)
    step = graphed.make_graphed_step(CFG, cuda_device)
    nodes = step.kernel_nodes
    assert nodes["P"] == dict(dict.fromkeys(kernels.KERNELS, 0),
                              halfsample=1, gradients=1)
    assert step.nodes["P"]["kernel"] == 2
    # the alignment, the KLT and the pose refinement are one node each; B4
    # is off the main path
    for body in ("A_ok", "A_fail"):
        assert nodes[body]["align_levels"] == 1
        assert nodes[body]["klt_track"] == 1
        assert nodes[body]["refine_pose"] == 1
    assert nodes["A_ok"]["gn_accumulate"] == 0
    state, _ = step(step.state, lefts[0], rights[0])
    before = _clone(state)
    results = []
    for _ in range(2):
        step.load(before)
        graphed.settle()
        c0, r0 = graphed._counts(), step.replays
        _, out = step(step.state, lefts[1], rights[1])
        graphed.settle()
        c1, r1 = graphed._counts(), step.replays
        ran = [g for g in step.graphs if r1[g] > r0[g]]
        assert {"P", "flags", "A_ok", "B"} <= set(ran) and "boot" not in ran
        assert all(r1[g] - r0[g] == 1 for g in ran)
        results.append(_clone(out))
        assert {k: c1[k] - c0[k] for k in c0} == {
            k: sum(nodes[g][k] for g in ran) for k in c0}
    for a, b in zip(*results):
        assert torch.equal(a, b)


def _patched_body(name, extra):
    """``GraphedStep._run_body`` with ``extra(step)`` run before body
    ``name``."""
    orig = graphed.GraphedStep._run_body

    def body(self, which):
        if which == name:
            extra(self)
        return orig(self, which)
    return orig, body


@pytest.mark.cuda
def test_capture_refuses_a_body_that_syncs(cuda_device):
    """No eager fallback: a body that reads the device raises out of the
    capture, and so does the step made for the card when its capture
    fails."""
    x = torch.ones(4, device=cuda_device)
    side = torch.cuda.Stream(cuda_device)
    pool = torch.cuda.graph_pool_handle()
    with pytest.raises(RuntimeError):
        graphed.capture(lambda: float(x.sum()), pool, side)
    counts = kernels.launches()
    # a host read in a body
    orig, body = _patched_body("B", lambda self: bool(
        self.state.tracking_ok))
    graphed.GraphedStep._run_body = body
    try:
        with pytest.raises(RuntimeError):
            graphed.make_graphed_step(CFG, cuda_device)
    finally:
        graphed.GraphedStep._run_body = orig
    # the counters are as they were: neither warm-up nor capture counts
    assert kernels.launches() == counts


@pytest.mark.cuda
def test_capture_refuses_counts_the_graph_does_not_hold(cuda_device):
    """A launch the wrappers count but the body does not hold (here a
    count with no kernel behind it) makes capture raise: the counts a
    frame adds are the bodies' own kernel nodes."""
    def miscount(self):
        align_kernel.LAUNCHES["sample_patches"] += 1

    orig, body = _patched_body("B", miscount)
    graphed.GraphedStep._run_body = body
    try:
        with pytest.raises(RuntimeError, match="graph B holds"):
            graphed.make_graphed_step(CFG, cuda_device)
    finally:
        graphed.GraphedStep._run_body = orig
