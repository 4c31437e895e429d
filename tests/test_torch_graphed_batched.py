"""The graph-captured batched step (``engine/graphed.make_graphed_batched_step``)
against the eager ``step.make_batched_step``.

B = 3 sequences of tests/test_torch_graphed.py's small camera, each its
own scene and speed along the arc; sequence 1 is blacked out on two
frames, so that on the frame after them the batch runs the ``A_fail``
variant (the rotated relocalisation variants count for sequence 1 only)
while sequence 0 inserts a keyframe (``K``, kept for sequence 0 only) —
one batched frame mixes every selection. On the CPU the graphed batched
step runs its frame graph's plain version, the same ``vmap``ped bodies on
its stacked static buffers under the batch's device predicates: it must
equal the eager batched step bit for bit, with the decisions of the whole
batch written once per batched frame after the bootstrap, also for a
batch that mixes booted and unbooted sequences (the ``save`` and
``boot_mix`` bodies).

The ``cuda`` tests (skipped without a card) hold, on the card, the graphed
batched step to the eager one bit for bit, its graphs' kernel nodes to at
most 1.5× the single step's, and each sequence to its single graphed run
(flags equal, positions within float32 summation order). On the card's
machine, which has no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_graphed_batched.py``.
"""

import numpy as np
import pytest
import torch

from stereo_svo_tpu_torch.engine import graphed
from stereo_svo_tpu_torch.engine import step as step_mod
from stereo_svo_tpu_torch.engine.state import FrameOut, init_states
from stereo_svo_tpu_torch.io import synthetic
from stereo_svo_tpu_torch.ops import kernels
from test_torch_graphed import CFG

torch.set_num_threads(1)

T = 12
SEQS = ((1, 0.2), (0, 0.12), (2, 0.09))      # (scene seed, dt)
BLACK = {1: (6, 7)}                          # sequence: blacked-out frames
MIX_AT = 8      # sequence 0 inserts a keyframe, sequence 1 recovers


def _frames(device="cpu", seqs=SEQS):
    lefts, rights = [], []
    for b, (seed, dt) in enumerate(seqs):
        l, r, _ = synthetic.make_sequence(CFG.camera, T, dt=dt, kind="arc",
                                          seed=seed, device=device)
        for i in BLACK.get(b, ()):
            l[i] = 0.0
            r[i] = 0.0
        lefts.append(l)
        rights.append(r)
    return torch.stack(lefts), torch.stack(rights)


def _clone(tree):
    return type(tree)(*(_clone(v) if isinstance(v, tuple) else v.clone()
                        for v in tree))


def _run(bstep, states, lefts, rights):
    """Drive a batched step (eager: its host flags read from the states on
    every frame; graphed) over the (B,T,H,W) frames: (per-frame stacked
    FrameOuts, the final stacked state), every output cloned."""
    outs = []
    for t in range(lefts.shape[1]):
        states, out = bstep(states, lefts[:, t], rights[:, t])[:2]
        outs.append(_clone(out))
    return outs, _clone(states)


def _assert_equal(a, b):
    outs_a, states_a = a
    outs_b, states_b = b
    for t, (x, y) in enumerate(zip(outs_a, outs_b, strict=True)):
        for name, u, v in zip(FrameOut._fields, x, y):
            assert torch.equal(u.cpu(), v.cpu()), (t, name)
    for u, v in zip(graphed._leaves(states_a), graphed._leaves(states_b),
                    strict=True):
        assert torch.equal(u.cpu(), v.cpu())


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def eager_run(frames):
    lefts, rights = frames
    return _run(step_mod.make_batched_step(CFG),
                init_states(CFG, len(SEQS), "cpu"), lefts, rights)


def _flags(outs):
    """(tracking_ok, kf_inserted) as (B,T) numpy bools."""
    return (torch.stack([o.tracking_ok for o in outs], 1).cpu().numpy(),
            torch.stack([o.kf_inserted for o in outs], 1).cpu().numpy())


def test_the_batch_mixes_every_variant(eager_run):
    """On MIX_AT sequence 0 tracks and inserts a keyframe, sequence 1
    recovers from its blackout (A_fail) and sequence 2 tracks alone."""
    ok, kf = _flags(eager_run[0])
    np.testing.assert_array_equal(np.nonzero(~ok[1])[0], BLACK[1])
    assert ok[0].all() and ok[2].all()
    assert kf[0, MIX_AT] and not kf[1, MIX_AT] and not kf[2, MIX_AT]
    assert not ok[1, MIX_AT - 1] and ok[1, MIX_AT]


def test_graphed_batched_cpu_equals_eager_bit_for_bit(frames, eager_run,
                                                      monkeypatch):
    """Every FrameOut and the final states equal the eager batched step's
    bit for bit; the decisions of the whole batch are taken once per
    batched frame after the bootstrap; each body runs once for the whole
    batch, A_fail on the frames after a failure in any sequence."""
    lefts, rights = frames
    reads = []
    orig = graphed.device_decisions_batched

    def counted(cfg, st, ctx, booted):
        reads.append(st.T_cw.shape[0])
        return orig(cfg, st, ctx, booted)

    monkeypatch.setattr(graphed, "device_decisions_batched", counted)
    bstep = graphed.make_graphed_batched_step(CFG, len(SEQS), "cpu")
    got = _run(bstep, bstep.state, lefts, rights)
    _assert_equal(got, eager_run)
    assert reads == [len(SEQS)] * (T - 1)   # the stacked batch, once
    ok, kf = _flags(eager_run[0])
    replays = bstep.replays
    assert replays["P"] == T
    assert replays["B"] == T - 1
    assert replays["A_fail"] == int((~ok[:, 1:-1]).any(0).sum())
    assert replays["A_ok"] == replays["B"] - replays["A_fail"]
    assert replays["K"] == int(kf[:, 1:].any(0).sum())
    assert replays["K_loop"] == 0
    assert replays["boot"] == 1
    assert replays["save"] == replays["boot_mix"] == 0


def _mixed(states, fresh: int):
    """``states`` with sequence ``fresh`` set back to the initial state: a
    batch of booted and unbooted sequences."""
    init = graphed._leaves(init_states(CFG, len(SEQS), "cpu"))
    leaves = [x.clone() for x in graphed._leaves(states)]
    for x, y in zip(leaves, init):
        x[fresh] = y[fresh]
    return graphed._tree(states, iter(leaves))


def test_graphed_batched_cpu_mixed_bootstrap_bit_for_bit(frames, eager_run):
    """From the eager run's final states with sequence 1 set back to its
    initial state, the next frames bootstrap sequence 1 while 0 and 2
    track on (``save`` and ``boot_mix`` on the first, then the booted
    path): bit for bit the eager batched step."""
    lefts, rights = frames
    start = _mixed(eager_run[1], 1)
    n = 3
    eager = _run(step_mod.make_batched_step(CFG), _clone(start),
                 lefts[:, :n], rights[:, :n])
    bstep = graphed.make_graphed_batched_step(CFG, len(SEQS), "cpu")
    got = _run(bstep, _clone(start), lefts[:, :n], rights[:, :n])
    _assert_equal(got, eager)
    ok, kf = _flags(eager[0])
    assert kf[1, 0] and ok.all()
    runs = bstep.replays
    assert runs["save"] == runs["boot_mix"] == 1 and runs["boot"] == 0
    assert runs["B"] == n


def test_graphed_batched_refuses_a_wrong_batch():
    bstep = graphed.make_graphed_batched_step(CFG, 2, "cpu")
    img = torch.zeros(2, CFG.camera.height, CFG.camera.width)
    with pytest.raises(ValueError):
        bstep(init_states(CFG, 1, "cpu"), img, img)
    with pytest.raises(ValueError):
        bstep(bstep.state, img[:1], img[:1])


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs capture CUDA work")
    return torch.device("cuda")


def _single_nodes(cfg, device):
    """The single graphed step's kernel nodes by body of a phase (not the
    bookkeeping of the flags body or the frame graph's own set nodes)."""
    step = graphed.make_graphed_step(cfg, device)
    return {k: v["kernel"] for k, v in step.nodes.items()
            if k not in ("flags", "F")}


@pytest.mark.cuda
def test_graphed_batch_of_two_equals_single_graphed_runs(cuda_device):
    """Each sequence of a graphed batch of two against its single graphed
    run on the card: tracking and keyframe flags equal on every frame,
    positions within 2e-4 m (batched sums and solves in another float32
    order, ROADMAP W7)."""
    seqs = SEQS[:2]
    lefts, rights = _frames(cuda_device, seqs)
    bstep = graphed.make_graphed_batched_step(CFG, len(seqs), cuda_device)
    outs, _ = _run(bstep, bstep.state, lefts, rights)
    assert bstep.pool_bytes > 0 and bstep.capture_seconds > 0
    ok, kf = _flags(outs)
    pos = torch.stack([o.T_wc[..., 3] for o in outs], 1).cpu()
    for b in range(len(seqs)):
        step = graphed.make_graphed_step(CFG, cuda_device)
        single = []
        for t in range(T):
            _, out = step(step.state, lefts[b, t], rights[b, t])
            single.append(_clone(out))
        s_ok, s_kf = _flags([FrameOut(*(x[None] for x in o))
                             for o in single])
        np.testing.assert_array_equal(ok[b], s_ok[0])
        np.testing.assert_array_equal(kf[b], s_kf[0])
        s_pos = torch.stack([o.T_wc[:, 3] for o in single]).cpu()
        assert float((pos[b] - s_pos).norm(dim=-1).max()) < 2e-4


@pytest.mark.cuda
def test_cuda_graphed_batched_equals_eager_and_node_counts(cuda_device):
    """On the card: the graphed batched step equals the eager batched step
    bit for bit (the same launches in the same order), and each of its
    graphs holds at most 1.5× the single step's kernel nodes at B = 3 —
    one node per operation for the whole batch, no per-sequence loop; P
    holds one B1 and one B2 node for the batch's pyramids."""
    lefts, rights = _frames(cuda_device)
    bstep = graphed.make_graphed_batched_step(CFG, len(SEQS), cuda_device)
    got = _run(bstep, bstep.state, lefts, rights)
    eager = _run(step_mod.make_batched_step(CFG),
                 init_states(CFG, len(SEQS), cuda_device), lefts, rights)
    _assert_equal(got, eager)
    single = _single_nodes(CFG, cuda_device)
    for name, n in single.items():
        assert bstep.nodes[name]["kernel"] <= 1.5 * n, (name, n,
                                                        bstep.nodes[name])
    assert bstep.kernel_nodes["P"] == dict(dict.fromkeys(kernels.KERNELS, 0),
                                           halfsample=1, gradients=1)
    for body in ("A_ok", "A_fail"):     # the batch's refinements and KLTs:
        assert bstep.kernel_nodes[body]["refine_pose"] == 1   # one node each
        assert bstep.kernel_nodes[body]["klt_track"] == 1
