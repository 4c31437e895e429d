"""The graph-captured batched step (``engine/graphed.make_graphed_batched_step``)
against the eager ``step.make_batched_step``.

B = 3 sequences of tests/test_torch_graphed.py's small camera, each its
own scene and speed along the arc; sequence 1 is blacked out on two
frames, so that on the frame after them it runs the ``A_fail`` variant
while sequence 0 runs ``A_ok`` and inserts a keyframe (``K``) and sequence
2 runs ``A_ok`` alone — one batched frame mixes every variant. On the CPU
the graphed batched step runs each sequence's bodies on its static
buffers: it must equal the eager batched step bit for bit, with one host
read of the decisions per batched frame after the bootstrap.

The ``cuda`` test (skipped without a card) holds a graphed batch of two to
two single graphed runs on the card, bit for bit. On the card's machine,
which has no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_graphed_batched.py``.
"""

import numpy as np
import pytest
import torch

from stereo_svo_tpu_torch.engine import graphed
from stereo_svo_tpu_torch.engine import step as step_mod
from stereo_svo_tpu_torch.engine.state import FrameOut, init_state
from stereo_svo_tpu_torch.io import synthetic
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
    """Drive a batched step over the (B,T,H,W) frames: (per-frame lists of
    B FrameOuts, the final states), every output cloned."""
    flags = [step_mod.HostFlags(booted=False, tracking_ok=True)] * len(states)
    outs = []
    for t in range(lefts.shape[1]):
        states, out, flags = bstep(states, lefts[:, t], rights[:, t], flags)
        outs.append([_clone(o) for o in out])
    return outs, [_clone(st) for st in states]


def _assert_equal(a, b):
    outs_a, states_a = a
    outs_b, states_b = b
    for t, (xs, ys) in enumerate(zip(outs_a, outs_b, strict=True)):
        for s, (x, y) in enumerate(zip(xs, ys, strict=True)):
            for name, u, v in zip(FrameOut._fields, x, y):
                assert torch.equal(u.cpu(), v.cpu()), (t, s, name)
    for s, (x, y) in enumerate(zip(states_a, states_b, strict=True)):
        for u, v in zip(graphed._leaves(x), graphed._leaves(y), strict=True):
            assert torch.equal(u.cpu(), v.cpu()), s


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def eager_run(frames):
    lefts, rights = frames
    return _run(step_mod.make_batched_step(CFG),
                [init_state(CFG, "cpu") for _ in SEQS], lefts, rights)


def test_the_batch_mixes_every_variant(eager_run):
    """On MIX_AT sequence 0 tracks and inserts a keyframe, sequence 1
    recovers from its blackout (A_fail) and sequence 2 tracks alone."""
    outs = eager_run[0]
    ok = np.array([[bool(o.tracking_ok) for o in row] for row in outs]).T
    kf = np.array([[bool(o.kf_inserted) for o in row] for row in outs]).T
    np.testing.assert_array_equal(np.nonzero(~ok[1])[0], BLACK[1])
    assert ok[0].all() and ok[2].all()
    assert kf[0, MIX_AT] and not kf[1, MIX_AT] and not kf[2, MIX_AT]
    assert not ok[1, MIX_AT - 1] and ok[1, MIX_AT]


def test_graphed_batched_cpu_equals_eager_bit_for_bit(frames, eager_run,
                                                      monkeypatch):
    """Every FrameOut and the final states equal the eager batched step's
    bit for bit; the decisions of the whole batch are read once per
    batched frame after the bootstrap; the replays count each variant."""
    lefts, rights = frames
    reads = []
    orig = graphed._read_decisions

    def counted(cfg, tracked):
        reads.append(len(tracked))
        return orig(cfg, tracked)

    monkeypatch.setattr(graphed, "_read_decisions", counted)
    bstep = graphed.make_graphed_batched_step(CFG, len(SEQS), "cpu")
    got = _run(bstep, bstep.states, lefts, rights)
    _assert_equal(got, eager_run)
    assert reads == [len(SEQS)] * (T - 1)
    outs = eager_run[0]
    ok = np.array([[bool(o.tracking_ok) for o in row] for row in outs])
    kf = np.array([[bool(o.kf_inserted) for o in row] for row in outs])
    replays = bstep.replays
    assert replays["P"] == T * len(SEQS)
    assert replays["B"] == (T - 1) * len(SEQS)
    assert replays["A_fail"] == int((~ok[1:-1]).sum())
    assert replays["A_ok"] == replays["B"] - replays["A_fail"]
    assert replays["K"] == int(kf[1:].sum()) and replays["K_loop"] == 0
    # the states returned are the steps' live buffers
    assert all(a is s.state for a, s in zip(bstep.states, bstep.steps))


def test_graphed_batched_refuses_a_wrong_batch():
    bstep = graphed.make_graphed_batched_step(CFG, 2, "cpu")
    img = torch.zeros(2, CFG.camera.height, CFG.camera.width)
    with pytest.raises(ValueError):
        bstep(bstep.states[:1], img, img)


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs capture CUDA work")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_batch_of_two_equals_single_graphed_runs(cuda_device):
    """A graphed batch of two (one pool, one side stream for both steps'
    graphs) equals each sequence's single graphed run, bit for bit."""
    seqs = SEQS[:2]
    lefts, rights = _frames(cuda_device, seqs)
    bstep = graphed.make_graphed_batched_step(CFG, len(seqs), cuda_device)
    outs, states = _run(bstep, bstep.states, lefts, rights)
    assert bstep.pool_bytes > 0 and bstep.capture_seconds > 0
    for b in range(len(seqs)):
        step = graphed.make_graphed_step(CFG, cuda_device)
        single = _run(lambda sts, l, r, f: tuple(
            [x] for x in step(sts[0], l[0], r[0], f[0])),
            [step.state], lefts[b:b + 1], rights[b:b + 1])
        _assert_equal(single, ([[row[b]] for row in outs], [states[b]]))
