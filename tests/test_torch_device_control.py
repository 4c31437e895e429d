"""The frame's branches as device tensors (``engine/step.device_flags``,
``device_decisions`` and their batched forms) and the frame graph that
branches on them (``engine/graphed.py``).

On the CPU: the device flags and decisions equal the host's reads of the
same states (``host_flags``, ``host_flags_batched``, ``_read_decisions``,
``loop_due``) and the reference's online-loop cond
(``stereo_svo_tpu/engine/step.py`` ``kf_phase``) on states around the
online loop's cadence and cooldown edges, one sequence's and a batch's;
the batch's conds equal the eager batched step's choices.

The ``cuda`` tests (skipped without a card) run the graphed step and the
graphed batched step under ``torch.cuda.set_sync_debug_mode("error")``
from the first frame, the bootstrap included, to the last; find no
memory-allocation, memory-free, host or event node in any body; and show
that the step raises where conditional nodes are unavailable. On the
card's machine, which has no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_device_control.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stereo_svo_tpu_torch.engine import graphed, runner
from stereo_svo_tpu_torch.engine import step as step_mod
from stereo_svo_tpu_torch.engine.state import FrameOut, init_state
from stereo_svo_tpu_torch.ops.kernels import _build
from test_torch_graphed import BLACK, CFG, LOOP_CFG, _frames

try:
    import jax.numpy as jnp
except ImportError:    # the card's machine: only the ``cuda`` tests run
    jnp = None

torch.set_num_threads(1)

# the online loop every 3rd keyframe created, 2 keyframes of cooldown
CADENCE_CFG = dataclasses.replace(LOOP_CFG, online_loop_every=3,
                                  online_loop_cooldown=2)
# (mem_next, last_loop_mem): the keyframe about to be inserted is the
# mem_next + 1-th; around every cadence edge (n % 3 in {2, 0, 1}) and the
# cooldown edge (n - last in {2, 3})
COUNTS = [(1, 0), (2, 0), (3, 0), (4, 0), (5, 3), (5, 4), (8, 6), (8, 5),
          (11, 9), (11, 8), (0, 0)]
DECISIONS = [(need_kf, ok) for need_kf in (False, True)
             for ok in (False, True)]


def _state(cfg, mem_next=0, last_loop_mem=0, booted=True, ok=True):
    st = init_state(cfg, "cpu")
    kf_valid = torch.zeros_like(st.kf_valid)
    kf_valid[1] = booted
    i32 = torch.int32
    return st._replace(kf_valid=kf_valid,
                       tracking_ok=torch.tensor(ok),
                       mem_next=torch.tensor(mem_next, dtype=i32),
                       last_loop_mem=torch.tensor(last_loop_mem, dtype=i32))


def _ctx(need_kf: bool, ok: bool):
    z = torch.zeros(())
    return step_mod.TrackCtx(*([z] * len(step_mod.TrackCtx._fields)))._replace(
        need_kf=torch.tensor(need_kf), ok=torch.tensor(ok))


def _stack(trees):
    return graphed._tree(trees[0], iter([
        torch.stack(xs) for xs in zip(*map(graphed._leaves, trees))]))


@pytest.mark.parametrize("booted", [False, True])
@pytest.mark.parametrize("ok", [False, True])
def test_device_flags_equal_host_flags(booted, ok):
    st = _state(CFG, booted=booted, ok=ok)
    got = tuple(bool(x) for x in step_mod.device_flags(st))
    assert got == tuple(step_mod.host_flags(st)) == (booted, ok)


@pytest.mark.parametrize("cfg", [CFG, CADENCE_CFG],
                         ids=["loop_off", "every3_cooldown2"])
@pytest.mark.parametrize("counts", COUNTS, ids=str)
@pytest.mark.parametrize("need_kf,ok", DECISIONS)
def test_device_decisions_equal_the_host_read(cfg, counts, need_kf, ok):
    """(need_kf, ok, run_loop) on the device equal the host's read of the
    same tracked state and TrackCtx, and run_loop equals ``need_kf and
    loop_due`` of the host's counters."""
    st, ctx = _state(cfg, *counts), _ctx(need_kf, ok)
    got = tuple(bool(x) for x in step_mod.device_decisions(cfg, st, ctx))
    (host,) = step_mod._read_decisions(cfg, st, ctx)
    assert got == host
    assert got[2] == bool(need_kf and step_mod.loop_due(cfg, *counts))


@pytest.mark.skipif(jnp is None, reason="needs the JAX package")
@pytest.mark.parametrize("counts", COUNTS, ids=str)
def test_run_loop_equals_the_reference_cond(counts):
    """The reference decides after the insertion, on the bank's counters
    then (``kf_phase``'s ``do``); the port before it: the same keyframes."""
    cfg = CADENCE_CFG
    mem_next, last = counts
    n = jnp.int32(mem_next + 1)         # keyframe.insert's mem_next + 1
    ref = bool(((n % cfg.online_loop_every) == 0)
               & (n - last > cfg.online_loop_cooldown))
    st = _state(cfg, *counts)
    got = step_mod.device_decisions(cfg, st, _ctx(True, True))[2]
    assert bool(got) == ref


def test_batched_flags_and_decisions_equal_the_eager_batch_choices():
    """Per sequence the batched forms equal the single ones; the batch's
    conds equal the eager batched step's choices from the host's reads:
    a bootstrap when a sequence has no keyframe, the rotated variants when
    a booted sequence failed, a keyframe phase (with the online loop) when
    a booted sequence needs one (and the loop is due in one)."""
    cfg = CADENCE_CFG
    rng = np.random.default_rng(0)
    for _ in range(40):
        n = int(rng.integers(1, 5))
        rows = [dict(booted=bool(rng.integers(2)), ok=bool(rng.integers(2)),
                     counts=COUNTS[int(rng.integers(len(COUNTS)))],
                     need_kf=bool(rng.integers(2)))
                for _ in range(n)]
        sts = _stack([_state(cfg, *r["counts"], booted=r["booted"],
                             ok=r["ok"]) for r in rows])
        ctx = _stack([_ctx(r["need_kf"], r["ok"]) for r in rows])
        booted, prev_ok, any_boot, any_failed = \
            step_mod.device_flags_batched(sts)
        flags = step_mod.host_flags_batched(sts)
        assert booted.tolist() == [f.booted for f in flags]
        assert prev_ok.tolist() == [f.tracking_ok for f in flags]
        assert bool(any_boot) == (not all(f.booted for f in flags))
        assert bool(any_failed) == (not all(
            f.tracking_ok for f in flags if f.booted))
        need_kf, ok, run_loop, any_kf, any_loop = \
            step_mod.device_decisions_batched(cfg, sts, ctx, booted)
        host = step_mod._read_decisions(cfg, sts, ctx)
        assert list(zip(need_kf.tolist(), ok.tolist(),
                        run_loop.tolist())) == host
        ours = [d for d, f in zip(host, flags) if f.booted]
        assert bool(any_kf) == any(d[0] for d in ours)
        assert bool(any_loop) == any(d[2] for d in ours)


def test_the_plan_reads_each_predicate_after_it_is_written():
    """In the frame graph, every IF node comes after the set node of its
    handle, and that after the body that writes its predicate: ``flags``
    for the bootstrap, track and B bodies, the track bodies for K and
    K_loop."""
    for step in (graphed.make_graphed_step(LOOP_CFG, "cpu"),
                 graphed.make_graphed_batched_step(LOOP_CFG, 2, "cpu")):
        plan = step._plan
        where = {arg: i for i, (op, arg) in enumerate(plan) if op != "set"}
        for i, (op, arg) in enumerate(plan):
            if op != "set":
                continue
            writer = "A_ok" if "K" in arg else "flags"
            assert where[writer] < i
            assert all(where[b] > i for b in arg)
        ifs = [arg for op, arg in plan if op == "if"]
        assert sorted(ifs) == sorted(step._preds)
        assert [arg for op, arg in plan if op == "run"] == ["P", "flags"]


def test_stereo_svo_reads_tracking_ok_from_the_device():
    """``StereoSvo.tracking_ok`` is the live state's flag: False after a
    blacked-out frame, True again after a recovered one."""
    lefts, rights, _ = _frames()
    svo = runner.StereoSvo(CFG, device="cpu")
    seen = []
    for i in range(BLACK[-1] + 2):
        svo.new_image(lefts[i], rights[i])
        seen.append(svo.tracking_ok)
    assert seen == [i not in BLACK for i in range(len(seen))]


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the frame graph is CUDA work")
    return torch.device("cuda")


@pytest.mark.cuda
def test_frames_make_no_host_sync(cuda_device):
    """Every frame, the bootstrap, the blackout and keyframe frames with
    the online loop included, is one launch with no host sync: the graphed
    step and the graphed batched step under sync debug mode "error"."""
    lefts, rights, _ = _frames(cuda_device)
    step = graphed.make_graphed_step(LOOP_CFG, cuda_device)
    bstep = graphed.make_graphed_batched_step(LOOP_CFG, 2, cuda_device)
    outs = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(len(lefts)):
            _, out = step(step.state, lefts[i], rights[i])
            outs.append(out.tracking_ok.clone())
            bstep(bstep.state, torch.stack([lefts[i], lefts[i]]),
                  torch.stack([rights[i], rights[i]]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ok = torch.stack(outs).cpu().numpy()
    assert ok.tolist() == [i not in BLACK for i in range(len(lefts))]
    runs = step.replays
    assert runs["boot"] == 1 and runs["K_loop"] >= 1
    assert runs["A_fail"] == len(BLACK)
    assert bstep.replays["boot"] == 1


@pytest.mark.cuda
def test_no_body_holds_a_barred_node(cuda_device):
    """No body of either step holds a node a conditional body may not
    (capture raises otherwise): no memory allocation or free, host or
    event node; the frame graph holds one IF node per conditional body."""
    for step in (graphed.make_graphed_step(LOOP_CFG, cuda_device),
                 graphed.make_graphed_batched_step(LOOP_CFG, 2,
                                                   cuda_device)):
        for name, kinds in step.nodes.items():
            assert not {k: n for k, n in kinds.items()
                        if k in graphed.NOT_IN_A_BODY and n}, name
        assert step.nodes["F"]["conditional"] == len(step._preds)
        assert step.nodes["F"]["graph"] == 2           # P and flags


@pytest.mark.cuda
def test_the_step_raises_without_conditional_nodes(cuda_device,
                                                   monkeypatch):
    """A card or CUDA version that refuses conditional handles makes the
    step raise: no fallback to replays branched on the host."""
    lib = _build.load_library()
    monkeypatch.setattr(lib, "svo_graph_cond_handle",
                        lambda *args: 801)      # cudaErrorNotSupported
    with pytest.raises(RuntimeError, match="conditional nodes"):
        graphed.make_graphed_step(CFG, cuda_device)


@pytest.mark.cuda
def test_run_sequence_scan_equals_the_eager_step_on_the_card(cuda_device):
    """run_sequence_scan (one launch a frame, its FrameOut copied into row
    t on the device) against the eager step: bit for bit."""
    lefts, rights, _ = _frames(cuda_device)
    _, outs = runner.run_sequence_scan(CFG, lefts, rights,
                                       device=cuda_device)
    eager = step_mod.make_step(CFG)
    st = init_state(CFG, cuda_device)
    for i in range(len(lefts)):
        st, out, _ = eager(st, lefts[i], rights[i])
        for name, x in zip(FrameOut._fields, out):
            assert torch.equal(getattr(outs, name)[i], x), (i, name)
