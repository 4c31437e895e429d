"""The port's batched runner (``engine/runner.run_sequence_batched``: the
graphed batched step, on the CPU its ``vmap``ped bodies) and
``run_sequence_scan`` against the JAX reference: B = 3 sequences of the
small camera of tests/test_torch_engine.py, each its own scene and speed
along the arc, so that keyframes fall on different frames (sequence 0 at
frame 13, sequence 1 at frame 10, sequence 2 on the bootstrap only).

Each phase of the batched step runs once over the stacked batch, so its
reductions and linear algebra sum in another order than a single run's:
sequence b of the batch makes the single run's decisions (flags equal on
every frame), its poses within float32 summation order. Against JAX the
tolerances are test_torch_engine.py's end-to-end ones (float32 chains that
part slowly, ROADMAP W7). Two more batches run against the JAX batched
step: one in which a sequence blacks out (the failed-frame variant kept
for that sequence alone) and one in which the online loop is due in one
sequence at a time.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.engine import runner as jrunner
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu_torch.engine import runner
from stereo_svo_tpu_torch.engine import step as step_mod
from stereo_svo_tpu_torch.engine.state import FrameOut, SlamState
from stereo_svo_tpu_torch.eval import ate
from test_torch_engine import CFG, JCFG

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

T = 16
SEQS = ((0, 0.12), (1, 0.16), (2, 0.09))     # (scene seed, dt)
KEYFRAMES = ([0, 13], [0, 10], [0])
BLACK = {0: (6, 7)}          # sequence: blacked-out frames
# the online loop at every keyframe: due in sequence 1 on frame 10 and in
# sequence 0 on frame 13, never in both
LOOP_KNOBS = dict(online_loop_every=1, online_loop_cooldown=0,
                  mem_keyframes=12)


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    """A per-sample fallback of ``vmap`` is an error in these tests."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@pytest.fixture(scope="module")
def frames():
    seqs = [jsynth.make_sequence(JCFG.camera, T, dt=dt, kind="arc", seed=s)
            for s, dt in SEQS]
    return tuple(np.stack([np.asarray(s[k]) for s in seqs]) for k in range(3))


@pytest.fixture(scope="module")
def jax_batched():
    """The JAX batched runner, jitted once for JCFG: every batch of these
    tests has the same shapes."""
    return jax.jit(lambda a, b: jrunner.run_sequence_batched(JCFG, a, b))


def _reference(run, lefts, rights):
    _, out = run(jnp.asarray(lefts), jnp.asarray(rights))
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def reference(frames, jax_batched):
    return _reference(jax_batched, *frames[:2])


@pytest.fixture(scope="module")
def batched(frames):
    lefts, rights, _ = frames
    return runner.run_sequence_batched(CFG, lefts, rights, device="cpu")


def _flags_equal(outs, ref):
    np.testing.assert_array_equal(outs.tracking_ok.numpy(), ref.tracking_ok)
    np.testing.assert_array_equal(outs.kf_inserted.numpy(), ref.kf_inserted)


def test_batched_shapes(batched):
    states, outs = batched
    assert isinstance(states, SlamState) and isinstance(outs, FrameOut)
    assert outs.T_wc.shape == (3, T, 3, 4)
    assert outs.kf_inserted.shape == (3, T)
    assert states.kf_T_wk.shape == (3, CFG.max_keyframes, 3, 4)
    assert states.tmpl.patches.shape[0] == 3
    assert states.frame_idx.tolist() == [T] * 3


def test_batched_matches_reference(batched, reference, frames):
    """Per sequence: the reference's keyframes (on different frames), full
    tracking, and short-horizon pose agreement."""
    _, outs = batched
    gt = frames[2]
    kf = outs.kf_inserted.numpy()
    np.testing.assert_array_equal(kf, reference.kf_inserted)
    for b in range(3):
        assert np.nonzero(kf[b])[0].tolist() == KEYFRAMES[b]
    assert outs.tracking_ok.all()
    traj = outs.T_wc.numpy()
    for b in range(3):
        pos_err = np.linalg.norm(traj[b, :, :, 3]
                                 - reference.T_wc[b, :, :, 3], axis=-1)
        assert pos_err[:8].max() < 2e-4, (b, pos_err)
        assert pos_err.max() < 2e-3, (b, pos_err)
        err = ate.ate_rmse(ate.positions(traj[b]), ate.positions(gt[b]))
        assert err < 0.02, (b, err)


def test_batched_equals_single_runs(batched, frames):
    """Sequence b of the batch against run_sequence_scan on sequence b
    alone: the same tracking and keyframe flags on every frame, the same
    keyframe count in the state, poses within 2e-4 m over the first 8
    frames and 2e-3 m over all (the batch's sums in another float32
    order, ROADMAP W7)."""
    states, outs = batched
    lefts, rights, _ = frames
    for b in range(3):
        st, out = runner.run_sequence_scan(CFG, lefts[b], rights[b],
                                           device="cpu")
        for name in ("tracking_ok", "kf_inserted"):
            assert torch.equal(getattr(out, name),
                               getattr(outs, name)[b]), (b, name)
        for name in ("kf_valid", "mem_valid", "kf_next", "mem_next",
                     "n_loop_closures"):
            assert torch.equal(getattr(st, name),
                               getattr(states, name)[b]), (b, name)
        err = (out.T_wc[:, :, 3] - outs.T_wc[b, :, :, 3]).norm(dim=-1)
        assert float(err[:8].max()) < 2e-4, (b, err)
        assert float(err.max()) < 2e-3, (b, err)
        assert float((st.T_cw - states.T_cw[b]).abs().max()) < 2e-3


def test_scan_runner_equals_stereo_svo(frames):
    """run_sequence_scan and StereoSvo make the same steps: the same
    trajectory bit for bit."""
    lefts, rights, _ = frames
    _, out = runner.run_sequence_scan(CFG, lefts[1], rights[1], device="cpu")
    traj, metrics = runner.run_sequence(CFG, lefts[1], rights[1],
                                        device="cpu")
    np.testing.assert_array_equal(out.T_wc.numpy(), traj)
    np.testing.assert_array_equal(out.kf_inserted.numpy(),
                                  metrics["kf_inserted"])


def test_batched_blackout_matches_reference(frames, jax_batched):
    """Sequence 0 blacks out on two frames and recovers on the next: the
    batch's failed-frame variant (the rotated relocalisation variants, the
    relocalisation anchor) is kept for it alone. Every sequence's tracking
    and keyframe flags equal the JAX batched step's on every frame; the
    others track throughout."""
    lefts, rights, gt = (x.copy() for x in frames)
    for b, black in BLACK.items():
        lefts[b, list(black)] = 0.0
        rights[b, list(black)] = 0.0
    ref = _reference(jax_batched, lefts, rights)
    _, outs = runner.run_sequence_batched(CFG, lefts, rights, device="cpu")
    _flags_equal(outs, ref)
    ok = outs.tracking_ok.numpy()
    assert np.nonzero(~ok[0])[0].tolist() == list(BLACK[0])
    assert ok[1].all() and ok[2].all()
    traj = outs.T_wc.numpy()
    for b in (1, 2):
        err = ate.ate_rmse(ate.positions(traj[b]), ate.positions(gt[b]))
        assert err < 0.02, (b, err)


def test_batched_online_loop_matches_reference(frames, monkeypatch):
    """With the online loop on, it is due in sequence 1 on frame 10 and in
    sequence 0 on frame 13: the batch runs it (once for the whole batch, on
    those two frames only) and keeps it where due. Keyframes, loop
    closures and tracking equal the JAX batched step's on every frame."""
    lefts, rights, _ = frames
    jcfg = dataclasses.replace(JCFG, **LOOP_KNOBS)
    cfg = dataclasses.replace(CFG, **LOOP_KNOBS)
    jst, jout = jax.jit(lambda a, b: jrunner.run_sequence_batched(
        jcfg, a, b))(jnp.asarray(lefts), jnp.asarray(rights))
    ref = jax.tree.map(np.asarray, jout)
    calls = []
    loop = step_mod.run_online_loop

    def counted(*args):
        calls.append(1)
        return loop(*args)

    monkeypatch.setattr(step_mod, "run_online_loop", counted)
    st, outs = runner.run_sequence_batched(cfg, lefts, rights, device="cpu")
    assert len(calls) == 2
    _flags_equal(outs, ref)
    kf = outs.kf_inserted.numpy()
    for b in range(3):
        assert np.nonzero(kf[b])[0].tolist() == KEYFRAMES[b]
    np.testing.assert_array_equal(st.n_loop_closures.numpy(),
                                  np.asarray(jst.n_loop_closures))
    np.testing.assert_array_equal(st.last_loop_mem.numpy(),
                                  np.asarray(jst.last_loop_mem))
    err = np.linalg.norm(outs.T_wc.numpy()[..., 3] - ref.T_wc[..., 3],
                         axis=-1)
    assert err.max() < 2e-3, err
