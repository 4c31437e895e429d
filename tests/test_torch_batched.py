"""The port's batched runner (``engine/runner.run_sequence_batched`` on
``engine/step.make_batched_step``) and ``run_sequence_scan`` against the
JAX reference: B = 3 sequences of the small camera of
tests/test_torch_engine.py, each its own scene and speed along the arc, so
that keyframes fall on different frames (sequence 0 at frame 13, sequence 1
at frame 10, sequence 2 on the bootstrap only).

Batched and single runs of the port make the same operations on the same
inputs, so sequence b of the batch equals the single run of sequence b bit
for bit. Against JAX the tolerances are test_torch_engine.py's end-to-end
ones (float32 chains that part slowly, ROADMAP W7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.engine import runner as jrunner
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu_torch.engine import runner
from stereo_svo_tpu_torch.engine.state import FrameOut, SlamState
from stereo_svo_tpu_torch.eval import ate
from test_torch_engine import CFG, JCFG

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

T = 16
SEQS = ((0, 0.12), (1, 0.16), (2, 0.09))     # (scene seed, dt)
KEYFRAMES = ([0, 13], [0, 10], [0])


@pytest.fixture(scope="module")
def frames():
    seqs = [jsynth.make_sequence(JCFG.camera, T, dt=dt, kind="arc", seed=s)
            for s, dt in SEQS]
    return tuple(np.stack([np.asarray(s[k]) for s in seqs]) for k in range(3))


@pytest.fixture(scope="module")
def reference(frames):
    lefts, rights, _ = frames
    st, out = jax.jit(lambda a, b: jrunner.run_sequence_batched(JCFG, a, b))(
        jnp.asarray(lefts), jnp.asarray(rights))
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def batched(frames):
    lefts, rights, _ = frames
    return runner.run_sequence_batched(CFG, lefts, rights, device="cpu")


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
    """Sequence b of the batch is run_sequence_scan on sequence b alone,
    bit for bit, every output and every state field."""
    states, outs = batched
    lefts, rights, _ = frames
    for b in range(3):
        st, out = runner.run_sequence_scan(CFG, lefts[b], rights[b],
                                           device="cpu")
        for name, a in out._asdict().items():
            assert torch.equal(a, getattr(outs, name)[b]), (b, name)
        for name in ("T_cw", "kf_T_wk", "mem_T_wk", "mu", "status",
                     "feat_uv", "mem_desc", "n_loop_closures"):
            assert torch.equal(getattr(st, name),
                               getattr(states, name)[b]), (b, name)


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
