"""Checkpoints cross the two packages: the port's ``utils/checkpoint``
writes and reads the reference's v2 npz format, key path for key path, and
a resumed port run repeats the uninterrupted one bit for bit.

Configuration: the small camera of tests/test_torch_engine.py. JAX runs on
the CPU, the port with ``device="cpu"``.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.config import SvoConfig as JCfg
from stereo_svo_tpu.engine import step as jstep
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu.utils import checkpoint as jcheckpoint
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import runner, state as state_mod, step
from stereo_svo_tpu_torch.utils import checkpoint

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

CAM_KW = dict(fx=240.0, fy=240.0, cx=188.0, cy=120.0, baseline=0.11,
              width=376, height=240)
CFG_KW = dict(grid_rows=10, grid_cols=13, max_features=130, num_levels=3,
              align_levels=3, klt_levels=3, stereo_max_disp=64,
              kf_min_tracked=40, border_margin=10)
JCFG = JCfg(camera=JCam(**CAM_KW), **CFG_KW)
CFG = SvoConfig(camera=CameraConfig(**CAM_KW), **CFG_KW)
K = 5             # frames before the checkpoint
N_FRAMES = 8


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """K frames of the JAX step, its state saved by the JAX package, and
    the JAX step's output on frame K."""
    lefts, rights, _ = jsynth.make_sequence(JCFG.camera, N_FRAMES, dt=0.12,
                                            kind="arc")
    jitted = jax.jit(jstep.make_step(JCFG))
    st = jstep.init_state(JCFG)
    for l, r in zip(lefts[:K], rights[:K]):
        st, _ = jitted(st, jnp.asarray(l), jnp.asarray(r))
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_state.npz")
    jcheckpoint.save(path, st)
    st_next, out = jitted(st, jnp.asarray(lefts[K]), jnp.asarray(rights[K]))
    return dict(lefts=lefts, rights=rights, path=path, state=st,
                state_next=st_next, out=out)


def test_key_paths_equal_the_reference(reference):
    """Field names give the reference's pytree key paths, in its order."""
    ours = checkpoint.key_paths(state_mod.init_state(CFG, device="cpu"))
    flat = jax.tree_util.tree_flatten_with_path(reference["state"])[0]
    assert ours == [jcheckpoint._path_key(kp) for kp, _ in flat]
    assert ".mu" in ours and ".klt_tmpl.patches" in ours
    with np.load(reference["path"]) as data:
        assert set(data.files) == set(ours) | {"__checkpoint_format__"}
        assert int(data["__checkpoint_format__"]) == 2


def test_reference_checkpoint_loads_and_steps_in_the_port(reference):
    """Save in JAX → load in the port → one port step equals the JAX step
    on the same frame, within test_torch_engine.py's one-frame tolerance
    (float32 rounding of one alignment + refinement chain)."""
    st = checkpoint.load(reference["path"],
                         state_mod.init_state(CFG, device="cpu"))
    ref_np = jax.tree.map(np.asarray, reference["state"])
    for (key, leaf), ref_leaf in zip(checkpoint.flatten(st),
                                     jax.tree.leaves(ref_np)):
        assert leaf.numpy().dtype == ref_leaf.dtype, key
        np.testing.assert_array_equal(leaf.numpy(), ref_leaf, err_msg=key)
    assert st.frame_idx.dtype == torch.int32 and int(st.frame_idx) == K
    assert st.kf_valid.dtype == torch.bool and st.mu.dtype == torch.float32
    _, out, flags = step.make_step(CFG)(
        st, torch.from_numpy(np.array(reference["lefts"][K])),
        torch.from_numpy(np.array(reference["rights"][K])))
    assert flags.tracking_ok == bool(reference["out"].tracking_ok)
    assert bool(out.kf_inserted) == bool(reference["out"].kf_inserted)
    np.testing.assert_allclose(out.T_wc.numpy(),
                               np.asarray(reference["out"].T_wc), atol=5e-5)


def test_port_checkpoint_loads_in_the_reference(reference, tmp_path):
    """Save in the port → load with the JAX package: leaf for leaf equal,
    dtypes kept, and the file byte-compatible in its keys."""
    svo = runner.StereoSvo(CFG, device="cpu")
    for l, r in zip(reference["lefts"][:3], reference["rights"][:3]):
        svo.new_image(l, r)
    path = str(tmp_path / "port_state.npz")
    checkpoint.save(path, svo.state)
    back = jcheckpoint.load(path, jstep.init_state(JCFG))
    ours = state_mod.state_to_numpy(svo.state)
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert len(flat) == len(checkpoint.key_paths(svo.state))
    for kp, leaf in flat:
        names = [p.name for p in kp]
        mine = ours[names[0]] if len(names) == 1 else ours[names[0]][names[1]]
        assert np.asarray(leaf).dtype == mine.dtype, names
        np.testing.assert_array_equal(np.asarray(leaf), mine, err_msg=names)


def test_resume_in_the_port_is_bit_for_bit(reference, tmp_path):
    """Run K frames, save, load into a fresh StereoSvo, continue: the
    continued poses are exactly the uninterrupted run's (the mirror of
    tests/test_engine.py's checkpoint/resume test)."""
    lefts, rights = reference["lefts"], reference["rights"]
    whole = runner.StereoSvo(CFG, device="cpu")
    for l, r in zip(lefts, rights):
        whole.new_image(l, r)
    first = runner.StereoSvo(CFG, device="cpu")
    for l, r in zip(lefts[:K], rights[:K]):
        first.new_image(l, r)
    path = str(tmp_path / "resume.npz")
    checkpoint.save(path, first.state)
    resumed = runner.StereoSvo(CFG, device="cpu")
    resumed.resume(checkpoint.load(path, resumed.state))
    for l, r in zip(lefts[K:], rights[K:]):
        resumed.new_image(l, r)
    np.testing.assert_array_equal(resumed.trajectory(),
                                  whole.trajectory()[K:])
    for (key, a), (_, b) in zip(checkpoint.flatten(resumed.state),
                                checkpoint.flatten(whole.state)):
        assert torch.equal(a, b), key


class _Old(NamedTuple):
    mu: torch.Tensor
    nested: dict


class _New(NamedTuple):
    mu: torch.Tensor
    nested: dict
    extra: torch.Tensor          # field added after the file was written


def _old():
    return _Old(mu=torch.arange(4.0), nested={"a": torch.ones(2, 2)})


def _old_template():
    return _Old(mu=torch.zeros(4), nested={"a": torch.zeros(2, 2)})


def test_missing_key_keeps_the_template_value(tmp_path):
    """The mirror of tests/test_io.py's v2 migration test: a field added
    since the file was written keeps ``like``'s value; dict entries are
    keyed as the reference keys them."""
    p = str(tmp_path / "v2.npz")
    checkpoint.save(p, _old())
    with np.load(p) as data:
        assert set(data.files) == {".mu", ".nested['a']",
                                   "__checkpoint_format__"}
    back = checkpoint.load(p, _old_template())
    assert torch.equal(back.mu, _old().mu)
    assert torch.equal(back.nested["a"], _old().nested["a"])
    tmpl = _New(mu=torch.zeros(4), nested={"a": torch.zeros(2, 2)},
                extra=torch.full((3,), 7.0))
    mig = checkpoint.load(p, tmpl)
    assert torch.equal(mig.mu, _old().mu)
    assert torch.equal(mig.extra, torch.full((3,), 7.0))
    # the reference reads the same file into the same structure
    jback = jcheckpoint.load(p, jax.tree.map(lambda t: t.numpy(),
                                             _old_template()))
    np.testing.assert_array_equal(jback.mu, _old().mu.numpy())


@pytest.mark.parametrize("n_leaves", [2, 1, 3])
def test_v1_index_format_needs_the_same_leaf_count(tmp_path, n_leaves):
    """The v1 ``leaf_{i}`` file loads on an exact match and raises on any
    other leaf count (the reference's fallback has no such check)."""
    leaves = [torch.arange(4.0), torch.ones(2, 2), torch.zeros(1)][:n_leaves]
    p = str(tmp_path / "v1.npz")
    np.savez(p, **{f"leaf_{i}": x.numpy() for i, x in enumerate(leaves)})
    if n_leaves == 2:
        legacy = checkpoint.load(p, _old_template())
        assert torch.equal(legacy.mu, _old().mu)
        assert torch.equal(legacy.nested["a"], _old().nested["a"])
    else:
        with pytest.raises(ValueError, match="leaves"):
            checkpoint.load(p, _old_template())


def test_load_names_its_device(tmp_path):
    p = str(tmp_path / "s.npz")
    checkpoint.save(p, _old())
    assert checkpoint.load(p, _old_template(), device="cpu").mu.device.type \
        == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            checkpoint.load(p, _old_template(), device="cuda")
