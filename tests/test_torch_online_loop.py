"""The port's online loop closure (``engine/step.run_online_loop`` and its
cadence in the step) against the JAX reference, on the rig and the
injected-drift scenario of tests/test_online_loop.py: 376×240, fx 380,
baseline 0.25, a 3-keyframe window, a 12-slot bank, the out-and-back
``loop`` sequence at dt 0.25, and an 8 cm drift injected into the live
state before frame 30.

The state-level tests hand JAX states of one reference run to both
``run_online_loop``s: after frame 30 (the newest keyframe, frame 28, closes
two loop edges and the correction is applied) and after frame 31 (the
correction is in; the next query's correction falls below the
significance floor and the guard keeps the state). The engine test runs the
port's StereoSvo over the same frames. The last three tests mirror the slow
tests of tests/test_online_loop.py and tests/test_organic_loop.py on the
port alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_svo_tpu.engine import runner as jrunner
from stereo_svo_tpu.engine import step as jstep
from stereo_svo_tpu.geometry import se3 as jse3
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu_torch.backend import loop_closure as lc
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import runner, state as state_mod, step
from stereo_svo_tpu_torch.geometry import se3
from stereo_svo_tpu_torch.io import synthetic
from chip_smoke import inject_world_offset
from test_online_loop import CAM as JCAM
from test_online_loop import _inject_world_offset
from test_online_loop import _small_cfg as _jsmall_cfg

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

CAM = CameraConfig(**dataclasses.asdict(JCAM))
N_FRAMES = 40        # the correction lands at frame 31
INJECT_AT = 30
DRIFT = [0.05, 0.02, -0.05, 0.004, -0.006, 0.003]
CHANGED = ("kf_T_wk", "mem_T_wk", "T_cw", "T_pw", "n_loop_closures",
           "last_loop_mem")


def _small_cfg(**kw):
    jcfg = _jsmall_cfg(**kw)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["camera"] = CAM
    return SvoConfig(**fields)


def _drift_torch():
    return se3.exp(torch.tensor(DRIFT, dtype=torch.float32))


def _run_port(cfg, lefts, rights, inject=True):
    """StereoSvo on the CPU over the frames, the drift injected before
    frame INJECT_AT; (trajectory, kf_inserted, n_loop_closures per frame,
    final state)."""
    svo = runner.StereoSvo(cfg, device="cpu")
    loops = []
    for i in range(len(lefts)):
        if inject and i == INJECT_AT:
            svo.state = inject_world_offset(svo.state, _drift_torch())
        svo.new_image(lefts[i], rights[i])
        loops.append(int(svo.state.n_loop_closures))
    return (svo.trajectory(), svo.metrics()["kf_inserted"], np.array(loops),
            svo.state)


@pytest.fixture(scope="module")
def reference_run():
    """The JAX engine with online_loop_every=1 over the frames (drift
    injected before frame 30): frames, GT, states after frames 30 and 31,
    trajectory, keyframe flags and loop counts per frame."""
    lefts, rights, gt = jsynth.make_sequence(JCAM, N_FRAMES, dt=0.25,
                                             kind="loop", seed=0)
    jcfg = _jsmall_cfg(online_loop_every=1)
    svo = jrunner.StereoSvo(jcfg)
    D = jse3.exp(jnp.asarray(DRIFT, jnp.float32))
    states, loops = {}, []
    for i in range(N_FRAMES):
        if i == INJECT_AT:
            svo.state = _inject_world_offset(svo.state, D)
        svo.new_image(lefts[i], rights[i])
        loops.append(int(svo.state.n_loop_closures))
        if i in (30, 31):
            states[i] = jax.tree.map(np.array, svo.state)
    return dict(lefts=np.asarray(lefts), rights=np.asarray(rights),
                gt=np.asarray(gt), states=states, jcfg=jcfg,
                traj=svo.trajectory(),
                kf=np.asarray(svo.metrics()["kf_inserted"]),
                loops=np.array(loops))


@pytest.fixture(scope="module")
def jax_online_loop(reference_run):
    jcfg = reference_run["jcfg"]
    return jax.jit(lambda s: jstep.run_online_loop(jcfg, s))


def _both(reference_run, jax_online_loop, k):
    st_np = reference_run["states"][k]
    ref = jax.tree.map(np.asarray,
                       jax_online_loop(jax.tree.map(jnp.asarray, st_np)))
    cfg = _small_cfg(online_loop_every=1)
    ours = step.run_online_loop(cfg, state_mod.state_from_numpy(
        st_np, device="cpu"))
    return st_np, ref, state_mod.state_to_numpy(ours), cfg


def test_run_online_loop_applies_correction(reference_run, jax_online_loop):
    """After frame 30: two edges accepted and the correction applied, the
    same in both packages, field by field."""
    st_np, ref, ours, _ = _both(reference_run, jax_online_loop, 30)
    assert int(ref.n_loop_closures) == 2
    assert int(ours["n_loop_closures"]) == 2
    assert int(ours["last_loop_mem"]) == int(ref.last_loop_mem) \
        == int(st_np.mem_next)
    moved = np.abs(ref.mem_T_wk - st_np.mem_T_wk).max()
    assert moved > 0.01, moved
    # four thumbnail alignments (20 GN passes each) and 8 pose-graph
    # iterations with the 1e12 gauge pin, in float32, in other orders than
    # XLA's: poses agree to ~1e-5
    for name in ("kf_T_wk", "mem_T_wk", "T_cw", "T_pw"):
        np.testing.assert_allclose(ours[name], getattr(ref, name),
                                   atol=1e-4, err_msg=name)
    # every other field passes through unchanged
    for name in state_mod.SlamState._fields:
        if name not in CHANGED and name not in ("tmpl", "klt_tmpl"):
            np.testing.assert_array_equal(ours[name], getattr(st_np, name),
                                          err_msg=name)


def test_run_online_loop_guard_rejects(reference_run, jax_online_loop):
    """After frame 31: the newest keyframe's query accepts loop edges, but
    the correction they ask for is below the significance floor; both
    packages keep the state bit for bit."""
    st_np, ref, ours, cfg = _both(reference_run, jax_online_loop, 31)
    st = state_mod.state_from_numpy(st_np, device="cpu")
    m_new = st.kf_mem[st.last_kf]
    props = lc.propose_online(cfg, st.mem_desc, st.mem_valid, st.mem_stamp,
                              m_new, st.mem_thumb[m_new])
    meas = lc.measure_edges(cfg, props, st.mem_T_wk, st.mem_thumb, st.mem_uv,
                            st.mem_mask, st.mem_disp, st.mem_dmask)
    assert bool(meas.accept.any()), "the guard, not the gate, rejects"
    for name in CHANGED:
        np.testing.assert_array_equal(ours[name], getattr(st_np, name),
                                      err_msg=name)
        np.testing.assert_array_equal(getattr(ref, name),
                                      getattr(st_np, name), err_msg=name)


def test_engine_online_loop_matches_reference(reference_run):
    """The port's StereoSvo with online_loop_every=1 over the same frames
    and drift: the same keyframes, the same loop closures on the same
    frames, and the same repaired tail."""
    traj, kf, loops, st = _run_port(_small_cfg(online_loop_every=1),
                                    reference_run["lefts"],
                                    reference_run["rights"])
    np.testing.assert_array_equal(kf, reference_run["kf"])
    np.testing.assert_array_equal(loops, reference_run["loops"])
    assert loops[-1] == 2
    gt = reference_run["gt"]
    err = np.linalg.norm(traj[:, :, 3] - gt[:, :, 3], axis=1)
    ref_err = np.linalg.norm(reference_run["traj"][:, :, 3] - gt[:, :, 3],
                             axis=1)
    # per-frame poses part by up to ~2e-3 m mid-run (float32 chaos, W7)
    # and come back together after the correction
    assert abs(err[-5:].mean() - ref_err[-5:].mean()) < 1e-3, (
        err[-5:].mean(), ref_err[-5:].mean())
    assert bool(torch.all(torch.isfinite(st.T_cw)))


def _port_sequence(n, dt, kind, seed):
    lefts, rights, gt = synthetic.make_sequence(CAM, n, dt=dt, kind=kind,
                                                seed=seed, device="cpu")
    return lefts.numpy(), rights.numpy(), gt.numpy()


@pytest.mark.slow
def test_online_loop_repairs_injected_drift_at_revisit():
    """tests/test_online_loop.py's test on the port: 60 frames, the drift
    injected at frame 30; the online run repairs the tail, the control
    stays drifted."""
    n = 60
    lefts, rights, gt = _port_sequence(n, 0.25, "loop", 0)
    inj_t = float(torch.linalg.vector_norm(se3.translation(_drift_torch())))
    results = {}
    for every in (1, 0):
        traj, _, loops, st = _run_port(_small_cfg(online_loop_every=every),
                                       lefts, rights)
        results[every] = (np.linalg.norm(traj[:, :, 3] - gt[:, :, 3],
                                         axis=1), loops, st)
    err_on, loops_on, st_on = results[1]
    err_off, loops_off, _ = results[0]
    assert err_off[30] > 0.6 * inj_t, err_off[30]
    assert err_on[30] > 0.4 * inj_t, err_on[30]
    assert err_off[-5:].mean() > 0.5 * inj_t, err_off[-5:]
    assert loops_on[-1] >= 1 and loops_off[-1] == 0
    assert err_on[-5:].mean() < 0.75 * err_off[-5:].mean()
    assert err_on[-5:].mean() < 0.65 * inj_t, err_on[-5:].mean()
    assert bool(torch.all(torch.isfinite(st_on.T_cw)))


@pytest.mark.slow
def test_online_loop_noop_without_revisit():
    """A forward-only sequence: no spurious correction on the port."""
    n = 30
    lefts, rights, gt = _port_sequence(n, 0.1, "arc", 1)
    trajs = {}
    for every in (1, 0):
        traj, _, loops, _ = _run_port(
            _small_cfg(online_loop_every=every, loop_min_gap=8), lefts,
            rights, inject=False)
        trajs[every] = (traj, loops[-1])
    (t_on, n_edges), (t_off, _) = trajs[1], trajs[0]
    if n_edges == 0:
        np.testing.assert_array_equal(t_on, t_off)
    else:
        err_on = np.linalg.norm(t_on[:, :, 3] - gt[:, :, 3], axis=1).max()
        err_off = np.linalg.norm(t_off[:, :, 3] - gt[:, :, 3], axis=1).max()
        assert err_on < max(2.0 * err_off, 0.02), (err_on, err_off)


@pytest.mark.slow
def test_online_loop_repairs_organic_drift_no_injection():
    """tests/test_organic_loop.py on the port: the loop_far out-and-back on
    a starved 48-slot budget drifts organically; the online path fires at
    the revisit and the live error drops across the correction."""
    cfg_kw = dict(grid_rows=6, grid_cols=8, max_features=48,
                  kf_min_tracked=16, loop_min_score=0.7)
    n = 60
    lefts, rights, gt = _port_sequence(n, 0.25, "loop_far", 0)
    results = {}
    for every in (0, 1):
        traj, _, loops, st = _run_port(
            _small_cfg(online_loop_every=every, **cfg_kw), lefts, rights,
            inject=False)
        results[every] = (np.linalg.norm(traj[:, :, 3] - gt[:, :, 3],
                                         axis=1), loops, st)
    err_off, loops_off, _ = results[0]
    err_on, loops_on, st_on = results[1]
    fires = np.where(np.diff(loops_on) > 0)[0] + 1
    assert loops_off[-1] == 0
    assert err_off[-5:].mean() > 0.25, err_off[-5:]
    assert len(fires) >= 1, "no online loop correction ever fired"
    f = int(fires[0])
    assert err_on[f - 1] > 0.1, err_on[f - 1]
    assert err_on[min(f + 2, n - 1)] < 0.5 * err_on[f - 1]
    assert err_on[-5:].mean() < 0.5 * err_off[-5:].mean()
    assert bool(torch.all(torch.isfinite(st_on.T_cw)))
