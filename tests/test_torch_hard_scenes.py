"""The port on the reference's hard scenes, against the JAX package frame
by frame: mirrors of tests/test_synthetic_hard.py's end-to-end tests — the
cluttered scene of spheres (:78), the sustained in-plane spin (:136), the
moving object the outlier gates must reject (:150), motion blur (:164) and
the photometric perturbation (:177).

Both packages see the same frames, the JAX renderer's (for the
perturbation, JAX's perturbed frames: the two packages draw noise from
different generators), at the reference tests' rig: 376×240, 130 slots, 3
levels, 30 frames at dt 0.12, seed 0. JAX runs on the CPU through one
jitted step shared by the five scenes (one compile), the port with
``device="cpu"``. Held per scene:

- ``tracking_ok`` and the keyframe flag equal on every frame;
- poses within 2e-4 m, the short-horizon tolerance of
  tests/test_torch_engine.py and tests/test_torch_tracking_loss.py, and the
  per-frame tracked, landmark and seed counts within 2 (in the dynamic
  scene these show whether the kill gates reject the same features);
- the reference's own gates on both runs: tracking ≥ 0.97, ATE below
  0.03 m (clutter, spin, perturbation) or 0.035 m (moving object, blur).

The slow case renders the four deterministic scenes with the port's own
renderer (``device="cpu"``) and holds the port's run on them to the JAX run
on JAX's frames: keyframe frames equal and ATE within 5 mm — the comparison
chip_smoke.py's phase 13 makes on the card, where frames are rendered on
the device.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from stereo_svo_tpu.config import CameraConfig as JCam
from stereo_svo_tpu.config import SvoConfig as JCfg
from stereo_svo_tpu.engine import runner as jrunner
from stereo_svo_tpu.eval import ate as jate
from stereo_svo_tpu.io import synthetic as jsynth
from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig
from stereo_svo_tpu_torch.engine import runner
from stereo_svo_tpu_torch.eval import ate
from stereo_svo_tpu_torch.io import synthetic

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

CAM_KW = chip_smoke.HARD_CAM
CFG_KW = chip_smoke.HARD_CFG
POSE_ATOL = 2e-4
COUNT_ATOL = 2
SCENES = chip_smoke.HARD_SCENES          # name → make_sequence keywords
ATE_GATES = chip_smoke.HARD_ATE_GATES    # name → the reference's gate (m)


@pytest.fixture(scope="module")
def jax_svo():
    """A fresh JAX StereoSvo for each run, all on one jitted step (the
    five scenes share one configuration: one compile)."""
    jcfg = JCfg(camera=JCam(**CAM_KW), **CFG_KW)
    first = jrunner.StereoSvo(jcfg)

    def make():
        svo = jrunner.StereoSvo(jcfg)
        svo._step = first._step
        return svo
    return make


def _frames(name):
    return jsynth.make_sequence(JCam(**CAM_KW), chip_smoke.HARD_FRAMES,
                                dt=chip_smoke.HARD_DT, seed=chip_smoke.SEED,
                                **SCENES[name])


def _run(svo, lefts, rights):
    for left, right in zip(lefts, rights):
        svo.new_image(left, right)
    return np.asarray(svo.trajectory()), {
        k: np.asarray(v) for k, v in svo.metrics().items()}


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request, jax_svo):
    name = request.param
    lefts, rights, gt = _frames(name)
    jtraj, jm = _run(jax_svo(), lefts, rights)
    cfg = SvoConfig(camera=CameraConfig(**CAM_KW), **CFG_KW)
    traj, m = _run(runner.StereoSvo(cfg, device="cpu"), lefts, rights)
    return dict(name=name, gt=np.asarray(gt), jtraj=jtraj, jm=jm, traj=traj,
                m=m)


def test_decisions_equal_the_reference(scene):
    for key in ("tracking_ok", "kf_inserted"):
        np.testing.assert_array_equal(scene["m"][key], scene["jm"][key],
                                      err_msg=f"{scene['name']}: {key}")


def test_poses_and_counts_follow_the_reference(scene):
    traj, jtraj = scene["traj"], scene["jtraj"]
    assert np.isfinite(traj).all()
    err = np.linalg.norm(traj[:, :, 3] - jtraj[:, :, 3], axis=1)
    assert err.max() < POSE_ATOL, (scene["name"], err.max(),
                                   int(err.argmax()))
    np.testing.assert_allclose(traj, jtraj, atol=POSE_ATOL)
    for key in ("n_tracked", "n_landmarks", "n_seeds"):
        diff = np.abs(scene["m"][key].astype(int)
                      - scene["jm"][key].astype(int))
        assert diff.max() <= COUNT_ATOL, (scene["name"], key, diff.max(),
                                          int(diff.argmax()))


def test_both_meet_the_reference_gates(scene):
    gt = scene["gt"]
    for who, traj, m in (("port", scene["traj"], scene["m"]),
                         ("jax", scene["jtraj"], scene["jm"])):
        ok = m["tracking_ok"]
        assert ok.mean() >= chip_smoke.HARD_TRACK_GATE, (
            who, scene["name"], np.nonzero(~ok)[0])
        err = ate.ate_rmse(ate.positions(traj), ate.positions(gt))
        assert err < ATE_GATES[scene["name"]], (who, scene["name"], err)


def test_a_reset_graphed_step_replays_a_fresh_one():
    """chip_smoke.py's phase 13 runs the scenes of a configuration on one
    graphed step, reset between runs (``shared_steps``): after another
    sequence ran on it, a run equals the run of a fresh step bit for bit."""
    cfg = SvoConfig(camera=CameraConfig(**CAM_KW), **CFG_KW)
    seqs = [synthetic.make_sequence(cfg.camera, n, dt=chip_smoke.HARD_DT,
                                    seed=chip_smoke.SEED, device="cpu",
                                    **kw)
            for kw, n in ((dict(kind="arc"), 14), (SCENES["spin"], 26))]
    with chip_smoke.shared_steps() as steps:
        for lefts, rights, _ in seqs:
            traj, m = _run(runner.StereoSvo(cfg, device="cpu"), lefts,
                           rights)
    assert len(steps) == 1
    fresh_traj, fresh_m = _run(runner.StereoSvo(cfg, device="cpu"),
                               *seqs[-1][:2])
    assert m["kf_inserted"][1:].any()      # a keyframe phase after the reset
    np.testing.assert_array_equal(traj, fresh_traj)
    for key in fresh_m:
        np.testing.assert_array_equal(m[key], fresh_m[key], err_msg=key)


@pytest.mark.slow  # four more port renders and runs beside the quick cases
@pytest.mark.parametrize("name", [n for n in SCENES if n != "perturb"])
def test_port_renderer_against_the_reference(name, jax_svo):
    """The port's frames (its renderer on the CPU) through the port against
    the JAX run on JAX's frames: the same keyframe frames and ATE within
    chip_smoke.LOOP_TOL_M — what phase 13 holds the card to."""
    jl, jr, jgt = _frames(name)
    jtraj, jm = _run(jax_svo(), jl, jr)
    cfg = SvoConfig(camera=CameraConfig(**CAM_KW), **CFG_KW)
    lefts, rights, gt = synthetic.make_sequence(
        cfg.camera, chip_smoke.HARD_FRAMES, dt=chip_smoke.HARD_DT,
        seed=chip_smoke.SEED, device="cpu", **SCENES[name])
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), atol=1e-5)
    traj, m = _run(runner.StereoSvo(cfg, device="cpu"), lefts, rights)
    assert m["tracking_ok"].mean() >= chip_smoke.HARD_TRACK_GATE
    assert (np.nonzero(m["kf_inserted"])[0].tolist()
            == np.nonzero(jm["kf_inserted"])[0].tolist())
    err = ate.ate_rmse(ate.positions(traj), ate.positions(np.asarray(jgt)))
    jerr = jate.ate_rmse(jate.positions(jtraj), jate.positions(jgt))
    assert abs(err - jerr) <= chip_smoke.LOOP_TOL_M, (name, err, jerr)
