"""Full ingest through the port's command-line app: PNGs on disk in the
EuRoC and KITTI layouts → the readers (Python and native) → calibration
(``sensor.yaml`` and rectification, or the flat file) → the engine → the TUM
export → the ATE gate. Mirror of tests/test_full_ingest.py:103, 120, 175
and 189, with ``--device cpu``.

The sequence is the reference's: the 24-frame arc at the 376×240 rig
(dt 0.1, seed 0), here rendered by the port's renderer on the CPU and
written with OpenCV, with the reference's ``FLAT_CALIB``, ``SENSOR_YAML``
and ``KITTI_FLAT_CALIB``. Held, as there: the summary's ``frames`` is 24
and ``tracking_ok_frac`` 1.0, the TUM file has 24 lines, ATE below 0.05 m.
The native-loader cases skip only where the reference's do: the loader is
neither built nor buildable. The slow cases run the JAX package's CLI on
the same PNGs and hold both runs equal in frames, keyframes and tracking,
with ATE within 1e-3 m (as tests/test_torch_cli.py does for the synthetic
dataset).
"""

import json

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("yaml")

from stereo_svo_tpu_torch import cli
from stereo_svo_tpu_torch.config import CameraConfig
from stereo_svo_tpu_torch.eval import ate
from stereo_svo_tpu_torch.io import native_loader, synthetic, trajectory

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)

CAM = CameraConfig(fx=240.0, fy=240.0, cx=188.0, cy=120.0,
                   baseline=0.11, width=376, height=240)
N_FRAMES = 24
ATE_GATE_M = 0.05

FLAT_CALIB = """
grid_rows: 10
grid_cols: 13
max_features: 130
num_levels: 3
align_levels: 3
klt_levels: 3
stereo_max_disp: 64
kf_min_tracked: 40
border_margin: 10
"""

SENSOR_YAML = """\
sensor_type: camera
T_BS:
  rows: 4
  cols: 4
  data: [1.0, 0.0, 0.0, {tx}, 0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]
rate_hz: 20
resolution: [{w}, {h}]
camera_model: pinhole
intrinsics: [{fx}, {fy}, {cx}, {cy}]
distortion_model: radial-tangential
distortion_coefficients: [0.0, 0.0, 0.0, 0.0]
"""

KITTI_FLAT_CALIB = FLAT_CALIB + f"""
fx: {CAM.fx}
fy: {CAM.fy}
cx: {CAM.cx}
cy: {CAM.cy}
baseline: {CAM.baseline}
width: {CAM.width}
height: {CAM.height}
"""


@pytest.fixture(scope="module")
def rendered():
    lefts, rights, gt = synthetic.make_sequence(CAM, N_FRAMES, dt=0.1,
                                                kind="arc", seed=0,
                                                device="cpu")
    return lefts.numpy(), rights.numpy(), gt.numpy()


def _png(path, img):
    cv2.imwrite(str(path), np.clip(img, 0, 255).astype(np.uint8))


def _write_euroc(root, lefts, rights):
    for side, imgs in (("cam0", lefts), ("cam1", rights)):
        d = root / "mav0" / side / "data"
        d.mkdir(parents=True)
        rows = []
        for i, img in enumerate(imgs):
            ts = 1403636579763555584 + i * 50_000_000  # EuRoC-style ns
            _png(d / f"{ts}.png", img)
            rows.append(f"{ts},{ts}.png\n")
        with open(root / "mav0" / side / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n")
            f.writelines(rows)
        (root / "mav0" / side / "sensor.yaml").write_text(SENSOR_YAML.format(
            tx=0.0 if side == "cam0" else CAM.baseline, w=CAM.width,
            h=CAM.height, fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy))
    return ["--dataset", "euroc", "--root", str(root),
            "--cam0-yaml", str(root / "mav0" / "cam0" / "sensor.yaml"),
            "--cam1-yaml", str(root / "mav0" / "cam1" / "sensor.yaml")]


def _write_kitti(root, lefts, rights):
    """sequences/<seq>/image_{0,1}/*.png and times.txt."""
    base = root / "sequences" / "00"
    for side, imgs in (("image_0", lefts), ("image_1", rights)):
        (base / side).mkdir(parents=True)
        for i, img in enumerate(imgs):
            _png(base / side / f"{i:06d}.png", img)
    with open(base / "times.txt", "w") as f:
        f.writelines(f"{i * 0.1:.6e}\n" for i in range(len(lefts)))
    return ["--dataset", "kitti", "--root", str(root), "--seq", "00"]


LAYOUTS = {"euroc": (_write_euroc, FLAT_CALIB),
           "kitti": (_write_kitti, KITTI_FLAT_CALIB)}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def dataset(request, rendered, tmp_path_factory):
    """A layout written to disk once: (name, its CLI arguments, the flat
    calibration file, ground truth)."""
    write, flat = LAYOUTS[request.param]
    root = tmp_path_factory.mktemp(request.param)
    lefts, rights, gt = rendered
    argv = write(root / "data", lefts, rights)
    calib = root / "algo.yaml"
    calib.write_text(flat)
    return request.param, argv + ["--calib", str(calib)], gt


def _run(main, dataset, tmp_path, capsys, *extra):
    """One CLI run: its summary and the ATE of its TUM file."""
    _, argv, gt = dataset
    out = tmp_path / "traj.tum"
    main([*argv, "--out", str(out), *extra])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(open(out).readlines()) == N_FRAMES
    _, pos = trajectory.load_tum(str(out))
    assert pos.shape == (N_FRAMES, 3)
    return summary, ate.ate_rmse(pos, ate.positions(gt))


@pytest.mark.parametrize("loader", ["python", "native"])
def test_png_to_ate(dataset, loader, tmp_path, capsys):
    """PNG decode → pairing (data.csv or image_0/image_1) → calibration
    (sensor.yaml → stereoRectify → remap, zero distortion, or the flat
    file's camera) → engine → TUM export → ATE, through the port's CLI;
    ``native``: decode and prefetch through the C++ frame loader."""
    extra = ["--device", "cpu"]
    if loader == "native":
        if not native_loader.available():
            pytest.skip("native loader not built and unbuildable here")
        extra.append("--native-loader")
    summary, err = _run(cli.main, dataset, tmp_path, capsys, *extra)
    assert summary["frames"] == N_FRAMES
    assert summary["tracking_ok_frac"] == 1.0
    # uint8 quantization + remap interpolation sit on top of the usual
    # small-rig odometry error: the reference's loose bound
    assert err < ATE_GATE_M, err


@pytest.mark.slow  # a whole JAX CLI run (compile and 24 frames) a layout
def test_matches_the_reference_cli(dataset, tmp_path, capsys):
    from stereo_svo_tpu import cli as jcli
    ours, err = _run(cli.main, dataset, tmp_path, capsys, "--device", "cpu")
    ref, jerr = _run(jcli.main, dataset, tmp_path, capsys)
    for key in ("frames", "keyframes", "tracking_ok_frac"):
        assert ours[key] == ref[key], (dataset[0], key, ours[key], ref[key])
    assert err < ATE_GATE_M and jerr < ATE_GATE_M
    assert abs(err - jerr) < 1e-3, (dataset[0], err, jerr)
