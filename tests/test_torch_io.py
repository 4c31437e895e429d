"""The port's host IO modules against the reference's: trajectory files,
calibration files, the dataset readers and the native frame loader, all on
files the tests write themselves. Host code on both sides (numpy, PyYAML,
OpenCV), so every comparison is exact unless a tolerance says why.
"""

import dataclasses
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("yaml")

from stereo_svo_tpu.io import calib as jcalib
from stereo_svo_tpu.io import datasets as jdatasets
from stereo_svo_tpu.io import trajectory as jtrajectory
from stereo_svo_tpu_torch.config import SvoConfig
from stereo_svo_tpu_torch.io import calib, datasets, native_loader, trajectory


def _poses(n=7, seed=0):
    """Seeded rigid poses (n,3,4): rotations of every quaternion branch
    (trace > 0 and each of the three axis-dominant cases)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = rng.normal(size=3)
        w *= (0.3 + 0.45 * i) / np.linalg.norm(w)      # up to ~3 rad
        th = np.linalg.norm(w)
        k = w / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        out.append(np.concatenate([R, rng.normal(size=(3, 1))], 1))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("fmt", ["tum", "tum_default_stamps", "kitti"])
def test_trajectory_files_equal_both_ways(tmp_path, fmt):
    """The same poses give the same bytes from either package, and each
    package reads the other's file."""
    T = _poses()
    ours, ref = str(tmp_path / "ours.txt"), str(tmp_path / "ref.txt")
    if fmt == "kitti":
        trajectory.save_kitti(ours, T)
        jtrajectory.save_kitti(ref, T)
    else:
        ts = None if fmt == "tum_default_stamps" else np.arange(7) * 0.05
        trajectory.save_tum(ours, T, ts)
        jtrajectory.save_tum(ref, T, ts)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    if fmt == "kitti":
        np.testing.assert_array_equal(datasets.kitti_poses(ref),
                                      jdatasets.kitti_poses(ours))
        # %.9e keeps a float32 exactly
        np.testing.assert_array_equal(
            datasets.kitti_poses(ref).astype(np.float32), T)
    else:
        for a, b in zip(trajectory.load_tum(ref), jtrajectory.load_tum(ours)):
            np.testing.assert_array_equal(a, b)
        # %.6f of the file format
        np.testing.assert_allclose(trajectory.load_tum(ours)[1],
                                   T[:, :, 3], atol=1e-6)


def test_rot_to_quat_every_branch():
    T = _poses(12, seed=3)
    traces = [np.trace(R) for R in T[:, :, :3]]
    assert min(traces) < 0 < max(traces)
    for R in T[:, :, :3]:
        np.testing.assert_array_equal(trajectory._rot_to_quat(R),
                                      jtrajectory._rot_to_quat(R))


FLAT = ("fx: 500.0\nfy: 501.0\ncx: 320.0\ncy: 240.0\nbaseline: 0.12\n"
        "width: 640\nheight: 480\nnum_levels: 3\nalign_levels: 3\n"
        "klt_levels: 3\nfast_threshold: 15.0\n")


@pytest.mark.parametrize("base", [None, "kitti"])
def test_flat_yaml_calib_matches_reference(tmp_path, base):
    from stereo_svo_tpu import config as jconfig
    from stereo_svo_tpu_torch import config
    path = str(tmp_path / "calib.yaml")
    with open(path, "w") as f:
        f.write(FLAT)
    ours = calib.load_flat_yaml(
        path, base=config.kitti_config() if base else None)
    ref = jcalib.load_flat_yaml(
        path, base=jconfig.kitti_config() if base else None)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.camera.fx == 500.0 and ours.fast_threshold == 15.0
    assert ours.klt_patch == SvoConfig().klt_patch


def _write_sensor_yaml(tmp_path):
    K = [458.654, 457.296, 367.215, 248.375]
    D = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
    T1 = np.eye(4)
    T1[0, 3] = 0.11                      # cam1 is 11 cm to the right
    for name, tbs in (("cam0.yaml", np.eye(4)), ("cam1.yaml", T1)):
        with open(tmp_path / name, "w") as f:
            f.write("camera_model: pinhole\n"
                    f"intrinsics: {K}\n"
                    "distortion_model: radial-tangential\n"
                    f"distortion_coefficients: {D}\n"
                    "resolution: [752, 480]\n"
                    "T_BS:\n  rows: 4\n  cols: 4\n"
                    f"  data: {tbs.reshape(-1).tolist()}\n")
    return str(tmp_path / "cam0.yaml"), str(tmp_path / "cam1.yaml")


def test_euroc_sensor_yaml_pair_and_rectifier_match_reference(tmp_path):
    p0, p1 = _write_sensor_yaml(tmp_path)
    for o, r in zip(calib.load_euroc_yaml_pair(p0, p1),
                    jcalib.load_euroc_yaml_pair(p0, p1)):
        assert o["size"] == r["size"]
        for k in ("K", "D", "T_BS"):
            np.testing.assert_array_equal(o[k], r[k])
    cfg, rect = calib.euroc_rectified_config(p0, p1)
    jcfg, jrect = jcalib.euroc_rectified_config(p0, p1)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert abs(cfg.camera.baseline - 0.11) < 5e-3
    for name in ("fx", "fy", "cx", "cy", "baseline"):
        assert getattr(rect, name) == getattr(jrect, name)
    for name in ("P0", "P1"):
        np.testing.assert_array_equal(getattr(rect, name),
                                      getattr(jrect, name))
    for m, jm in zip(rect.map0 + rect.map1, jrect.map0 + jrect.map1):
        np.testing.assert_array_equal(m, jm)
    rng = np.random.default_rng(0)
    l = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    r = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    for o, ref in zip(rect(l, r), jrect(l, r)):
        np.testing.assert_array_equal(o, ref)


@pytest.fixture()
def euroc_root(tmp_path):
    """Minimal EuRoC ASL tree with 3 frames and a ground-truth file."""
    root = tmp_path / "MH_99"
    for cam in ("cam0", "cam1"):
        (root / "mav0" / cam / "data").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(3):
        ts = 1403636579763555584 + i * 50000000
        img = rng.uniform(0, 255, (96, 128))
        for cam in ("cam0", "cam1"):
            cv2.imwrite(str(root / "mav0" / cam / "data" / f"{ts}.png"),
                        (img + (cam == "cam1")).astype(np.uint8))
        rows.append(f"{ts},{ts}.png")
    rows.append("1403636579999999999,missing.png")   # skipped: no file
    for cam in ("cam0", "cam1"):
        with open(root / "mav0" / cam / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    gt_dir = root / "mav0" / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True)
    with open(gt_dir / "data.csv", "w") as f:
        f.write("#ts,px,py,pz\n")
        for i in range(3):
            f.write(f"{1403636579763555584 + i * 50000000},"
                    f"{0.1 * i},{0.2 * i},{0.3 * i}\n")
    return str(root)


@pytest.fixture()
def kitti_root(tmp_path):
    base = tmp_path / "kitti" / "sequences" / "00"
    for d in ("image_0", "image_1"):
        (base / d).mkdir(parents=True)
    rng = np.random.default_rng(4)
    for i in range(5):
        for d in ("image_0", "image_1"):
            cv2.imwrite(str(base / d / f"{i:06d}.png"),
                        rng.uniform(0, 255, (48, 64)).astype(np.uint8))
    with open(base / "times.txt", "w") as f:
        f.writelines(f"{i * 0.103}\n" for i in range(5))
    return str(tmp_path / "kitti")


def _same_frames(ours, ref, n):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) == n
    for (ol, o_r, ot), (rl, rr, rt) in zip(ours, ref):
        assert ol.dtype == np.float32 and ol.shape == rl.shape
        np.testing.assert_array_equal(ol, rl)
        np.testing.assert_array_equal(o_r, rr)
        assert ot == rt


def test_euroc_reader_matches_reference(euroc_root):
    _same_frames(datasets.euroc_frames(euroc_root),
                 jdatasets.euroc_frames(euroc_root), 3)
    frames = list(datasets.euroc_frames(euroc_root))
    assert abs(frames[1][2] - frames[0][2] - 0.05) < 1e-6
    for o, r in zip(datasets.euroc_ground_truth(euroc_root),
                    jdatasets.euroc_ground_truth(euroc_root)):
        np.testing.assert_array_equal(o, r)
    assert datasets.euroc_ground_truth(euroc_root)[1].shape == (3, 3)


def test_kitti_reader_matches_reference(kitti_root):
    _same_frames(datasets.kitti_frames(kitti_root, "00"),
                 jdatasets.kitti_frames(kitti_root, "00"), 5)
    os.remove(os.path.join(kitti_root, "sequences", "00", "times.txt"))
    _same_frames(datasets.kitti_frames(kitti_root, "00"),
                 jdatasets.kitti_frames(kitti_root, "00"), 5)


@pytest.mark.parametrize("two_files", [False, True])
def test_video_reader_matches_reference(tmp_path, two_files):
    rng = np.random.default_rng(3)
    h, w, n = 48, 64, 4
    fourcc = cv2.VideoWriter_fourcc(*"MJPG")

    def write_video(path, frames):
        vw = cv2.VideoWriter(path, fourcc, 10.0,
                             (frames.shape[2], frames.shape[1]))
        assert vw.isOpened(), "cv2 VideoWriter backend unavailable"
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
        vw.release()

    fl = rng.uniform(0, 255, (n, h, w)).astype(np.uint8)
    fr = rng.uniform(0, 255, (n, h, w)).astype(np.uint8)
    if two_files:
        paths = (str(tmp_path / "l.avi"), str(tmp_path / "r.avi"))
        write_video(paths[0], fl)
        write_video(paths[1], fr)
    else:
        paths = (str(tmp_path / "sbs.avi"),)
        write_video(paths[0], np.concatenate([fl, fr], axis=2))
    _same_frames(datasets.video_frames(*paths),
                 jdatasets.video_frames(*paths), n)
    got = list(datasets.video_frames(*paths))
    assert got[0][0].shape == (h, w) and abs(got[1][2] - 0.1) < 1e-6
    # MJPG is lossy; the content still correlates with the source
    assert np.corrcoef(got[0][1].reshape(-1), fr[0].reshape(-1))[0, 1] > 0.9


def test_native_loader_matches_python_reader(kitti_root, euroc_root):
    if not native_loader.available():
        pytest.skip("native/libsvoframeloader.so is not built and cannot "
                    "be built here")
    _same_frames(native_loader.kitti_native(kitti_root, "00", n_threads=3,
                                            prefetch=4),
                 datasets.kitti_frames(kitti_root, "00"), 5)
    # many threads and a tiny ring: frames still arrive in order
    ts = [t for _, _, t in native_loader.kitti_native(
        kitti_root, "00", n_threads=4, prefetch=2)]
    assert ts == sorted(ts) and len(ts) == 5
    _same_frames(native_loader.euroc_native(euroc_root),
                 datasets.euroc_frames(euroc_root), 3)


def test_native_loader_rectifies_like_the_python_reader(tmp_path):
    if not native_loader.available():
        pytest.skip("native/libsvoframeloader.so is not built and cannot "
                    "be built here")
    p0, p1 = _write_sensor_yaml(tmp_path)
    _, rect = calib.euroc_rectified_config(p0, p1)
    root = tmp_path / "MH_98"
    rows = []
    for cam in ("cam0", "cam1"):
        (root / "mav0" / cam / "data").mkdir(parents=True)
    v, u = np.mgrid[0:480, 0:752]
    for i in range(2):
        for cam in ("cam0", "cam1"):
            smooth = 127 + 60 * np.sin(u / 40.0 + i) + 60 * np.cos(v / 30.0)
            cv2.imwrite(str(root / "mav0" / cam / "data" / f"{i}.png"),
                        smooth.astype(np.uint8))
        rows.append(f"{i},{i}.png")
    for cam in ("cam0", "cam1"):
        with open(root / "mav0" / cam / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    nat = list(native_loader.euroc_native(str(root), rect))
    py = list(datasets.euroc_frames(str(root), rect))
    assert len(nat) == len(py) == 2
    for (nl, nr, _), (pl, pr, _) in zip(nat, py):
        # the same maps on a smooth image: the library remaps the decoded
        # 8-bit image (rounding to a grey level), the Python reader the
        # float32 one. Measured: 13 of 360,960 pixels (at the border of the
        # valid region, where a tap falls outside the image) differ by more
        # than one grey level, at most 3.1
        for nat_img, py_img in ((nl, pl), (nr, pr)):
            diff = np.abs(nat_img - py_img)
            assert np.mean(diff > 1.0) < 1e-3 and diff.max() < 8.0


def test_native_loader_never_falls_back(monkeypatch, kitti_root):
    """Where the library cannot be loaded the native loaders raise."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_LIB_PATH",
                        os.path.join(kitti_root, "no_such_library.so"))
    monkeypatch.setattr(native_loader.subprocess, "run",
                        lambda *a, **k: (_ for _ in ()).throw(OSError()))
    assert not native_loader.available()
    with pytest.raises(RuntimeError, match="native frame loader"):
        native_loader.kitti_native(kitti_root, "00")
    with pytest.raises(RuntimeError, match="native frame loader"):
        native_loader.NativeFrameLoader([], [], [], 4, 4)
