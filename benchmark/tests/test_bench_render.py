"""The frozen renderer gives the frames of the program's ``io/synthetic``
(as it stood when the copy was made), bit for bit on the CPU."""

import pytest
import torch

from svobench import render

CAM = dict(fx=240.0, fy=240.0, cx=93.5, cy=60.0, baseline=0.11, width=188,
           height=120)
CASES = [("planes", "loop", 1, 0.05, 7),
         ("road", "kitti", 2, 0.1, 2 ** 33 + 5)]
@pytest.mark.parametrize("scene,traj,aa,dt,seed", CASES)
def test_equals_the_programs_renderer(scene, traj, aa, dt, seed):
    from stereo_svo_tpu_torch.config import CameraConfig
    from stereo_svo_tpu_torch.io import synthetic

    cam = CameraConfig(**CAM)
    gen = synthetic.get_scene(scene, seed, "cpu")
    want_l, want_r, want_T = [], [], []
    for i in range(12):
        T = synthetic.trajectory_pose(torch.tensor(i * dt), traj)
        left, right = synthetic.render_stereo(cam, T, gen, aa=aa)
        want_l.append(left)
        want_r.append(right)
        want_T.append(T)
    got = render.render_sequence(CAM, 12, dt, traj, scene, seed, aa, "cpu")
    for w, g in zip((want_l, want_r, want_T), got):
        assert torch.equal(torch.stack(w), g)


def test_chunks_render_like_single_frames():
    a = render.render_sequence(CAM, render.CHUNK + 3, 0.05, "loop", "planes",
                               3, 1, "cpu")
    for i in (0, render.CHUNK - 1, render.CHUNK, render.CHUNK + 2):
        one = render.render_views(CAM, a[2][i:i + 1],
                                  render.planes_scene(3, torch.device("cpu")))
        assert torch.equal(one[0], a[0][i])
