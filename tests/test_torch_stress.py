"""The stress configuration (north-star config #3: 5-level pyramids and a
large seed population) through the port, at tests/test_stress.py's scaled
size and held to that test's gates; ``stress_config()`` itself builds at
its full size (2048 slots, 752×480)."""

import torch

from stereo_svo_tpu_torch.config import CameraConfig, SvoConfig, stress_config
from stereo_svo_tpu_torch.engine import runner, state as state_mod
from stereo_svo_tpu_torch.io import synthetic

# one intra-op thread: the tier-1 run's parallel workers already fill the
# cores, and oversubscribed torch threads slow every small op ~100×
torch.set_num_threads(1)


def test_stress_config_shape():
    cfg = stress_config()
    assert cfg.num_levels == 5 and cfg.max_features >= 2048
    assert cfg.grid_rows * cfg.grid_cols >= 2048
    st = state_mod.init_state(cfg, device="cpu")
    assert st.klt_tmpl.patches.shape == (3, 2048, 64)
    assert st.tmpl.patches.shape == (3, 2048, 16)   # align levels 1-3
    assert st.obs_uv.shape == (10, 2048, 2)


def test_many_seeds_five_levels_tracks():
    cfg = SvoConfig(
        camera=CameraConfig(fx=240.0, fy=240.0, cx=188.0, cy=120.0,
                            baseline=0.11, width=376, height=240),
        num_levels=5, align_levels=4, align_min_level=1,
        grid_rows=16, grid_cols=32, max_features=512,
        stereo_max_disp=48, kf_min_tracked=150, border_margin=10,
        klt_levels=3, max_keyframes=4)
    lefts, rights, _ = synthetic.make_sequence(cfg.camera, 6, dt=0.1,
                                               kind="arc", seed=2,
                                               device="cpu")
    _, m = runner.run_sequence(cfg, lefts, rights, device="cpu")
    assert m["tracking_ok"].all()
    # large active population from the bootstrap keyframe
    assert int(m["n_seeds"][0] + m["n_landmarks"][0]) > 300
    assert m["n_tracked"][1:].min() > 150
