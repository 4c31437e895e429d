"""A cell cut to a size the CPU runs in seconds, for the tests: the
configuration's own file with a 188x120 camera and fewer slots and levels,
and the traffic's own file with short sequences and chunks."""

import json
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
CAMERA = dict(fx=240.0, fy=240.0, cx=94.0, cy=60.0, baseline=0.11,
              width=188, height=120)
SVO = dict(grid_rows=6, grid_cols=8, max_features=48, num_levels=3,
           align_levels=3, align_iters_per_level=[2, 3, 4], klt_levels=3,
           stereo_max_disp=32, kf_min_tracked=16, border_margin=8,
           detect_levels=3)



def cell_files(name: str):
    from svobench import cli, traffic
    bench = cli.load_bench()
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = json.loads((BENCH.parent / entry["file"]).read_text())
    cfg["camera"] = dict(CAMERA)
    cfg["svo"].update(SVO)
    tr = traffic.load(wl["traffic"])
    tr.update(frames=18, chunk=6, slice_frames=3)
    if "batch" in tr:
        tr["batch"] = 4
    else:
        tr["sequences"] = 1     # the compared sequence runs first
    return bench, cfg, tr


def run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 2.5,
        traced: bool = False) -> dict:
    from svobench import cli
    bench, cfg, tr = cell_files(name)
    return cli.run_cell(bench, name, seed, seconds, traced,
                        torch.device("cpu"), time.perf_counter(), cfg, tr)
