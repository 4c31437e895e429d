"""The control of ``correct``: the reference put in the program's place,
one step below the configuration's precision (TF32 on), on a cell's
compared sequence at the cell's own size, held against the reference at
the configuration's precision by the same comparison. Its readings set the
upper end of each limit; ``python3 benchmark/control.py --workload <name>
--seeds <n> ...`` prints one JSON line a seed."""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import cli, correct, harness, traffic as traffic_mod


def control_reading(bench: dict, name: str, seed: int, frames: int,
                    device: torch.device, config: dict = None,
                    traffic: dict = None) -> dict:
    """The control's readings on the first ``frames`` frames of cell
    ``name``'s compared sequence at ``seed``."""
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = config or json.loads((cli.ROOT / entry["file"]).read_text())
    traffic = traffic or traffic_mod.load(wl["traffic"])
    cell = harness.Cell(name, config, traffic, seed, 0.0, False, device, 0.0)
    n_seq = traffic.get("batch", traffic.get("sequences", 1))
    pick = traffic_mod.compared(seed, n_seq, traffic["compared"])[0]
    lefts, rights, _ = cell.sequences(n_seq, frames)[pick]
    t = time.perf_counter()
    ref = correct.reference_run(config, lefts, rights, frames, device)
    low = correct.reference_run(config, lefts, rights, frames, device,
                                tf32=True)
    got = correct.against([low], ref)
    got.update(seed=seed, sequence=pick, frames=frames,
               seconds=time.perf_counter() - t)
    return got


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, required=True)
    args = p.parse_args(argv)
    bench = cli.load_bench()
    for seed in args.seeds:
        print(json.dumps(control_reading(bench, args.workload, seed,
                                         args.frames,
                                         torch.device("cuda", 0))),
              flush=True)
    return 0
