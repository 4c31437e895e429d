"""One run of one cell: ``python3 benchmark/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``. The last line of standard output
is the result's JSON object; the numbers compared, each beside its limit,
are the last lines of standard error."""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import torch

from . import correct, harness, layers, traffic as traffic_mod

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BANNED = ("jax", "jaxlib", "flax", "stereo_svo_tpu")


def banned_modules() -> list:
    """Modules loaded whose top-level name, compared whole, is JAX's or the
    JAX package's (``stereo_svo_tpu_torch`` is neither)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def mode_driver(mode: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"mode_{mode}", BENCH_DIR / "modes" / f"{mode}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, config: dict = None,
             traffic: dict = None) -> dict:
    """Run cell ``name`` once on ``device`` and return the result's
    object (``config``/``traffic``: contents that replace the cell's
    files, for tests)."""
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = config or json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = traffic or traffic_mod.load(wl["traffic"])
    cell = harness.Cell(name, config, traffic, seed, seconds, traced, device,
                        t_start)
    from . import clocks
    sampler = clocks.ClockSampler(device.index or 0).start()
    try:
        record = mode_driver(traffic["mode"]).run(cell)
    finally:
        sampler.stop()
    record.notes["render_s"] = cell.render_s
    t0, t1 = record.layer["window"]
    window_clock = sampler.between(t0, t1)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checked = correct.checks(cell, record)
    record.notes["reference_s"] = time.perf_counter() - t_ref
    ok = all(correct.holds(v, lim, rule) for _, v, lim, rule in checked)
    if traced:
        ctx = types.SimpleNamespace(cell=cell, record=record,
                                    summary=record.summary,
                                    layer=record.layer, clock=window_clock)
        metrics = layers.read_all(bench, name, ctx)
    else:
        metrics = {m["name"]: {"value": float(record.e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in layers.reported(bench, name, "end_to_end")}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(record.memory_peak_bytes)}
    result = {"correct": ok, "attempted": int(record.attempted),
              "failed": int(record.failed), "metrics": metrics,
              "device": dev}
    if traced:
        s = record.summary
        if s is None:
            raise RuntimeError("the traced slice recorded nothing")
        dev["busy_s"] = s.busy_s()
        dev["window_s"] = s.span_s
        result["breakdown"] = s.breakdown()
    clock_line = [c[1] for c in window_clock]
    harness.log("notes " + json.dumps(record.notes))
    harness.log("e2e " + json.dumps(record.e2e))
    if clock_line:
        harness.log("clock " + json.dumps({
            "sm_mhz": clock_line,
            "power_w": [c[2] for c in window_clock],
            "temp_c": [c[3] for c in window_clock]}))
    result["checks"] = {n: {"value": v, "limit": lim, "rule": rule}
                        for n, v, lim, rule in checked}
    for n, v, lim, rule in checked:
        harness.log(f"check {n} {v!r} {rule} {lim!r}")
    return result


def main(argv=None, t_start: float = 0.0) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_bench()
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        harness.log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < wl["chips"]):
        harness.log(f"{args.workload} needs {wl['chips']} CUDA device(s); "
                    f"found {torch.cuda.device_count()}")
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t_start)
    found = banned_modules()
    if found:
        harness.log(f"JAX or the JAX package was loaded: {found}")
        return 4
    print(json.dumps(result), flush=True)
    return 0
