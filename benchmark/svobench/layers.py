"""The per-layer metrics: each is a small reader of its own,
``benchmark/metrics/<name>.py``, whose ``read(ctx)`` returns the metric's
value from what the run recorded, or None where it finds nothing to
read (the metric is then left out of the line)."""

from __future__ import annotations

import importlib.util
import types
from pathlib import Path
from typing import Dict

METRICS_DIR = Path(__file__).resolve().parents[1] / "metrics"


def reader(name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}", METRICS_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reported(bench: dict, cell: str, key: str) -> list:
    """The metrics of ``bench[key]`` that ``cell`` reports: those that
    list it, and those that list no cells and move a metric it reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[key]:
        cells = m.get("workloads")
        if cells is not None:
            if cell in cells:
                out.append(m)
        elif key == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def read_all(bench: dict, cell: str, ctx) -> Dict[str, dict]:
    out = {}
    for m in reported(bench, cell, "per_layer"):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
