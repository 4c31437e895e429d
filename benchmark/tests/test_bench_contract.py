"""``BENCHMARK.json`` keeps to the benchmark's contract as far as a file
can show: keys, names, lengths, units, the files it names, a reader for
every per-layer metric, and the run's command without a card."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    for p in SPEC["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/")


def test_configs():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads():
    pairs, names = set(), set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] not in names
        names.add(w["name"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()


def test_metrics():
    from svobench import layers
    cells = {w["name"] for w in SPEC["workloads"]}
    names = set()
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.add(m["name"])
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert hasattr(layers.reader(m["name"]), "read")
        assert m["name"] not in names
        names.add(m["name"])
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        for c in m["workloads"]:
            assert c in cells and c in moved.get("workloads", [c])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in cells:       # setup_s, another end-to-end and a per-layer
        e2e = [m for m in SPEC["end_to_end"]
               if c in m.get("workloads", [c])]
        assert len(e2e) >= 2
        assert any(c in m["workloads"] for m in SPEC["per_layer"])


def test_without_a_card_it_exits_and_prints_nothing(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    w = SPEC["workloads"][0]["name"]
    out = subprocess.run([sys.executable, *SPEC["command"][1:], "--workload",
                          w, "--seed", str(2 ** 33), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_alone_it_exits_and_prints_nothing(tmp_path):
    """In a directory with only BENCHMARK.json and the files under paths,
    the program is missing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in SPEC["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    w = SPEC["workloads"][0]["name"]
    out = subprocess.run([sys.executable, *SPEC["command"][1:], "--workload",
                          w, "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
