"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level names compared whole: ``stereo_svo_tpu_torch`` is neither),
nor the repository's older benchmark scripts; the reference imports
nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BANNED = {"jax", "jaxlib", "flax", "stereo_svo_tpu", "bench_torch",
          "chip_smoke", "bench", "bench_kernels", "bench_amortized",
          "profile_step", "compare_kernels"}
PROGRAM = "stereo_svo_tpu_torch"
# the yardstick: the reference and what it judges with
YARDSTICK = ["svobench/reference", "svobench/render.py",
             "svobench/correct.py", "svobench/control.py",
             "svobench/traffic.py", "svobench/stats.py", "svobench/trace.py",
             "metrics"]


def _imports(path: Path):
    """Top-level module names a file imports (relative imports left out),
    at any depth of the file (inside functions too)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(*parts):
    for part in parts:
        p = BENCH / part
        yield from ([p] if p.suffix == ".py" else sorted(p.rglob("*.py")))


def test_no_file_imports_jax_or_the_old_scripts():
    found = {(str(f.relative_to(BENCH)), m) for f in _files(".")
             for m in _imports(f) if m in BANNED}
    assert not found


def test_the_yardstick_imports_nothing_of_the_program():
    found = {(str(f.relative_to(BENCH)), m) for f in _files(*YARDSTICK)
             for m in _imports(f) if m == PROGRAM}
    assert not found


_WALK = r"""
import importlib, json, pkgutil, sys
sys.path[:0] = [{bench!r}, {root!r}]
import svobench.reference as ref
names = [m.name for m in
         pkgutil.walk_packages(ref.__path__, "svobench.reference.")]
for n in names:
    importlib.import_module(n)
for n in ("svobench.render", "svobench.correct", "svobench.control"):
    importlib.import_module(n)
yard = sorted(m for m in sys.modules)
if {harness}:
    from svobench import cli, layers
    for mode in sorted(p.stem for p in (cli.BENCH_DIR / "modes").glob("*.py")):
        cli.mode_driver(mode)
    for m in cli.load_bench()["per_layer"]:
        layers.reader(m["name"])
    import stereo_svo_tpu_torch.engine.graphed
    import stereo_svo_tpu_torch.engine.runner  # noqa: F401
print(json.dumps({{"yard": yard, "all": sorted(sys.modules)}}))
"""


@pytest.mark.parametrize("harness", [False, True])
def test_loaded_modules(harness):
    out = subprocess.run(
        [sys.executable, "-c", _WALK.format(bench=str(BENCH), root=str(ROOT),
                                            harness=harness)],
        capture_output=True, text=True, check=True, cwd=ROOT)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    top = {m.split(".")[0] for m in mods["all"]}
    assert not top & BANNED
    assert PROGRAM not in {m.split(".")[0] for m in mods["yard"]}
    if harness:
        assert PROGRAM in top


def test_the_check_compares_whole_names():
    from svobench import cli
    before = set(sys.modules)
    try:
        sys.modules.setdefault("stereo_svo_tpu_torch_probe", object())
        assert "stereo_svo_tpu_torch_probe" not in cli.banned_modules()
        sys.modules["jaxlib.probe"] = object()
        assert "jaxlib.probe" in cli.banned_modules()
    finally:
        for m in set(sys.modules) - before:
            del sys.modules[m]
