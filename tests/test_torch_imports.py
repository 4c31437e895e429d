"""The port stands alone: no module of ``stereo_svo_tpu_torch`` (nor
``chip_smoke.py``) imports jax or the ``stereo_svo_tpu`` package, loads a
file by path, or names a path into ``stereo_svo_tpu/``.

An AST scan, plus an import of every port module in a fresh interpreter
where jax and the reference package cannot be imported, after which no
loaded module may come from a file under ``stereo_svo_tpu/`` (a start-up
hook of the test environment may import jax, so checking ``sys.modules``
for names alone proves nothing).

PyYAML and OpenCV are blocked in that interpreter too (the machine with
the card has neither): every module still imports, the readers that need
neither package work, and the functions that need one raise a
RuntimeError that names it.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "stereo_svo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "stereo_svo_tpu")
# ways to execute a file by path instead of importing a module
LOADERS = ("spec_from_file_location", "SourceFileLoader", "run_path",
           "exec_module", "load_source")
# a string that is a path into the reference package ("stereo_svo_tpu",
# "stereo_svo_tpu/config.py"); "file:line" labels and prose do not match
REF_PATH = re.compile(r"^(\./)?stereo_svo_tpu(/[\w./-]*)?$")


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [f for f in files if f.exists()]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _offences(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names = [node.args[0].value]
        for name in names:
            if _forbidden(name):
                yield f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"
        where = f"{path.relative_to(ROOT)}:{getattr(node, 'lineno', 0)}"
        if isinstance(node, (ast.Name, ast.Attribute)):
            name = getattr(node, "id", getattr(node, "attr", ""))
            if name in LOADERS:
                yield f"{where} uses {name}"
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and REF_PATH.match(node.value)):
            yield f"{where} names the path {node.value!r}"


def test_no_jax_or_reference_imports():
    files = _sources()
    assert len(files) >= 20
    offences = [o for f in files for o in _offences(f)]
    assert not offences, offences


_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, os, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "stereo_svo_tpu", "yaml", "cv2")
for m in list(sys.modules):
    if m.split(".")[0] in BLOCKED:
        del sys.modules[m]
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import stereo_svo_tpu_torch
import chip_smoke
n = 0
for info in pkgutil.walk_packages(stereo_svo_tpu_torch.__path__,
                                  "stereo_svo_tpu_torch."):
    importlib.import_module(info.name)
    n += 1
ref = os.path.join(os.getcwd(), "stereo_svo_tpu") + os.sep
loaded = [m for m, mod in list(sys.modules.items())
          if os.path.abspath(getattr(mod, "__file__", None) or "")
          .startswith(ref)]
assert not loaded, loaded

import tempfile
import numpy as np
from stereo_svo_tpu_torch.io import calib, datasets, native_loader, trajectory
from stereo_svo_tpu_torch.utils import viz
def raises_naming(package, fn, *args):
    try:
        fn(*args)
    except RuntimeError as e:
        assert package in str(e), (package, str(e))
    else:
        raise AssertionError(fn.__name__ + " did not raise")
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "x.yaml")
    open(path, "w").write("fx: 1.0\n")
    raises_naming("yaml", calib.load_flat_yaml, path)
    raises_naming("yaml", calib.load_euroc_yaml_pair, path, path)
    raises_naming("cv2", datasets._imread_gray, path)
    raises_naming("cv2", lambda: list(datasets.video_frames(path)))
    raises_naming("cv2", datasets.StereoRectifier, *([None] * 7))
    raises_naming("cv2", viz.draw_trajectory, np.zeros((2, 3, 4)))
    # the readers that need neither package work
    T = np.tile(np.eye(3, 4), (3, 1, 1))
    trajectory.save_kitti(os.path.join(d, "p.txt"), T)
    assert datasets.kitti_poses(os.path.join(d, "p.txt")).shape == (3, 3, 4)
    trajectory.save_tum(os.path.join(d, "t.txt"), T)
    assert trajectory.load_tum(os.path.join(d, "t.txt"))[1].shape == (3, 3)
    # the native library links OpenCV: where it loads, sizing its buffers
    # still needs cv2; where it does not, the loader says so
    os.makedirs(os.path.join(d, "sequences", "00", "image_0"))
    open(os.path.join(d, "sequences", "00", "image_0", "0.png"), "w").close()
    raises_naming("cv2" if native_loader.available() else "native",
                  native_loader.kitti_native, d, "00")
print("imported", n)
"""


def test_port_imports_without_jax():
    """… and without PyYAML and OpenCV."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 30
