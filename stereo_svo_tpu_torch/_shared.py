"""Load a numpy-only module of the reference package by file path.

``import stereo_svo_tpu`` would run its ``__init__``, which imports jax;
loading the single file keeps one source of truth for the shared module
without that import.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from types import ModuleType

_REF_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "stereo_svo_tpu")


def load_reference_file(relpath: str, name: str) -> ModuleType:
    """Execute ``stereo_svo_tpu/<relpath>`` as module ``name`` (once)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REF_DIR, relpath))
    mod = importlib.util.module_from_spec(spec)
    # registered before execution: dataclasses resolve their module by name
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
