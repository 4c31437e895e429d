"""The one traffic generator: every cell's traffic is a data file under
``benchmark/traffic/`` that names its mode (a driver under
``benchmark/modes/``: ``offline``, ``batched``), scene, trajectory, frame
interval and lengths; this module derives a run's sequences and samples
from ``--seed``."""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"
SEED_MASK = 2 ** 64 - 1


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def _stream(seed: int, purpose: int) -> np.random.SeedSequence:
    """An independent seed stream for each ``purpose`` of one ``--seed``
    (any whole number: it is reduced to 64 bits)."""
    return np.random.SeedSequence([int(seed) & SEED_MASK, purpose])


def sequence_seeds(seed: int, n: int, pool: Optional[int] = None
                   ) -> List[int]:
    """The scene seeds of a run's ``n`` sequences: every sequence renders
    the same scene kind along the same trajectory, its texture drawn from
    its own seed. With ``pool``, the n textures are a fixed set and the
    seed only orders them: a batch runs its conditional bodies when any of
    its sequences needs them, so every set of textures would give a batch
    its own amount of work."""
    if pool is None:
        return [int(x) for x in _stream(seed, 0).generate_state(n, np.uint32)]
    base = _stream(pool, 2).generate_state(n, np.uint32)
    order = np.random.default_rng(_stream(seed, 3)).permutation(n)
    return [int(base[i]) for i in order]


def compared(seed: int, n: int, k: int) -> List[int]:
    """The ``k`` of ``n`` sequences whose every frame in the window is held
    against the reference, drawn from the seed."""
    rng = np.random.default_rng(_stream(seed, 1))
    return sorted(int(i) for i in rng.choice(n, size=min(k, n),
                                             replace=False))

