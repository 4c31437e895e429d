"""The benchmark's own tests, on the CPU: ``python -m pytest
benchmark/tests`` from the repository's root. Tests marked ``cuda`` run
only on a machine with a card (``-m cuda``)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
