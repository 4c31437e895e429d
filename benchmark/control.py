"""The control of ``correct`` on the card (``svobench/control.py``):

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...] \
        --frames <t>
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from svobench import control  # noqa: E402

if __name__ == "__main__":
    sys.exit(control.main())
