"""Share of the window the device spent inside frames: the window's
device frame spans (``svo.frame``: the frame graph's first stamp to its
last, on the card's ``%globaltimer``) summed, over the first frame's start
to the last frame's end. What is left is the device waiting between
frames: for the host, a reset, a piece boundary.

Every span reader reads the program's span export,
``build/svo_trace/spans-<pid>.jsonl`` under the checkout, which a graphed
step writes when it is dropped (after the window and the traced slice);
its last line is the cell's step. Its rows are the step's last frames,
oldest first: the last ``1 + slice_steps`` are the traced ones (the
profiler's warm-up frame and the slice), the ``runner_steps`` before them
the window's. Where the ring holds fewer frames than that, the readers use
the window's frames it holds. No export (a program without spans): None.
"""

import json
import os
from pathlib import Path

SPANS_DIR = Path(__file__).resolve().parents[2] / "build" / "svo_trace"


def window(ctx):
    """(the export's last record, its device rows and its host rows of the
    window's frames), or None where there is no export or no frame of the
    window in it."""
    try:
        lines = (SPANS_DIR / f"spans-{os.getpid()}.jsonl").read_text(
            ).splitlines()
    except OSError:
        return None
    if not lines:
        return None
    record = json.loads(lines[-1])
    steps = ctx.layer.get("runner_steps") or 0
    traced = ctx.layer.get("slice_steps") or 0
    traced = 1 + traced if traced else 0

    def cut(rows):
        end = max(len(rows) - traced, 0)
        return rows[max(end - steps, 0):end]

    device, host = cut(record["device_rows"]), cut(record["host_rows"])
    if not device:
        return None
    return record, device, host


def read(ctx):
    w = window(ctx)
    if w is None:
        return None
    rows = w[1]
    span = rows[-1][1] - rows[0][0]
    return sum(r[1] - r[0] for r in rows) / span if span > 0 else None
