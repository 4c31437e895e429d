"""Host µs a step in the launch of the frame graph (``svo.step.launch``:
the host clock around the step's one ``cudaGraphLaunch``), over the
window's steps: what of the runner's host time a step is the launch.
Window selection as in ``device.frame_busy_share``."""

from svobench import layers

_spans = layers.reader("device.frame_busy_share")


def read(ctx):
    w = _spans.window(ctx)
    if w is None or not w[2]:
        return None
    record, _, rows = w
    cols = record["host_columns"]
    a = cols.index("svo.step.launch.start")
    b = cols.index("svo.step.launch.end")
    return sum(r[b] - r[a] for r in rows) / len(rows) / 1e3
