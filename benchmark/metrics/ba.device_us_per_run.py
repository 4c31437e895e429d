"""Device µs a run of window BA (``engine/step.run_window_ba`` in the
keyframe bodies ``K`` and ``K_loop``), over the window's steps: its
``svo.stage.ba`` device spans summed, over the frames in which it ran.
None where the export has no such column (a program without stage spans)
or no BA ran in the window. Window selection as in
``device.frame_busy_share``."""

from svobench import layers

COLUMN = "svo.stage.ba.ns"
_spans = layers.reader("device.frame_busy_share")


def read(ctx):
    w = _spans.window(ctx)
    if w is None:
        return None
    record, rows, _ = w
    if COLUMN not in record["device_columns"]:
        return None
    i = record["device_columns"].index(COLUMN)
    runs = [r[i] for r in rows if r[i] > 0]
    return sum(runs) / len(runs) / 1e3 if runs else None
