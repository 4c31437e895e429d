"""Device µs a step in the tracking bodies, ``A_ok`` and ``A_fail``
(alignment, KLT, stereo re-measurement, pose refinement, depth filter, the
keyframe decision), over the window's steps: their ``svo.body.*`` device
spans summed, over the steps. Window selection as in
``device.frame_busy_share``."""

from svobench import layers

BODIES = ("A_ok", "A_fail")
_spans = layers.reader("device.frame_busy_share")


def read(ctx):
    w = _spans.window(ctx)
    if w is None:
        return None
    record, rows, _ = w
    cols = [record["device_columns"].index(f"svo.body.{g}.ns")
            for g in BODIES if g in record["bodies"]]
    return sum(r[i] for r in rows for i in cols) / len(rows) / 1e3
