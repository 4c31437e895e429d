"""Device µs a step in the epipolar search for lost seeds
(``depth_filter.epipolar_search`` in the track bodies ``A_ok`` and
``A_fail``), over the window's steps: its ``svo.stage.epi`` device spans
summed, over the steps. None where the export has no such column (a
configuration without the search, or a program without stage spans) or
the search never ran in the window. Window selection as in
``device.frame_busy_share``."""

from svobench import layers

COLUMN = "svo.stage.epi.ns"
_spans = layers.reader("device.frame_busy_share")


def read(ctx):
    w = _spans.window(ctx)
    if w is None:
        return None
    record, rows, _ = w
    if COLUMN not in record["device_columns"]:
        return None
    i = record["device_columns"].index(COLUMN)
    total = sum(r[i] for r in rows)
    return total / len(rows) / 1e3 if total > 0 else None
