"""Device µs a run of the keyframe bodies, ``K`` and ``K_loop``
(``keyframe.insert`` and window BA, ``K_loop`` with the online loop), over
the window's steps: their ``svo.body.*`` device spans summed, over the
frames in which one ran. None where none ran in the window. Window
selection as in ``device.frame_busy_share``."""

from svobench import layers

BODIES = ("K", "K_loop")
_spans = layers.reader("device.frame_busy_share")


def read(ctx):
    w = _spans.window(ctx)
    if w is None:
        return None
    record, rows, _ = w
    cols = [record["device_columns"].index(f"svo.body.{g}.ns")
            for g in BODIES if g in record["bodies"]]
    runs = [r[i] for r in rows for i in cols if r[i] > 0]
    return sum(runs) / len(runs) / 1e3 if runs else None
