"""Median SM clock of the card over the window, sampled every 250 ms by
``nvidia-smi`` (power draw and temperature are on the run's clock line)."""

from svobench import stats


def read(ctx):
    if not ctx.clock:
        return None
    return stats.percentile([c[1] for c in ctx.clock], 50)
