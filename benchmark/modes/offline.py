"""Offline traffic: recorded sequences processed as fast as the card goes.
One graphed step is made; each sequence runs from ``step.reset()``
through ``runner.run_frames``, cycling through the traffic's sequences
until the window closes. Frames are rendered at set-up and stay on the
card."""

from __future__ import annotations

import time

from svobench import harness


def run(cell: harness.Cell) -> harness.Record:
    from stereo_svo_tpu_torch.engine import graphed, runner

    tr = cell.traffic
    T = tr["frames"]
    seqs = cell.sequences(tr["sequences"])
    step = graphed.make_graphed_step(cell.program_config(), cell.device)

    def call(s, a, b):
        return runner.run_frames(step, seqs[s][0][a:b], seqs[s][1][a:b])[1]

    # every body the window replays, then the rest of the warm-up time
    t_warm, n_warm = time.perf_counter(), 0
    while n_warm < 1 or time.perf_counter() - t_warm < tr["warmup_seconds"]:
        step.reset()
        call(n_warm % len(seqs), 0, T)
        cell.sync()
        n_warm += 1
    harness.reset_peak(cell.device)
    pieces, clock, t0, t1, summary = harness.chunked_window(
        cell, len(seqs), T, tr["chunk"], call, step.reset)
    return harness.chunked_record(
        cell, seqs, pieces, clock, t0, t1, summary,
        harness.peak_bytes(cell.device), 1,
        {"capture_s": step.capture_seconds, "warmup_runs": n_warm,
         "warmup_s": t0 - t_warm})
