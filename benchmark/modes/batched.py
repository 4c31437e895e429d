"""Batched offline traffic: B recorded sequences at once on one card. One
graphed batched step is made; the B sequences run together from
``bstep.reset()`` through ``runner.run_frames_batched``, again and again
until the window closes. Frames are rendered at set-up, stay on the card,
and are laid out (B, chunk, H, W) a call, so no call copies them."""

from __future__ import annotations

import time

import torch

from svobench import harness, traffic as traffic_mod


def run(cell: harness.Cell) -> harness.Record:
    from stereo_svo_tpu_torch.engine import graphed, runner

    tr = cell.traffic
    T, B, chunk = tr["frames"], tr["batch"], tr["chunk"]
    seqs = cell.sequences(B)
    lefts = torch.stack([s[0] for s in seqs])
    rights = torch.stack([s[1] for s in seqs])
    chunks = {a: (lefts[:, a:a + chunk].contiguous(),
                  rights[:, a:a + chunk].contiguous())
              for a in range(0, T, chunk)}
    del lefts, rights
    pieces_lr = {}

    def piece(a, b):
        """Frames a..b of the B sequences, (B, b-a, H, W) contiguous: a
        whole chunk, or a part of one (the traced slice's), copied once."""
        if a % chunk == 0 and b == min(a + chunk, T):
            return chunks[a]
        if (a, b) not in pieces_lr:
            c = a - a % chunk
            pieces_lr[a, b] = tuple(x[:, a - c:b - c].contiguous()
                                    for x in chunks[c])
        return pieces_lr[a, b]
    keep = set(traffic_mod.compared(cell.seed, B, tr["compared"]))
    seqs = [s if b in keep else (None, None, s[2])
            for b, s in enumerate(seqs)]
    bstep = graphed.make_graphed_batched_step(cell.program_config(), B,
                                              cell.device)

    def call(_, a, b):
        return runner.run_frames_batched(bstep, *piece(a, b))[1]

    t_warm, n_warm = time.perf_counter(), 0
    while n_warm < 1 or time.perf_counter() - t_warm < tr["warmup_seconds"]:
        bstep.reset()
        for a in range(0, T, chunk):
            call(0, a, min(a + chunk, T))
        cell.sync()
        n_warm += 1
    harness.reset_peak(cell.device)
    pieces, clock, t0, t1, summary = harness.chunked_window(
        cell, 1, T, chunk, call, bstep.reset)
    return harness.chunked_record(
        cell, seqs, pieces, clock, t0, t1, summary,
        harness.peak_bytes(cell.device), B,
        {"capture_s": bstep.capture_seconds, "warmup_runs": n_warm,
         "warmup_s": t0 - t_warm})
