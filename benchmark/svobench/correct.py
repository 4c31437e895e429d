"""The comparison that decides ``correct``.

The reference (``svobench/reference``: the program's eager step frozen in
plain PyTorch, float32, TF32 off) runs from the first frame of every
compared sequence on the same frames the program was given, once the
window has closed and the program is freed. Each run of such a sequence in
the window is held against it frame by frame; every sequence the window ran
is held to the configuration's accuracy guarantees against the ground
truth. Each number is printed beside its limit."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import harness
from .reference import precision
from .reference.eval import ate


def reference_run(config: dict, lefts, rights, n: int, device,
                  tf32: bool = False) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """The reference over the first ``n`` frames: (poses (n,3,4),
    tracking_ok (n,), kf_inserted (n,)). ``tf32``: the control, one step
    below the configuration's precision."""
    from .reference import config as rconfig
    from .reference.engine import state as rstate, step as rstep

    cfg = harness._svo_config(rconfig.SvoConfig, rconfig.CameraConfig,
                              config)
    poses, ok, kf = [], [], []
    with precision(tf32), torch.inference_mode():
        st = rstate.init_state(cfg, device)
        step = rstep.make_step(cfg)
        flags = None
        for i in range(n):
            left = torch.as_tensor(lefts[i], dtype=torch.float32,
                                   device=device).contiguous()
            right = torch.as_tensor(rights[i], dtype=torch.float32,
                                    device=device).contiguous()
            st, out, flags = step(st, left, right, flags)
            poses.append(out.T_wc)
            ok.append(out.tracking_ok)
            kf.append(out.kf_inserted)
    return (torch.stack(poses).cpu().numpy(),
            torch.stack(ok).cpu().numpy(), torch.stack(kf).cpu().numpy())


def against(runs, ref) -> Dict[str, float]:
    """Every run (poses, tracking_ok, kf_inserted over its first t frames)
    against the reference's: the widest position gap (m) and the frames
    whose tracking or keyframe decision differs."""
    gap, mism = 0.0, 0
    for poses, ok, kf in runs:
        t = len(poses)
        d = np.linalg.norm(poses[:, :, 3].astype(np.float64)
                           - ref[0][:t, :, 3].astype(np.float64), axis=-1)
        gap = max(gap, float(d.max()) if t else 0.0)
        mism += int(np.sum((ok != ref[1][:t]) | (kf != ref[2][:t])))
    return {"pose_gap_m": gap, "decision_mismatches": mism}


def ate_gate(guarantees: dict, gt: np.ndarray) -> float:
    """The configuration's ATE limit for a sequence of ground truth
    ``gt``: a fixed limit, or the larger of it and a share of the
    travel."""
    travel = float(np.sum(np.linalg.norm(
        np.diff(gt[:, :, 3], axis=0), axis=-1)))
    return max(guarantees["ate_rmse_m_max"],
               guarantees.get("ate_travel_share_max", 0.0) * travel)


def checks(cell: harness.Cell, record: harness.Record, device=None,
           tf32: bool = False) -> List[Tuple[str, float, float, str]]:
    """(name, value, limit, rule) for every number compared, the rule
    "<=" or ">=" that the value has to keep to: the widest pose gap to the
    reference, the frames whose tracking or keyframe decision differs from
    the reference's (none may), and every sequence's accuracy against the
    ground truth."""
    device = cell.device if device is None else device
    limits = cell.traffic["limits"]
    gap, mism, frames = 0.0, 0, 0
    for comp in record.compared:
        n = max((len(r[0]) for r in comp.runs), default=0)
        if n == 0:
            continue
        ref = reference_run(cell.config, comp.lefts, comp.rights, n, device,
                            tf32)
        got = against(comp.runs, ref)
        gap = max(gap, got["pose_gap_m"])
        mism += got["decision_mismatches"]
        frames += sum(len(r[0]) for r in comp.runs)
    g = cell.config["guarantees"]
    worst, worst_gate, track = 0.0, g["ate_rmse_m_max"], 1.0
    for poses, gt, ok in record.gated:
        if len(poses) < 2:
            continue
        err = ate.ate_rmse(ate.positions(poses), ate.positions(gt))
        gate = ate_gate(g, gt)
        if err / gate > worst / worst_gate:
            worst, worst_gate = err, gate
        track = min(track, float(np.mean(ok)))
    return [("frames_compared", frames, 1, ">="),
            ("pose_gap_m", gap, limits["pose_gap_m"], "<="),
            ("decision_mismatches", mism, 0, "<="),
            ("ate_rmse_m", worst, worst_gate, "<="),
            ("tracking_ok_frac", track, g["tracking_ok_frac_min"], ">=")]


def holds(value: float, limit: float, rule: str) -> bool:
    if value != value:            # NaN never holds
        return False
    return value <= limit if rule == "<=" else value >= limit
