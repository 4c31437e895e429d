"""Trajectory evaluation: ATE / RPE, numpy (host-side) — the port's own
copy of ``stereo_svo_tpu/eval/ate.py`` (``tests/test_torch_config.py``
holds the two equal on seeded trajectories).
"""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares SE(3) (optionally Sim(3)) alignment est→gt.

    est, gt: (N,3) positions. Returns (s, R, t) with gt ≈ s·R·est + t.
    """
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    ec = est - mu_e
    gc = gt - mu_g
    H = ec.T @ gc / len(est)
    U, D, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    if with_scale:
        var_e = (ec ** 2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE over positions, after alignment)."""
    est_pos = np.asarray(est_pos, np.float64)
    gt_pos = np.asarray(gt_pos, np.float64)
    if align:
        s, R, t = align_umeyama(est_pos, gt_pos, with_scale)
        est_pos = (s * (R @ est_pos.T)).T + t
    err = est_pos - gt_pos
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe(est_T: np.ndarray, gt_T: np.ndarray, delta: int = 1):
    """Relative pose error over frame pairs (i, i+delta).

    est_T, gt_T: (N,3,4) camera→world poses.
    Returns (trans_rmse, rot_rmse_rad).
    """
    est_T = np.asarray(est_T, np.float64)
    gt_T = np.asarray(gt_T, np.float64)

    def rel(Ts, i, j):
        Ra, ta = Ts[i, :, :3], Ts[i, :, 3]
        Rb, tb = Ts[j, :, :3], Ts[j, :, 3]
        R = Ra.T @ Rb
        t = Ra.T @ (tb - ta)
        return R, t

    dts, drs = [], []
    n = len(est_T)
    for i in range(n - delta):
        Re, te = rel(est_T, i, i + delta)
        Rg, tg = rel(gt_T, i, i + delta)
        dR = Re.T @ Rg
        dt = tg - te
        # rotation angle via atan2(‖skew(dR)‖/2, (tr−1)/2): exact for all
        # angles, and small angles do not collapse to 0 as they would
        # through arccos((tr−1)/2)
        w = np.array([dR[2, 1] - dR[1, 2],
                      dR[0, 2] - dR[2, 0],
                      dR[1, 0] - dR[0, 1]])
        ang = np.arctan2(0.5 * np.linalg.norm(w),
                         0.5 * (np.trace(dR) - 1.0))
        dts.append(dt @ dt)
        drs.append(ang ** 2)
    return float(np.sqrt(np.mean(dts))), float(np.sqrt(np.mean(drs)))


def positions(T_wc: np.ndarray) -> np.ndarray:
    """(N,3,4) camera→world poses → (N,3) camera centers."""
    return np.asarray(T_wc)[:, :, 3]


__all__ = ["align_umeyama", "ate_rmse", "rpe", "positions"]
