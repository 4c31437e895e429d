"""Small closed-form solvers — port of ``stereo_svo_tpu/ops/solve.py``
(``inv2x2`` and ``chol_solve_small``; ``inv3x3`` and ``cg_solve`` serve
only BA and come with it).

``chol_solve_small`` keeps the reference's unrolled Cholesky rather than
``torch.linalg.cholesky``: the library call raises on a matrix that is not
positive definite (and syncs the host to find out), where the unrolled form
floors the pivot and propagates like the reference.
"""

from __future__ import annotations

import torch


def inv2x2(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched closed-form 2x2 inverse: (…,2,2) → (…,2,2)."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    det = torch.where(torch.abs(det) > eps, det, torch.sign(det) * eps + eps)
    inv = torch.stack([torch.stack([d, -b], -1),
                       torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


def chol_solve_small(A: torch.Tensor, b: torch.Tensor,
                     jitter: float = 0.0) -> torch.Tensor:
    """SPD solve via statically-unrolled Cholesky, batched over leading
    dims. A: (…,n,n), b: (…,n) → x with A x = b."""
    n = A.shape[-1]
    if jitter:
        A = A + jitter * torch.eye(n, dtype=A.dtype, device=A.device)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)
