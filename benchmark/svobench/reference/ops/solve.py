"""Small closed-form solvers — port of ``stereo_svo_tpu/ops/solve.py``.

``chol_solve_small`` keeps the reference's unrolled Cholesky rather than
``torch.linalg.cholesky``: the library call raises on a matrix that is not
positive definite (and syncs the host to find out), where the unrolled form
floors the pivot and propagates like the reference.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._functorch import is_batchedtensor


@contextlib.contextmanager
def batched_linalg(x: torch.Tensor):
    """Around a factorisation that ``torch.func.vmap`` batches on CUDA
    (``x`` a batched CUDA tensor): PyTorch's linear-algebra backend set to
    cuSOLVER (with cuBLAS's batched LU) for the call and restored after
    it. Its default sends some batched factorisations (a batched LU above
    128 rows) to MAGMA, whose routines a CUDA graph does not capture;
    cuSOLVER's and cuBLAS's run on the stream, sync nothing and capture.
    A call that is not batched (the single-sequence step) keeps the
    default backend, and with it its results bit for bit. The setting is
    process-wide while the call runs."""
    if not (is_batchedtensor(x) and x.device.type == "cuda"):
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


def cholesky_solve_upper(U: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (UᵀU) x = rhs for an upper Cholesky factor U (…,n,n), rhs
    (…,n,k): two triangular solves, cuBLAS's trsm on CUDA. Not
    ``torch.cholesky_solve``: at batch 1 it calls cuSOLVER's potrs, which
    under graph capture allocates its scratch with a stream-ordered
    allocation, a node a conditional graph body may not hold."""
    y = torch.linalg.solve_triangular(U.mT, rhs, upper=False)
    return torch.linalg.solve_triangular(U, y, upper=True)


def lu_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b, A (…,n,n), b (…,n), by LU with partial pivoting
    (``torch.linalg.lu_factor_ex``: no check, no host sync), then the row
    permutation and two triangular solves (cuBLAS's trsm on CUDA). Not
    ``torch.linalg.solve_ex`` or ``lu_solve``: their cuSOLVER getrs under
    graph capture allocates its scratch with a stream-ordered allocation,
    a node a conditional graph body may not hold."""
    LU, pivots, _ = torch.linalg.lu_factor_ex(A)
    P, L, U = torch.lu_unpack(LU, pivots)
    y = torch.linalg.solve_triangular(L, P.mT @ b[..., None], upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(U, y, upper=True)[..., 0]


def inv2x2(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched closed-form 2x2 inverse: (…,2,2) → (…,2,2)."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    det = torch.where(torch.abs(det) > eps, det, torch.sign(det) * eps + eps)
    inv = torch.stack([torch.stack([d, -b], -1),
                       torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


def inv3x3(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched adjugate 3x3 inverse: (…,3,3) → (…,3,3)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    det = torch.where(torch.abs(det) > eps, det, torch.sign(det) * eps + eps)
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return adj / det[..., None, None]


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


def cg_solve(A: torch.Tensor, b: torch.Tensor, iters: int = 25,
             x0: torch.Tensor | None = None) -> torch.Tensor:
    """Fixed-iteration Jacobi-preconditioned conjugate gradient for SPD A
    (…,n,n), b (…,n). The matvecs are float32 products (TF32 stays off)."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    Minv = 1.0 / torch.clamp(torch.abs(diag), min=1e-12)

    def mv(v):
        return torch.einsum("...ij,...j->...i", A, v)

    def safe(d):
        return torch.where(torch.abs(d) > 1e-20, d, torch.full_like(d, 1e-20))

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - mv(x)
    z = Minv * r
    p = z
    rz = torch.sum(r * z, -1, keepdim=True)
    for _ in range(iters):
        Ap = mv(p)
        alpha = rz / safe(torch.sum(p * Ap, -1, keepdim=True))
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv * r
        rz_new = torch.sum(r * z, -1, keepdim=True)
        p = z + rz_new / safe(rz) * p
        rz = rz_new
    return x
