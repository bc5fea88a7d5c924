"""Small shared linear-algebra helpers for the solvers.

PyTorch port of ``eorb_slam_tpu/optim/linalg.py``. float32 normal equations
mix units (pixels^2 information against meter/radian state); Jacobi
pre-conditioning fixes the scale disparity before the Cholesky solve.

NaN convention: JAX's ``cho_factor`` returns NaN for a matrix that is not
positive definite, and the solvers' accept tests (``cost_new < cost``,
``isfinite(dx)``) rely on that NaN to reject the step. ``torch.linalg.
cholesky`` raises instead and ``cholesky_ex`` returns a finite partial
factor, so the solve here writes NaN wherever the factorization failed.

Status reads: ``torch.linalg.eigh`` and ``svd`` check cuSOLVER's status on
the host inside the operator (no ``_ex`` form), which makes the host wait
for the card. :func:`eigh_or_nan` therefore goes through
``ops/hopper_linalg.sym_eig``, a hand kernel on a CUDA tensor that reads
nothing back (LAPACK's ``eigh`` on a CPU tensor), and :func:`pinv_sym`
takes a symmetric pseudo-inverse through it instead of the SVD.
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch.ops import hopper_linalg


def solve_spd_jacobi(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for SPD H via Jacobi-preconditioned Cholesky.

    H: (...,n,n), b: (...,n). Returns x (...,n); all NaN where H is not
    positive definite."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp(d, min=1e-20))
    Hs = H * s[..., :, None] * s[..., None, :]
    bs = b * s
    L, info = torch.linalg.cholesky_ex(Hs)
    if L.is_cuda:
        # two triangular solves (cuBLAS), as the reference's cho_solve: a
        # batched cholesky_solve, also one batched by vmap, goes to MAGMA,
        # which allocates device memory per call and so cannot run inside
        # a CUDA-graph capture
        y = torch.linalg.solve_triangular(L, bs[..., None], upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    else:
        x = torch.cholesky_solve(bs[..., None], L)[..., 0]
    x = torch.where((info != 0)[..., None], torch.nan, x)
    return x * s


# Batched decompositions of RANSAC hypotheses: a degenerate hypothesis must
# come out as NaN (and score lowest), as it does in JAX, where torch's
# LAPACK/cuSOLVER calls may raise on a non-finite or singular member and stop
# the whole batch. Non-finite members are swapped for the identity before
# the call and their results set to NaN after it.

def _finite_members(A: torch.Tensor):
    ok = torch.isfinite(A).flatten(-2).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return ok, torch.where(ok[..., None, None], A, eye)


def _nan_where_not(ok: torch.Tensor, x: torch.Tensor, n_core: int) -> torch.Tensor:
    return torch.where(ok.view(ok.shape + (1,) * n_core), x, torch.nan)


def _eigh_plain(A: torch.Tensor):
    """``torch.linalg.eigh`` of (...,n,n), NaN for non-finite members: the
    ``sym_eig`` kernel's plain version, on either device."""
    ok, A = _finite_members(A)
    w, v = torch.linalg.eigh(A)
    return _nan_where_not(ok, w, 1), _nan_where_not(ok, v, 2)


def eigh_or_nan(A: torch.Tensor):
    """Eigendecomposition of symmetric (...,n,n): (w ascending, V with unit
    eigenvectors as columns); NaN for non-finite members. A CUDA tensor goes
    to the ``sym_eig`` kernel (n <= 16), which reads no status back; a CPU
    tensor gets the plain version, ``torch.linalg.eigh``. An eigenvector's
    sign is a convention."""
    return hopper_linalg.sym_eig(A) if A.is_cuda else _eigh_plain(A)


def pinv_sym(A: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Pseudo-inverse of symmetric (...,n,n) through :func:`eigh_or_nan` of
    ``(A + A^T) / 2``: ``V diag(1/w where |w| > eps, else 0) V^T``. For a
    symmetric A this is the SVD pseudo-inverse with the singular-value floor
    ``eps`` (``s = |w|``, ``U = V sign(w)``); NaN for a non-finite member."""
    w, V = eigh_or_nan(0.5 * (A + A.transpose(-1, -2)))
    w_inv = torch.where(torch.abs(w) > eps, 1.0 / w, 0.0)
    return (V * w_inv[..., None, :]) @ V.transpose(-1, -2)


def svd_or_nan(A: torch.Tensor):
    """``torch.linalg.svd`` of square (...,n,n); NaN for non-finite members."""
    ok, A = _finite_members(A)
    U, s, Vt = torch.linalg.svd(A)
    return (_nan_where_not(ok, U, 2), _nan_where_not(ok, s, 1),
            _nan_where_not(ok, Vt, 2))


def inv_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (...,n,n); NaN for non-finite or singular members (JAX's
    LU inverse gives inf/NaN there, ``torch.linalg.inv`` raises)."""
    ok, A = _finite_members(A)
    inv, info = torch.linalg.inv_ex(A)
    return _nan_where_not(ok & (info == 0), inv, 2)
