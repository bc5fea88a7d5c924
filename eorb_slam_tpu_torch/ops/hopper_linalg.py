"""A status-free batched symmetric eigendecomposition on Hopper: the
hand-written CUDA kernel of csrc/sym_eig.cu behind :func:`sym_eig`.

It replaces no TPU kernel. ``torch.linalg.eigh`` (and ``torch.linalg.svd``,
which ``optim/linalg.pinv_sym`` replaces by an eigendecomposition) check
cuSOLVER's status on the host inside the operator, and neither has an
``_ex`` form, so each call made the host wait for the card: four times per
keyframe (the triangulations' 4x4 ``AtA``) and about three times per
inertial frame (the marginalized prior's 15x15 blocks), where the JAX
reference dispatches the whole step once. The kernel computes
``jnp.linalg.eigh``'s function (the symmetric part's eigenvalues ascending
and unit eigenvectors as columns) by parallel Jacobi in float64, one warp
per matrix, for 2 <= n <= 16, reports no status and reads nothing back; a
non-finite member comes out NaN and leaves the others alone.

On a CUDA tensor :func:`sym_eig` launches the kernel, or raises; on a CPU
tensor it computes the plain version, ``optim/linalg._eigh_plain``
(``torch.linalg.eigh``, LAPACK, what JAX runs on the CPU, with non-finite
members set to NaN). There is no other path. ``sym_eig.by_n``
counts kernel launches by matrix size n, so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from eorb_slam_tpu_torch import _graphs

_LIB = "sym_eig"
MAX_N = 16


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (or reuse) the library once per process; the bound C entry."""
    from eorb_slam_tpu_torch import _build

    lib = _build.load(_LIB)
    ptr = ctypes.c_void_p
    fn = lib.sym_eig
    fn.restype = ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr]
    return fn


def build() -> None:
    """Build (or reuse) and load the kernel library now."""
    _kernel()


def _sym_eig_cuda(A: torch.Tensor, rotations: torch.Tensor | None = None):
    """Launch the kernel on contiguous (B,n,n) ``A``. ``rotations``, if
    given, a (B,) int32 tensor that receives each member's number of Jacobi
    rotations. Returns (w (B,n), V (B,n,n))."""
    fn = _kernel()
    B, n, dev = A.shape[0], A.shape[-1], A.device
    w = torch.empty((B, n), dtype=A.dtype, device=dev)
    V = torch.empty((B, n, n), dtype=A.dtype, device=dev)
    if B == 0:
        return w, V
    with torch.cuda.device(dev):
        rc = fn(A.data_ptr(), w.data_ptr(), V.data_ptr(),
                None if rotations is None else rotations.data_ptr(), B, n,
                int(A.dtype == torch.float64),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sym_eig kernel launch failed: cudaError {rc}")
    sym_eig.by_n[n] = sym_eig.by_n.get(n, 0) + 1
    return w, V


def _check(A: torch.Tensor) -> None:
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"sym_eig takes (...,n,n), got {tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sym_eig takes float32 or float64, got {A.dtype}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sym_eig runs on cpu or cuda tensors, not {A.device}")
    if A.is_cuda and not 2 <= A.shape[-1] <= MAX_N:
        raise ValueError(f"the sym_eig kernel takes 2 <= n <= {MAX_N}, got {A.shape[-1]}")


def sym_eig(A: torch.Tensor):
    """Eigendecomposition of the symmetric (...,n,n) ``A``: (w (...,n)
    ascending, V (...,n,n) unit eigenvectors as columns); NaN in a
    non-finite member's outputs. The kernel takes the symmetric part
    ``(A + A^T) / 2``, the plain version ``A``'s lower triangle: the same
    for a symmetric ``A``. The sign of an eigenvector is a convention."""
    _check(A)
    if not A.is_cuda:
        from eorb_slam_tpu_torch.optim import linalg

        return linalg._eigh_plain(A)
    n = A.shape[-1]
    w, V = _sym_eig_cuda(A.reshape(-1, n, n).contiguous())
    return w.reshape(A.shape[:-1]), V.reshape(A.shape)


sym_eig.by_n = {}     # kernel launches by matrix size n
_graphs.counted(sym_eig, "by_n")
