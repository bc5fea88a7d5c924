"""The Gaussian event splat on Hopper: a hand-written CUDA kernel
(csrc/splat.cu) behind a ``torch.autograd.Function``.

Port of ``eorb_slam_tpu/ops/pallas_splat.py`` (``_splat_kernel`` launched by
``_splat_pallas``, wrapped by the ``splat`` custom VJP). The splat is the
hottest op of the event front-end: every chunk image, every MCI candidate
and every contrast-maximization step runs one (89 forward splats per L1
window at the default config).

- Forward: on a CUDA tensor it launches the kernel, or raises; on a CPU
  tensor it computes the plain separable version
  (``event/tensorize._splat_gauss_separable``). There is no other path.
- Backward: autograd through the plain separable form, as the TPU package's
  ``_splat_bwd`` does (the TPU had no backward kernel either).
- ``splat.launches`` counts kernel launches, so a run can show that its main
  path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_LIB = "splat"


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (or reuse) the library once per process; the bound C entry."""
    from eorb_slam_tpu_torch import _build

    lib = _build.load(_LIB)
    fn = lib.splat_gauss_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def build() -> None:
    """Build (or reuse) and load the kernel library now."""
    _kernel()


def _n_taps(trunc: float) -> int:
    # integer candidates h in floor(y - trunc) .. floor(y - trunc) + ntap - 1
    # cover every h with |h - y| <= trunc
    return int(math.floor(2.0 * trunc)) + 2


def _splat_cuda(xy: torch.Tensor, w_ev: torch.Tensor, H: int, W: int,
                sigma: float, trunc: float) -> torch.Tensor:
    fn = _kernel()
    n = xy.shape[0]
    if n >= 2**31 or H * W >= 2**31:
        raise ValueError(f"splat too large for int32 indexing: N={n}, {H}x{W}")
    out = torch.zeros((H, W), dtype=torch.float32, device=xy.device)
    with torch.cuda.device(xy.device):
        stream = torch.cuda.current_stream(xy.device).cuda_stream
        rc = fn(xy.data_ptr(), w_ev.data_ptr(), out.data_ptr(), n, H, W,
                1.0 / (2.0 * sigma * sigma), float(trunc), _n_taps(trunc),
                stream)
    if rc != 0:
        raise RuntimeError(f"splat kernel launch failed: cudaError {rc}")
    splat.launches += 1
    return out


def _check(xy: torch.Tensor, w_ev: torch.Tensor, H: int, W: int,
           trunc: float) -> None:
    if xy.dim() != 2 or xy.shape[1] != 2:
        raise ValueError(f"xy must be (N,2), got {tuple(xy.shape)}")
    if w_ev.shape != (xy.shape[0],):
        raise ValueError(f"w_ev must be ({xy.shape[0]},), got {tuple(w_ev.shape)}")
    if xy.dtype != torch.float32 or w_ev.dtype != torch.float32:
        raise TypeError(f"splat takes float32, got {xy.dtype} and {w_ev.dtype}")
    if xy.device != w_ev.device:
        raise ValueError(f"xy on {xy.device} but w_ev on {w_ev.device}")
    if xy.device.type not in ("cpu", "cuda"):
        raise ValueError(f"splat runs on cpu or cuda tensors, not {xy.device}")
    if not (xy.is_contiguous() and w_ev.is_contiguous()):
        raise ValueError("splat takes contiguous xy and w_ev")
    if H <= 0 or W <= 0:
        raise ValueError(f"bad image size {H}x{W}")
    if not 0.0 <= trunc < 7.0:
        raise ValueError(f"trunc must be in [0, 7), got {trunc}")


class _Splat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xy, w_ev, H, W, sigma, trunc):
        ctx.save_for_backward(xy, w_ev)
        ctx.cfg = (H, W, sigma, trunc)
        if xy.is_cuda:
            return _splat_cuda(xy, w_ev, H, W, sigma, trunc)
        from eorb_slam_tpu_torch.event.tensorize import _splat_gauss_separable

        return _splat_gauss_separable(xy, w_ev, H, W, sigma, trunc)

    @staticmethod
    def backward(ctx, g):
        """VJP through the separable form (as pallas_splat._splat_bwd)."""
        from eorb_slam_tpu_torch.event.tensorize import _splat_gauss_separable

        xy, w_ev = ctx.saved_tensors
        need_xy, need_w = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xy_ = xy.detach().requires_grad_(need_xy)
            w_ = w_ev.detach().requires_grad_(need_w)
            img = _splat_gauss_separable(xy_, w_, *ctx.cfg)
            wanted = [t for t, need in ((xy_, need_xy), (w_, need_w)) if need]
            grads = iter(torch.autograd.grad(img, wanted, g))
        g_xy = next(grads) if need_xy else None
        g_w = next(grads) if need_w else None
        return g_xy, g_w, None, None, None, None


def splat(xy: torch.Tensor, w_ev: torch.Tensor, H: int, W: int,
          sigma: float, trunc: float) -> torch.Tensor:
    """(H,W) f32 image of N events ``xy`` (N,2) f32 weighted by ``w_ev``
    (N,) f32; differentiable w.r.t. both."""
    _check(xy, w_ev, H, W, trunc)
    return _Splat.apply(xy, w_ev, H, W, sigma, trunc)


splat.launches = 0
