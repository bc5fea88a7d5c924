"""The Gaussian event splat on Hopper: hand-written CUDA kernels
(csrc/splat.cu) behind ``torch.autograd.Function``s, and the
contrast-maximization ascent over them as one kernel.

Port of ``eorb_slam_tpu/ops/pallas_splat.py``: ``_splat_kernel`` (launched by
``_splat_pallas``) becomes ``splat_gauss_forward``, and the dense autodiff
that its custom VJP ``_splat_bwd`` ran becomes ``splat_gauss_vjp``, a gather
of each event's <= 36 taps of the cotangent. The splat is the hottest op of
the event front-end. Its hottest caller, ``event/contrast_max``'s ascent
(1 + 2 * iters forwards and ``iters`` VJPs when it called the pair), runs
as one launch of ``splat_ascent_se2`` (:func:`splat_ascent_se2`): one
thread-block cluster of 16 blocks holds the image, a band of rows per
block, in its shared memory for every step, and each step is one trial
image and its gradient between two cluster barriers (csrc/splat.cu says
how, what bounds it and what was measured slower). Per L1 window at the
default config that leaves 8 forward splats (4 chunk images, 4 MCI
candidates) and one ascent.

What bounds the pair on the card is not the device (the bytes that must move
take 0.1-0.3 us, the image sits in L2) but launches and host time per launch,
so each kernel exists in two forms of its coordinate source:

- :func:`splat` (identity): the events' own ``(x, y)`` and f32 weights;
  differentiable w.r.t. both.
- :func:`splat_se2`: the kernel reads the unwarped ``(x, y)``, the event time
  ``t`` and ``(omega, vx, vy)`` from device memory and computes
  ``tensorize.warp_se2`` in registers; the weight may be a bool mask, read as
  it is. Differentiable w.r.t. ``params``: the VJP kernel chains the gather to
  ``dL/dparams`` and reduces it on the card in a fixed order (deterministic),
  with no warped coordinates, weight products or dense matrices in device
  memory. :func:`splat_se2_vjp` is that VJP without autograd.

The forward kernel sums each tap into a 64-bit fixed-point image (units of
2^-32) and converts it to f32, so on the card both directions give the same
bits every call, and the ascent ends at the same parameters every run. A
weight of magnitude 2^16 or more is outside the kernel's range and makes the
image NaN, as a non-finite weight does in both versions.

On a CUDA tensor every forward, backward and ascent launches its kernel, or
raises; on a CPU tensor the splat and its VJP compute the plain versions
beside them here (``_splat_gauss_separable``, ``warp_se2`` in front of it,
and :func:`_splat_vjp_plain`, the same gather formula in torch), and the
ascent's plain version is ``contrast_max._ascent_loop``. There is no other
path. ``splat.launches`` counts forward kernel launches,
``splat.vjp_launches`` VJP kernel launches and ``splat.ascent_launches``
ascent kernel launches, so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch._host import constant

_LIB = "splat"
# the ascent kernel's cluster (csrc/splat.cu: kAscentCluster, checked at
# build) and what a block of it may hold
ASCENT_CLUSTER = 16
ASCENT_SMEM_MAX = 232_448     # bytes of dynamic shared memory per block
ASCENT_MAX_EVENTS = 65_536    # csrc/splat.cu: kAscentMaxEvents, the limb sums' range
_ASCENT_HEADER = 2304         # csrc/splat.cu: kAscentHeader
_ASCENT_LIST = 3072 * 24      # csrc/splat.cu: kAscentList entries of 24 bytes
ASCENT_MAX_TAPS = 8           # csrc/splat.cu: kAscentTap, taps per row and column


@functools.lru_cache(maxsize=None)
def _kernels():
    """Build (or reuse) the library once per process; the bound C entries
    (forward, vjp, ascent) and the pair's threads per block."""
    from eorb_slam_tpu_torch import _build

    lib = _build.load(_LIB)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.splat_gauss_forward
    fwd.restype = i32
    fwd.argtypes = [ptr, ptr, ptr, i32, ptr, f32, f32, ptr, ptr,
                    i32, i32, i32, f32, f32, i32, ptr]
    vjp = lib.splat_gauss_vjp
    vjp.restype = i32
    vjp.argtypes = [ptr, ptr, ptr, ptr, i32, ptr, f32, f32, ptr, ptr, ptr, ptr,
                    i32, i32, i32, f32, f32, i32, ptr]
    asc = lib.splat_ascent_se2
    asc.restype = i32
    asc.argtypes = [ptr, ptr, ptr, i32, ptr, f32, f32, f32, i32, ptr, ptr,
                    i32, i32, i32, f32, f32, i32, f32, f32, i32, i32, i32, ptr]
    lib.splat_threads.restype = i32
    lib.splat_ascent_cluster.restype = i32
    lib.splat_ascent_attrs.restype = i32
    lib.splat_ascent_attrs.argtypes = [ptr]
    if lib.splat_ascent_cluster() != ASCENT_CLUSTER:
        raise RuntimeError(f"the ascent kernel runs clusters of "
                           f"{lib.splat_ascent_cluster()}, its wrapper lays out "
                           f"{ASCENT_CLUSTER}")
    return fwd, vjp, asc, lib.splat_threads(), lib.splat_ascent_attrs


def build() -> None:
    """Build (or reuse) and load the kernel library now."""
    _kernels()


def ascent_attrs() -> dict:
    """The ascent kernel as compiled (``cudaFuncGetAttributes``): registers
    and local (stack) bytes per thread, static shared bytes and threads per
    block."""
    out = (ctypes.c_int * 4)()
    rc = _kernels()[4](out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes of the ascent kernel failed: cudaError {rc}")
    return dict(zip(("registers", "local_bytes", "static_smem", "threads"), out))


def _n_taps(trunc: float) -> int:
    # integer candidates h in floor(y - trunc) .. floor(y - trunc) + ntap - 1
    # cover every h with |h - y| <= trunc
    return int(math.floor(2.0 * trunc)) + 2


def _ptr(t):
    return None if t is None else t.data_ptr()


def _splat_cuda(xy, t, w, params, center, H, W, sigma, trunc):
    """Launch the forward kernel: identity form if ``t`` is None, else SE2.
    The kernel sums in 64-bit fixed point (scratch: the H*W sums and a
    poison flag), so the image is the same bits every call."""
    fwd = _kernels()[0]
    out = torch.empty((H, W), dtype=torch.float32, device=xy.device)
    scratch = torch.empty((H * W + 1,), dtype=torch.int64, device=xy.device)
    with torch.cuda.device(xy.device):
        rc = fwd(xy.data_ptr(), _ptr(t), w.data_ptr(), w.dtype != torch.float32,
                 _ptr(params), center[0], center[1], out.data_ptr(),
                 scratch.data_ptr(), xy.shape[0], H, W,
                 1.0 / (2.0 * sigma * sigma), trunc, _n_taps(trunc),
                 torch.cuda.current_stream(xy.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"splat kernel launch failed: cudaError {rc}")
    splat.launches += 1
    return out


def _vjp_cuda(g, xy, t, w, params, center, H, W, sigma, trunc,
              need_xy=False, need_w=False):
    """Launch the VJP kernel. Identity form (``t`` None): (g_xy, g_w), each
    None unless asked for. SE2 form: (3,) dL/dparams."""
    _, vjp, _, threads, _ = _kernels()
    n, dev = xy.shape[0], xy.device
    g = g.contiguous()
    g_xy = g_w = partials = g_params = None
    if t is None:
        g_xy = torch.empty((n, 2), dtype=torch.float32, device=dev) if need_xy else None
        g_w = torch.empty((n,), dtype=torch.float32, device=dev) if need_w else None
    else:
        partials = torch.empty((-(-n // threads), 3), dtype=torch.float32, device=dev)
        g_params = torch.empty((3,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = vjp(g.data_ptr(), xy.data_ptr(), _ptr(t), w.data_ptr(),
                 w.dtype != torch.float32, _ptr(params), center[0], center[1],
                 _ptr(g_xy), _ptr(g_w), _ptr(partials), _ptr(g_params),
                 n, H, W, 1.0 / (2.0 * sigma * sigma), trunc, _n_taps(trunc),
                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"splat VJP kernel launch failed: cudaError {rc}")
    splat.vjp_launches += 1
    return (g_xy, g_w) if t is None else g_params


# ----------------------------------------------------------- plain versions


def _splat_vjp_plain(g, xy, w_ev, H, W, sigma, trunc):
    """Plain version of the VJP kernel: the gather form in torch.

    For each event the taps ``floor(y - trunc) + 0..ntap-1`` (rows) and
    ``floor(x - trunc) + 0..ntap-1`` (columns) that pass the forward's test
    are gathered from ``g`` (H,W) with clamped indices and summed against
    the Gaussian and its derivative. Returns (g_xy (N,2), g_w (N,)). NaN
    where autograd through the separable form is not finite: every output
    of an event with a NaN coordinate, the x (y) derivative where x (y) is
    +-inf, both derivatives under a non-finite weight."""
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    x, y = xy[:, 0], xy[:, 1]
    near = ((x > -trunc - 1.0) & (x < W + trunc + 1.0)
            & (y > -trunc - 1.0) & (y < H + trunc + 1.0))
    k = torch.arange(_n_taps(trunc), dtype=xy.dtype, device=xy.device)

    def taps(p, size):
        p = torch.where(near, p, torch.zeros_like(p))[:, None]
        idx = torch.floor(p - trunc) + k                       # (N,ntap)
        d = idx - p
        ok = (idx >= 0) & (idx < size) & (torch.abs(d) <= trunc) & near[:, None]
        return (torch.exp(-d * d * inv2s2) * ok, d,
                idx.clamp(0, size - 1).to(torch.int64))

    gx, dx, ci = taps(x, W)
    gy, dy, hi = taps(y, H)
    gk = g[hi[:, :, None], ci[:, None, :]] * gy[:, :, None] * gx[:, None, :]
    s = gk.sum(dim=(1, 2))
    sx = (gk * dx[:, None, :]).sum(dim=(1, 2)) * (2.0 * inv2s2)
    sy = (gk * dy[:, :, None]).sum(dim=(1, 2)) * (2.0 * inv2s2)

    nan = torch.full_like(s, torch.nan)
    nan_xy = torch.isnan(x) | torch.isnan(y)
    bad_w = ~torch.isfinite(w_ev)
    g_x = torch.where(nan_xy | bad_w | torch.isinf(x), nan, w_ev * sx)
    g_y = torch.where(nan_xy | bad_w | torch.isinf(y), nan, w_ev * sy)
    return torch.stack([g_x, g_y], dim=1), torch.where(nan_xy, nan, s)


def _splat_se2_plain(xy, t, w, params, center, H, W, sigma, trunc):
    """Plain version of the SE2 forward: ``warp_se2`` then the separable
    splat."""
    from eorb_slam_tpu_torch.event.tensorize import _splat_gauss_separable, warp_se2

    xy_w = warp_se2(xy, t, params, constant(tuple(center), xy.dtype, xy.device))
    return _splat_gauss_separable(xy_w, w.to(xy.dtype), H, W, sigma, trunc)


def _splat_se2_vjp_plain(g, xy, t, w, params, center, H, W, sigma, trunc):
    """Plain version of the SE2 VJP: the gather at the warped coordinates,
    chained to (3,) dL/d(omega, vx, vy)."""
    from eorb_slam_tpu_torch.event.tensorize import warp_se2

    xy_w = warp_se2(xy, t, params, constant(tuple(center), xy.dtype, xy.device))
    g_w_xy, _ = _splat_vjp_plain(g, xy_w, w.to(xy.dtype), H, W, sigma, trunc)
    gx, gy = g_w_xy[:, 0], g_w_xy[:, 1]
    a = params[0] * t
    ca, sa = torch.cos(a), torch.sin(a)
    rx, ry = xy[:, 0] - center[0], xy[:, 1] - center[1]
    d_omega = t * (gx * (-sa * rx - ca * ry) + gy * (ca * rx - sa * ry))
    return torch.stack([d_omega.sum(), -(t * gx).sum(), -(t * gy).sum()])


# ----------------------------------------------------------------- wrappers


def _check(xy, w, H, W, trunc, mask_ok=False) -> None:
    if xy.dim() != 2 or xy.shape[1] != 2:
        raise ValueError(f"xy must be (N,2), got {tuple(xy.shape)}")
    if w.shape != (xy.shape[0],):
        raise ValueError(f"w_ev must be ({xy.shape[0]},), got {tuple(w.shape)}")
    w_types = (torch.float32, torch.bool) if mask_ok else (torch.float32,)
    if xy.dtype != torch.float32 or w.dtype not in w_types:
        raise TypeError(f"splat takes float32, got {xy.dtype} and {w.dtype}")
    if xy.device != w.device:
        raise ValueError(f"xy on {xy.device} but w_ev on {w.device}")
    if xy.device.type not in ("cpu", "cuda"):
        raise ValueError(f"splat runs on cpu or cuda tensors, not {xy.device}")
    if not (xy.is_contiguous() and w.is_contiguous()):
        raise ValueError("splat takes contiguous xy and w_ev")
    if H <= 0 or W <= 0:
        raise ValueError(f"bad image size {H}x{W}")
    if not 0.0 <= trunc < 7.0:
        raise ValueError(f"trunc must be in [0, 7), got {trunc}")
    if xy.shape[0] >= 2**31 or H * W >= 2**31:
        raise ValueError(f"splat too large for int32 indexing: N={xy.shape[0]}, {H}x{W}")


def _check_se2(xy, t, w, params, H, W, trunc) -> None:
    _check(xy, w, H, W, trunc, mask_ok=True)
    if t.shape != w.shape or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"t must be contiguous float32 ({xy.shape[0]},), got "
                         f"{t.dtype} {tuple(t.shape)}")
    if (params.shape != (3,) or params.dtype != torch.float32
            or not params.is_contiguous()):
        raise ValueError(f"params must be contiguous float32 (3,), got "
                         f"{params.dtype} {tuple(params.shape)}")
    if t.device != xy.device or params.device != xy.device:
        raise ValueError(f"xy on {xy.device} but t on {t.device} and params "
                         f"on {params.device}")
    if xy.requires_grad or t.requires_grad or w.requires_grad:
        raise ValueError("splat_se2 is differentiable w.r.t. params only")


class _Splat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xy, w_ev, H, W, sigma, trunc):
        ctx.save_for_backward(xy, w_ev)
        ctx.cfg = (H, W, sigma, trunc)
        if xy.is_cuda:
            return _splat_cuda(xy, None, w_ev, None, (0.0, 0.0), *ctx.cfg)
        from eorb_slam_tpu_torch.event.tensorize import _splat_gauss_separable

        return _splat_gauss_separable(xy, w_ev, *ctx.cfg)

    @staticmethod
    def backward(ctx, g):
        xy, w_ev = ctx.saved_tensors
        need_xy, need_w = ctx.needs_input_grad[:2]
        if xy.is_cuda:
            g_xy, g_w = _vjp_cuda(g, xy, None, w_ev, None, (0.0, 0.0), *ctx.cfg,
                                  need_xy=need_xy, need_w=need_w)
        else:
            g_xy, g_w = _splat_vjp_plain(g, xy, w_ev, *ctx.cfg)
        return (g_xy if need_xy else None, g_w if need_w else None,
                None, None, None, None)


class _SplatSe2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, xy, t, w, center, H, W, sigma, trunc):
        ctx.save_for_backward(params, xy, t, w)
        ctx.cfg = (center, H, W, sigma, trunc)
        if xy.is_cuda:
            return _splat_cuda(xy, t, w, params, *ctx.cfg)
        return _splat_se2_plain(xy, t, w, params, *ctx.cfg)

    @staticmethod
    def backward(ctx, g):
        params, xy, t, w = ctx.saved_tensors
        vjp = _vjp_cuda if xy.is_cuda else _splat_se2_vjp_plain
        return (vjp(g, xy, t, w, params, *ctx.cfg),) + (None,) * 8


def splat(xy: torch.Tensor, w_ev: torch.Tensor, H: int, W: int,
          sigma: float, trunc: float) -> torch.Tensor:
    """(H,W) f32 image of N events ``xy`` (N,2) f32 weighted by ``w_ev``
    (N,) f32; differentiable w.r.t. both."""
    _check(xy, w_ev, H, W, trunc)
    return _Splat.apply(xy, w_ev, H, W, float(sigma), float(trunc))


def splat_se2(xy: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
              params: torch.Tensor, center, H: int, W: int,
              sigma: float, trunc: float) -> torch.Tensor:
    """(H,W) f32 image of N events warped by ``tensorize.warp_se2(xy, t,
    params, center)``, the warp computed inside the kernel.

    ``xy`` (N,2) f32 unwarped coordinates, ``t`` (N,) f32 event times,
    ``w`` (N,) f32 weights or a bool mask, ``params`` (3,) f32 [omega, vx,
    vy] on the events' device (it is never read on the host), ``center`` two
    Python floats. Differentiable w.r.t. ``params`` only."""
    _check_se2(xy, t, w, params, H, W, trunc)
    center = (float(center[0]), float(center[1]))
    return _SplatSe2.apply(params, xy, t, w, center, H, W, float(sigma),
                           float(trunc))


def splat_se2_vjp(g: torch.Tensor, xy: torch.Tensor, t: torch.Tensor,
                  w: torch.Tensor, params: torch.Tensor, center, H: int, W: int,
                  sigma: float, trunc: float) -> torch.Tensor:
    """(3,) dL/d(omega, vx, vy) of :func:`splat_se2` for the image cotangent
    ``g`` (H,W), without autograd: the VJP kernel on the card,
    :func:`_splat_se2_vjp_plain` on the CPU."""
    _check_se2(xy, t, w, params, H, W, trunc)
    cfg = ((float(center[0]), float(center[1])), H, W, float(sigma), float(trunc))
    vjp = _vjp_cuda if xy.is_cuda else _splat_se2_vjp_plain
    return vjp(g, xy, t, w, params, *cfg)


class AscentLayout(NamedTuple):
    """How one call of the ascent kernel lies over its cluster's blocks."""

    rows: int         # image rows per block (the last block may own fewer)
    per_rank: int     # events per block, a multiple of 16 (the last may hold fewer)
    smem_bytes: int   # dynamic shared memory of one block


def ascent_layout(n: int, H: int, W: int) -> AscentLayout:
    """The ascent kernel's layout of ``n`` events on an (H, W) image: each of
    the ASCENT_CLUSTER blocks holds a 2,304-byte header, a band of ``rows``
    image rows as three 32-bit limb sums a pixel and as f32 (16 bytes a
    pixel), ``per_rank`` warped events (25 bytes each: (x, y, w, t), (a, b)
    and a band code) and a list of 3,072 events that reach its rows (24
    bytes each). The raw events stay in device memory, so the
    weight's type does not change the layout. Raises ValueError where a
    block would need more than ASCENT_SMEM_MAX bytes, or for more than
    ASCENT_MAX_EVENTS events."""
    rows = -(-H // ASCENT_CLUSTER)
    per_rank = -(-n // (16 * ASCENT_CLUSTER)) * 16
    band = -(-rows * W * 12 // 16) * 16 + -(-rows * W * 4 // 16) * 16
    smem = _ASCENT_HEADER + band + per_rank * 25 + _ASCENT_LIST
    if smem > ASCENT_SMEM_MAX:
        raise ValueError(
            f"the ascent kernel holds a {H}x{W} image and {n} events in the shared "
            f"memory of {ASCENT_CLUSTER} blocks: {smem} bytes per block, above the "
            f"{ASCENT_SMEM_MAX} a block may use")
    if n > ASCENT_MAX_EVENTS:
        raise ValueError(f"the ascent kernel takes at most {ASCENT_MAX_EVENTS} events "
                         f"(its limb sums' range), got {n}")
    return AscentLayout(rows, per_rank, smem)


def splat_ascent_se2(xy: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
                     params0: torch.Tensor, center, H: int, W: int, iters: int,
                     sigma: float, trunc: float, lr: float, trace=None):
    """``contrast_max._ascent_loop`` as one launch of the ascent kernel:
    ``iters`` steps of normalized-gradient ascent on the contrast of
    ``splat_se2(xy, t, w, p, center, H, W, sigma, trunc)`` from ``params0``
    (3,). Returns (params (3,), best contrast (), start contrast ()), all on
    the card and never read back; with ``trace``, an (iters + 1, 4) f32
    tensor on the card, also (omega, vx, vy, contrast) of the start and of
    every trial point. CUDA tensors only: on the CPU the ascent is
    ``contrast_max._ascent_loop``.

    Every trial image is the forward's fixed-point sum (its taps enter
    three 32-bit limb sums with adds that return nothing), so each contrast,
    and every accept decision with it, has the bits the pair's forward
    gives; the gradient is an f32 sum in a fixed order, the same bits every
    call. At most ASCENT_MAX_EVENTS events (the limb sums' range) and
    ``trunc < 3.5``."""
    _check_se2(xy, t, w, params0, H, W, trunc)
    if _n_taps(trunc) > ASCENT_MAX_TAPS:
        raise ValueError(f"the ascent kernel takes trunc < 3.5, got {trunc}")
    if not xy.is_cuda:
        raise ValueError("splat_ascent_se2 runs on CUDA tensors; on the CPU the "
                         "ascent is contrast_max._ascent_loop")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    dev, n = xy.device, xy.shape[0]
    if trace is not None and (trace.shape != (iters + 1, 4) or trace.dtype != torch.float32
                              or not trace.is_contiguous() or trace.device != dev):
        raise ValueError(f"trace must be contiguous float32 ({iters + 1}, 4) on {dev}, "
                         f"got {trace.dtype} {tuple(trace.shape)} on {trace.device}")
    lay = ascent_layout(n, H, W)
    asc = _kernels()[2]
    # the kernel's bulk copies read 16-byte aligned rows
    xy, t, w = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (xy, t, w))
    out = torch.empty((5,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = asc(xy.data_ptr(), t.data_ptr(), w.data_ptr(), w.dtype != torch.float32,
                 params0.data_ptr(), float(center[0]), float(center[1]), float(lr), iters,
                 out.data_ptr(), _ptr(trace), n, H, W, 1.0 / (2.0 * sigma * sigma),
                 float(trunc), _n_taps(trunc), 1.0 / (H * W), 2.0 / max(H, W),
                 lay.rows, lay.per_rank, lay.smem_bytes,
                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"splat ascent kernel launch failed: cudaError {rc}")
    splat.ascent_launches += 1
    return out[:3], out[3], out[4]


splat.launches = 0
splat.vjp_launches = 0
splat.ascent_launches = 0
_graphs.counted(splat, "launches", "vjp_launches", "ascent_launches")
