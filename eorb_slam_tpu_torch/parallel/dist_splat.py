"""Event-stream data parallelism: split the event batch over the processes
of a mesh, splat each block into a private accumulator, all-reduce the
(H,W) image.

Port of ``eorb_slam_tpu/parallel/dist_splat.py``. The reference consumes
event windows serially on one CPU thread (src/Event/EvImBuilder.cpp). The
Gaussian-splat accumulator is a sum over events, so the event axis splits
freely: each rank splats its block, and one all-reduce of the (H,W)
accumulator (~169 KiB at 240x180 f32) merges the partial images. The
payload is independent of the event count.

Each rank's block goes through the port's splat dispatch
(``event/tensorize.splat_gauss``): on a CUDA tensor the hand-written forward
kernel (ops/hopper_splat.py), once per rank per call; on a CPU tensor its
plain version. (The JAX package calls the plain separable form here, not
its Pallas kernel.)
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch.event import tensorize
from eorb_slam_tpu_torch.parallel import mesh_utils


def _block(mesh: mesh_utils.Mesh, *arrays):
    """This rank's block of each array's leading (event) axis."""
    return [mesh_utils.lm_sharding(mesh, a.dim()).place(a) for a in arrays]


def splat_gauss_sharded(
    mesh: mesh_utils.Mesh,
    xy: torch.Tensor,      # (N,2) event pixel coords, N divisible by the mesh size
    valid: torch.Tensor,   # (N,)
    pol: torch.Tensor,     # (N,) +-1 polarity
    H: int,
    W: int,
    sigma: float = 1.0,
    stencil: int = 5,
    use_polarity: bool = False,
) -> torch.Tensor:
    """Event-sharded ``tensorize.splat_gauss``: every rank passes the whole
    batch, splats its block and gets the all-reduced (H,W) image. Every
    rank of the mesh must call it."""
    xy_s, v_s, p_s = _block(mesh, xy, valid, pol)
    acc = tensorize.splat_gauss(xy_s, v_s, p_s, H, W, sigma=sigma,
                                stencil=stencil, use_polarity=use_polarity)
    return mesh.all_reduce(acc)


def _window_scores_sharded(mesh: mesh_utils.Mesh, ev: torch.Tensor,
                           valid: torch.Tensor, dt, H: int, W: int, sigma: float):
    """Event-sharded window statistics: the plain-histogram accumulator
    (truncation 2.5) and the window's event generation rate from the
    all-reduced count of valid events (the builder's gen-rate gate and
    histogram candidate on the sharded axis). ``ev`` (N,4) [ts x y p]."""
    ev_s, v_s = _block(mesh, ev, valid)
    acc = tensorize.splat_gauss(ev_s[:, 1:3], v_s, ev_s[:, 3], H, W, sigma=sigma)
    n = torch.sum(v_s.to(torch.float32))
    mesh.all_reduce(acc)
    mesh.all_reduce(n)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=n.device)
    rate = n / torch.clamp(dt, min=1e-9) / (H * W)
    return acc, rate
