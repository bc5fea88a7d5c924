"""Multi-process initialization + distributed-BA launch helpers.

Port of ``eorb_slam_tpu/parallel/multihost.py`` onto ``torch.distributed``.
The reference is a single process; this system's scale-out axis is a
process group, one rank per shard, across one or many hosts. One call per
process wires the group; the landmark axis of the BA mesh then spans every
rank, and the per-iteration all-reduce of the reduced camera system crosses
the process boundary (see parallel/dist_ba.py: the payload is the dense
(K,K,6,6) + (K,6) camera system, independent of the landmark count).

Typical use (one line near the top of each process):

    from eorb_slam_tpu_torch.parallel import multihost
    multihost.init("tcp://10.0.0.1:29500", num_processes=2,
                   process_id=int(os.environ["RANK"]))
    mesh = multihost.global_mesh()

The backend follows the device: NCCL for the card (one rank per card),
gloo for the CPU. Ranks that share one card use gloo, whose all-reduce
takes CUDA tensors (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from eorb_slam_tpu_torch._host import resolve_device
from eorb_slam_tpu_torch.parallel import dist_ba, mesh_utils


def init(coordinator: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         device=None,
         backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` for this process.

    ``coordinator`` is an init URL (``tcp://host:port``, ``file:///path``)
    or ``host:port``; with no arguments torch's own environment variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) are read. The backend is
    NCCL when ``device`` (None: the card) is a card, gloo on the CPU, unless
    ``backend`` names one."""
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    kw = {}
    if coordinator is not None:
        kw["init_method"] = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend, **kw)


def global_mesh(axis: str = mesh_utils.LM_AXIS, device=None) -> mesh_utils.Mesh:
    """1-D mesh over ALL processes (the landmark axis of the distributed
    BA), on ``device`` (None: the card)."""
    return mesh_utils.make_mesh(None, axis, device)


def shard_problem_global(prob, mesh: mesh_utils.Mesh):
    """This process's part of a BAProblem from per-process numpy data (the
    whole problem in every process): its slice of the landmark axis, the
    replicated leaves whole. A landmark axis that does not divide by the
    process count would leave tail rows owned by no process: it raises
    ValueError, and the caller pads the problem first."""
    return dist_ba.shard_problem(prob, mesh)


def comm_report(K: int, M: int, P: int, n_devices: int) -> dict:
    """Per-LM-iteration communication vs compute for the distributed BA
    (one all-reduce of the reduced camera system per iteration; landmark
    work stays local): bytes moved per iteration per rank, local FLOPs, and
    the ratio that decides whether a slow interconnect keeps up."""
    # all-reduce payload: S (K,K,6,6) + b (K,6) + cost scalars, float32
    comm_bytes = 4 * (K * K * 36 + K * 6 + 4)
    # local compute: per-observation residual/Jacobian (~2.5k flops) +
    # Schur contraction (P^2 * 36 per landmark) + landmark solves
    m_loc = M // max(n_devices, 1)
    flops = m_loc * P * 2500 + m_loc * P * P * 36 + m_loc * 27 * 4
    return {
        "psum_bytes_per_iter": comm_bytes,
        "local_flops_per_iter": flops,
        "flops_per_byte": flops / comm_bytes,
    }
