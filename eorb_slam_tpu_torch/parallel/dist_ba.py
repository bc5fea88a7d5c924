"""Distributed bundle adjustment: landmarks sharded over the processes of a
mesh.

Port of ``eorb_slam_tpu/parallel/dist_ba.py``, in place of the reference's
single-threaded g2o BA (src/Optimizer.cc): each rank owns a block of the
landmark-major observation table, computes its partial reduced camera
system (the Schur pieces), all-reduces it, solves the dense 6Kx6K system
redundantly on every rank, and back-substitutes its own landmark block.
Communication per LM iteration is one all-reduce of (K,K,6,6) + (K,6) and
one of the cost, independent of the number of landmarks and observations.
"""

from __future__ import annotations

from eorb_slam_tpu_torch.optim import schur_ba
from eorb_slam_tpu_torch.parallel import mesh_utils
from eorb_slam_tpu_torch.parallel.mesh_utils import LM_AXIS


def problem_specs() -> schur_ba.BAProblem:
    """Per leaf of a BAProblem: LM_AXIS where the leaf is sharded on the
    landmark axis, None where every rank holds it whole."""
    return schur_ba.BAProblem(
        cam_params=None,
        kf_T=None,
        kf_fixed=None,
        kf_valid=None,
        lm_pos=LM_AXIS,
        lm_valid=LM_AXIS,
        obs_kf=LM_AXIS,
        obs_uv=LM_AXIS,
        obs_inv_sigma=LM_AXIS,
        obs_valid=LM_AXIS,
    )


def result_specs() -> schur_ba.BAResult:
    return schur_ba.BAResult(
        kf_T=None,
        lm_pos=LM_AXIS,
        obs_inlier=LM_AXIS,
        cost0=None,
        cost=None,
    )


def shard_problem(p: schur_ba.BAProblem, mesh: mesh_utils.Mesh) -> schur_ba.BAProblem:
    """This rank's part of a whole problem (tensors or numpy arrays), on the
    mesh's device: its block of every landmark-axis leaf, the rest whole.
    The landmark capacity must divide by the mesh size."""
    return schur_ba.BAProblem(*[
        (mesh_utils.lm_sharding(mesh, x.ndim) if spec else
         mesh_utils.replicated(mesh)).place(x)
        for x, spec in zip(p, problem_specs())
    ])


def dist_bundle_adjust(
    p: schur_ba.BAProblem, mesh: mesh_utils.Mesh, iters: int = 10,
    lam0: float = 1e-4,
) -> schur_ba.BAResult:
    """LM bundle adjustment over a landmark-sharded problem: ``p`` is this
    rank's part (``shard_problem``), and so is the result (``result_specs``:
    the poses and costs whole, the landmark leaves this rank's block).
    Every rank of the mesh must call it."""
    return schur_ba._lm_loop(p, iters, lam0, group=mesh.group)
