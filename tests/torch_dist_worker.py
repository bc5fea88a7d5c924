"""One rank of the port's scale-out checks (tests/test_torch_dist.py), on
the CPU under gloo: the event-sharded splat and window scores, the
landmark-sharded BA and the multihost BA. Imports neither jax nor the JAX
package. Writes its results to ``<out>/rank<r>.npz``.

    python -m tests.torch_dist_worker <init file> <world> <rank> <out dir>
"""

from __future__ import annotations

import sys

import numpy as np
import torch

CAM = np.asarray([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0], np.float32)


def splat_inputs():
    """tests/test_dist_ba.py's sharded-splat inputs."""
    rng = np.random.default_rng(3)
    N, H, W = 8192, 90, 120
    xy = rng.uniform(-5, 125, (N, 2)).astype(np.float32)
    valid = rng.random(N) < 0.9
    pol = rng.choice([-1.0, 1.0], N).astype(np.float32)
    return xy, valid, pol, H, W


def window_inputs():
    """tests/test_dist_ba.py's window-score inputs."""
    rng = np.random.default_rng(4)
    N, H, W = 4096, 64, 96
    ev = np.zeros((N, 4), np.float32)
    ev[:, 0] = np.sort(rng.uniform(0, 0.02, N))
    ev[:, 1] = rng.uniform(0, W, N)
    ev[:, 2] = rng.uniform(0, H, N)
    ev[:, 3] = rng.choice([-1.0, 1.0], N)
    valid = rng.random(N) < 0.8
    return ev, valid, np.float32(0.02), H, W


def ba_problem(K=8, M=256, P=4, perturb=0.0, seed=0, dtype=np.float32):
    """tests/test_multihost.py's BA problem as numpy leaves (BAProblem
    field order), its float leaves in ``dtype``; ``perturb`` adds a pose
    error to the free keyframes."""
    rng = np.random.default_rng(seed)
    lm = np.concatenate([rng.uniform(-2, 2, (M, 2)),
                         rng.uniform(4, 8, (M, 1))], 1).astype(np.float32)
    Ts = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    Ts[:, 0, 3] = -0.25 * np.arange(K)
    obs_kf = rng.integers(0, K, (M, P)).astype(np.int32)
    pc = np.einsum("mpij,mj->mpi", Ts[obs_kf][..., :3, :3], lm) + Ts[obs_kf][..., :3, 3]
    uv = np.stack([458.0 * pc[..., 0] / pc[..., 2] + 376.0,
                   457.0 * pc[..., 1] / pc[..., 2] + 240.0], -1).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    kf_T = Ts.copy()
    kf_T[2:, :3, 3] += rng.normal(0, perturb, (K - 2, 3)).astype(np.float32)
    lm0 = (lm + rng.normal(0, 0.02, lm.shape)).astype(np.float32)
    return (CAM.astype(dtype), kf_T.astype(dtype), np.asarray([True, True] + [False] * (K - 2)),
            np.ones(K, bool), lm0.astype(dtype), np.ones(M, bool), obs_kf,
            uv.astype(dtype), np.ones((M, P), dtype), pc[..., 2] > 0.1)


def main(init_file: str, world: int, rank: int, out: str) -> None:
    torch.set_num_threads(1)
    from eorb_slam_tpu_torch.optim import schur_ba
    from eorb_slam_tpu_torch.parallel import dist_ba, dist_splat, mesh_utils, multihost

    multihost.init(f"file://{init_file}", num_processes=world, process_id=rank,
                   device="cpu")
    mesh = mesh_utils.make_mesh(world, device="cpu")
    res = {}
    xy, valid, pol, H, W = splat_inputs()
    for use_pol in (False, True):
        res[f"splat_pol{int(use_pol)}"] = dist_splat.splat_gauss_sharded(
            mesh, torch.from_numpy(xy), torch.from_numpy(valid), torch.from_numpy(pol),
            H, W, sigma=1.0, use_polarity=use_pol).numpy()
    ev, v, dt, H, W = window_inputs()
    acc, rate = dist_splat._window_scores_sharded(
        mesh, torch.from_numpy(ev), torch.from_numpy(v), dt, H=H, W=W, sigma=1.0)
    res["win_acc"], res["win_rate"] = acc.numpy(), rate.numpy()

    # landmark-sharded BA: this rank's block of the perturbed problem
    p = dist_ba.shard_problem(schur_ba.BAProblem(*ba_problem(perturb=0.02)), mesh)
    r = dist_ba.dist_bundle_adjust(p, mesh, iters=10)
    res.update(ba_kf_T=r.kf_T.numpy(), ba_lm_pos=r.lm_pos.numpy(),
               ba_inlier=r.obs_inlier.numpy(), ba_cost0=r.cost0.numpy(),
               ba_cost=r.cost.numpy())

    # the multihost path: the global mesh, per-process numpy data, f64 (an
    # unconverged f32 solve parts with the single-process one by ~2e-4)
    gmesh = multihost.global_mesh(device="cpu")
    pg = multihost.shard_problem_global(
        schur_ba.BAProblem(*ba_problem(dtype=np.float64)), gmesh)
    rg = dist_ba.dist_bundle_adjust(pg, gmesh, iters=6)
    res.update(mh_kf_T=rg.kf_T.numpy(), mh_cost0=rg.cost0.numpy(), mh_cost=rg.cost.numpy())
    try:
        multihost.shard_problem_global(schur_ba.BAProblem(*ba_problem(M=255)), gmesh)
        res["mh_uneven_raised"] = np.asarray(False)
    except ValueError:
        res["mh_uneven_raised"] = np.asarray(True)
    np.savez(f"{out}/rank{rank}.npz", **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
