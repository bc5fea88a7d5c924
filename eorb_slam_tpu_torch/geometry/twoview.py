"""Monocular two-view initialization: batched H/F RANSAC + model selection
+ motion recovery.

PyTorch port of ``eorb_slam_tpu/geometry/twoview.py`` (reference
TwoViewReconstruction): all ``iters`` hypotheses of BOTH models are scored
as one batched computation, the H-vs-F choice follows the SH/(SH+SF) > 0.40
rule, and the 4 essential / 8 homography motions are checked in parallel
with batched triangulation. Internally everything is camera-normalized (the
fitted "F" is the essential matrix E); scoring applies the focal factor so
the pixel-unit chi2 thresholds (3.841 / 5.991) keep their meaning.

Randomness: minimal sets come from :func:`_sample_minimal_sets`, which
draws from an explicit ``torch.Generator``; torch cannot reproduce
``jax.random``'s stream, so parity tests replace that function. Degenerate
hypotheses come out as NaN and score lowest (``optim/linalg.*_or_nan``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eorb_slam_tpu_torch.geometry import lie, triangulation
from eorb_slam_tpu_torch.ops.fast import _top_k_stable
from eorb_slam_tpu_torch.optim.linalg import eigh_or_nan, inv_or_nan, svd_or_nan

CHI2_F = 3.841
CHI2_H = 5.991
TH_SCORE = 5.991  # per-point score cap, same for both models (reference)


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # () bool
    Tcw2: torch.Tensor             # (4,4) pose of view 2 (view 1 = identity)
    pts3d: torch.Tensor            # (N,3) triangulated points (view-1 frame)
    is_triangulated: torch.Tensor  # (N,) bool
    used_homography: torch.Tensor  # () bool
    n_good: torch.Tensor           # () int


def _normalize(cam_params, uv):
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)


def _sample_minimal_sets(generator: torch.Generator, valid: torch.Tensor,
                         iters: int, k: int) -> torch.Tensor:
    """(iters, k) indices drawn from valid slots without replacement (per
    hypothesis, Gumbel top-k over the valid mask — fully batched)."""
    u = torch.rand((iters, valid.shape[0]), generator=generator,
                   device=valid.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    scores = torch.where(valid[None, :], g, -torch.inf)
    return _top_k_stable(scores, k)[1]


def _fit_E_batch(x1, x2):
    """8-point algorithm on normalized coords: (S,8,2) x2 -> E (S,3,3),
    rank 2 with equal singular values."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    ones = torch.ones_like(u1)
    A = torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], dim=-1
    )
    _, V = eigh_or_nan(A.transpose(-1, -2) @ A)
    E = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    U, s, Vt = svd_or_nan(E)
    s_mean = (s[..., 0] + s[..., 1]) / 2.0
    s_new = torch.stack([s_mean, s_mean, torch.zeros_like(s_mean)], dim=-1)
    return U @ (s_new[..., None] * Vt)


def _fit_H_batch(x1, x2):
    """4-point DLT: (S,4,2) x2 -> H (S,3,3) with x2 ~ H x1."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    zeros = torch.zeros_like(u1)
    ones = torch.ones_like(u1)
    rows1 = torch.stack(
        [zeros, zeros, zeros, -u1, -v1, -ones, v2 * u1, v2 * v1, v2], dim=-1)
    rows2 = torch.stack(
        [u1, v1, ones, zeros, zeros, zeros, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([rows1, rows2], dim=-2)
    _, V = eigh_or_nan(A.transpose(-1, -2) @ A)
    h = V[..., :, 0]
    return h.reshape(h.shape[:-1] + (3, 3))


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _score(d2_1, d2_2, th, valid):
    in1 = d2_1 < th
    in2 = d2_2 < th
    sc = torch.where(in1, TH_SCORE - d2_1, 0.0) + torch.where(in2, TH_SCORE - d2_2, 0.0)
    sc = sc * valid[None, :]
    return torch.sum(sc, dim=-1), in1 & in2 & (valid[None, :] > 0)


def _score_E(E, x1, x2, valid, f2):
    """Symmetric epipolar chi2 score (pixel units via focal^2 factor f2).
    Returns (score (S,), inliers (S,N))."""
    x1h, x2h = _homog(x1), _homog(x2)
    l2 = torch.einsum("sij,nj->sni", E, x1h)      # line in image 2
    l1 = torch.einsum("sji,nj->sni", E, x2h)      # line in image 1
    num = torch.einsum("ni,sni->sn", x2h, l2)
    d2_2 = num**2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12) * f2
    d2_1 = num**2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12) * f2
    return _score(d2_1, d2_2, CHI2_F, valid)


def _score_H(H, x1, x2, valid, f2):
    """Symmetric transfer error score for homographies."""
    x1h, x2h = _homog(x1), _homog(x2)
    Hx1 = torch.einsum("sij,nj->sni", H, x1h)
    Hx2 = torch.einsum("sij,nj->sni", inv_or_nan(H), x2h)
    p21 = Hx1[..., :2] / torch.where(torch.abs(Hx1[..., 2:3]) < 1e-12, 1e-12, Hx1[..., 2:3])
    p12 = Hx2[..., :2] / torch.where(torch.abs(Hx2[..., 2:3]) < 1e-12, 1e-12, Hx2[..., 2:3])
    d2_2 = torch.sum((p21 - x2[None]) ** 2, dim=-1) * f2
    d2_1 = torch.sum((p12 - x1[None]) ** 2, dim=-1) * f2
    return _score(d2_1, d2_2, CHI2_H, valid)


def _decompose_E(E):
    """4 candidate (R, t) from an essential matrix."""
    U, _, Vt = svd_or_nan(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / (torch.linalg.norm(t) + 1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H):
    """8 candidate (R, t) via the Faugeras-Lustman SVD decomposition
    (reference TwoViewReconstruction::ReconstructH)."""
    U, s, Vt = svd_or_nan(H)
    d1, d2, d3 = s[0], s[1], s[2]
    detUV = torch.linalg.det(U) * torch.linalg.det(Vt)
    dt, dev = H.dtype, H.device

    d2s = torch.clamp(d2, min=1e-9)
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    e1 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev)
    e3 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev)
    rad = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero = torch.zeros(4, dtype=dt, device=dev)
    one = torch.ones(4, dtype=dt, device=dev)

    def rot(r00, r02, r11, r20, r22):
        return torch.stack([
            torch.stack([r00, zero, r02], -1),
            torch.stack([zero, r11, zero], -1),
            torch.stack([r20, zero, r22], -1),
        ], -2)

    # case d' > 0
    st = e1 * e3 * (rad / ((d1 + d3) * d2s))
    ct = ((d2 * d2 + d1 * d3) / ((d1 + d3) * d2s)) * one
    Rp_pos = rot(ct, -st, one, st, ct)
    tp_pos = (d1 - d3) * torch.stack([x1 * e1, zero, -x3 * e3], -1)
    # case d' < 0
    sp = e1 * e3 * (rad / ((d1 - d3) * d2s + 1e-12))
    cp = ((d1 * d3 - d2 * d2) / ((d1 - d3) * d2s + 1e-12)) * one
    Rp_neg = rot(cp, sp, -one, sp, -cp)
    tp_neg = (d1 + d3) * torch.stack([x1 * e1, zero, x3 * e3], -1)

    Rp = torch.cat([Rp_pos, Rp_neg])                 # (8,3,3)
    tp = torch.cat([tp_pos, tp_neg])                 # (8,3)
    Rs = detUV * (U @ Rp @ Vt)
    ts = (U @ tp[..., None])[..., 0]
    return Rs, ts / (torch.linalg.norm(ts, dim=-1, keepdim=True) + 1e-12)


def _check_motion(Rs, ts, x1, x2, valid, f2):
    """Triangulate all points under each (R,t) of (B,3,3)/(B,3) and count
    the accepted ones. Returns (n_good (B,), pts3d (B,N,3), good (B,N))."""
    T1 = torch.eye(4, dtype=Rs.dtype, device=Rs.device)
    T2 = lie.se3(Rs, ts)[:, None]                    # (B,1,4,4)
    ray1, ray2 = _homog(x1), _homog(x2)
    pts = triangulation.triangulate_dlt(T1[None], T2, ray1, ray2)
    inv_sigma = torch.sqrt(f2)
    ok, _ = triangulation.triangulation_checks(
        T1[None], T2, ray1, ray2, pts,
        min_parallax_cos=0.9998,  # ~1.15 deg, reference CheckRT gate
        max_reproj_err2=4.0 * CHI2_H,
        inv_sigma1=inv_sigma, inv_sigma2=inv_sigma,
    )
    ok = ok & valid
    return ok.sum(-1, dtype=torch.int32), pts, ok


def reconstruct_two_views(
    cam_params: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    generator: torch.Generator,
    iters: int = 200,
    min_triangulated: int = 50,
) -> TwoViewResult:
    """Full monocular initialization from matched undistorted pixel pairs;
    returns the view-2 pose with unit-norm translation and triangulated
    points in the view-1 frame."""
    x1 = _normalize(cam_params, uv1)
    x2 = _normalize(cam_params, uv2)
    f2 = cam_params[0] * cam_params[1]  # fx*fy ~ focal^2 scale for chi2
    validf = valid.to(x1.dtype)

    idxE = _sample_minimal_sets(generator, valid, iters, 8)
    idxH = _sample_minimal_sets(generator, valid, iters, 4)
    E_all = _fit_E_batch(x1[idxE], x2[idxE])
    H_all = _fit_H_batch(x1[idxH], x2[idxH])

    scE, _ = _score_E(E_all, x1, x2, validf, f2)
    scH, _ = _score_H(H_all, x1, x2, validf, f2)
    bestE = torch.argmax(scE)
    bestH = torch.argmax(scH)
    SF = scE[bestE]
    SH = scH[bestH]
    use_H = SH / torch.clamp(SH + SF, min=1e-9) > 0.40

    RsE, tsE = _decompose_E(E_all[bestE])
    RsH, tsH = _decompose_H(H_all[bestH])
    Rs = torch.cat([RsE, RsH])   # (12,3,3)
    ts = torch.cat([tsE, tsH])   # (12,3)
    motion_ok = torch.cat([(~use_H).expand(4), use_H.expand(8)])

    n_good, pts_all, good_all = _check_motion(Rs, ts, x1, x2, valid, f2)
    n_good = torch.where(motion_ok, n_good, -1)
    best = torch.argmax(n_good)
    n_best = n_good[best]
    # winner must dominate: second-best below 75% (the reference's clear-
    # winner rule in ReconstructF/H) and enough points
    n_second = torch.sort(n_good).values[-2]
    success = (n_best >= min_triangulated) & (
        n_second.to(torch.float32) < 0.75 * n_best.to(torch.float32))
    return TwoViewResult(
        success=success,
        Tcw2=lie.se3(Rs[best], ts[best]),
        pts3d=pts_all[best],
        is_triangulated=good_all[best],
        used_homography=use_H,
        n_good=n_best,
    )
