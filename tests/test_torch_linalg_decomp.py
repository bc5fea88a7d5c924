"""The status-free decompositions of ``optim/linalg`` and the VI frame's
batched re-search, on the CPU.

- ``eigh_or_nan`` on CPU tensors is the plain version of the ``sym_eig``
  kernel (``ops/hopper_linalg``): ``torch.linalg.eigh``'s own bits, NaN in a
  non-finite member, at every size its callers use (n = 4, 9, 12, 15).
- ``pinv_sym`` (what ``marginalize.marginalize`` now calls) against the
  reference's SVD pseudo-inverse (``eorb_slam_tpu/optim/marginalize.
  _pinv_psd``, eager ``jnp.linalg.svd``) at n = 15: float32 on an SPD
  matrix and one with a zero block, to 1e-4 of the largest entry (the
  tolerance of tests/test_torch_marginalize.py); float64 on an SPD matrix,
  a rank-12 product and a 1e8 eigenvalue spread, to 2e-8 of the largest
  entry (the spread's condition number 1e8 times float64's 2.2e-16).
- ``tracking.track_frame_with_retry`` (both searches as one batch, the
  re-search picked on the device) against two unbatched ``track_frame``
  calls on the same frame, on the narrow and on the wide branch: the
  matches, inliers and counts equal, the pose to 1e-6 (the batched GN sums
  its normal equations in another order).

No JAX compile: eager ``jnp`` only; torch at two threads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.optim import marginalize as jmarg
from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.io import synth_dataset as tsd
from eorb_slam_tpu_torch.ops import frontend, hopper_linalg
from eorb_slam_tpu_torch.optim import linalg
from eorb_slam_tpu_torch.slam import system as tsys, tracking

PINV_TOL_F32, PINV_TOL_F64 = 1e-4, 2e-8
POSE_TOL = 1e-6
W, H, FX, FPS = 240, 180, 146.25, 20.0
KW = dict(img_w=W, img_h=H, K=8, M=1024, N=256, max_frames_between_kf=3)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sym_batch(n, batch, seed, dtype):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(batch, n + 2, n))
    A = np.einsum("bki,bkj->bij", X, X) + rng.normal(size=(batch, 1, 1)) * np.eye(n)
    return torch.from_numpy(A).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,batch", [(4, 64), (9, 8), (12, 4), (15, 1), (15, 3)])
def test_eigh_or_nan_on_cpu_is_torch_eigh(n, batch, dtype):
    A = _sym_batch(n, batch, seed=n * batch, dtype=dtype)
    w_ref, V_ref = torch.linalg.eigh(A)
    w, V = linalg.eigh_or_nan(A)
    assert torch.equal(w, w_ref) and torch.equal(V, V_ref)
    w, V = hopper_linalg.sym_eig(A)      # the wrapper on a CPU tensor: the same
    assert torch.equal(w, w_ref) and torch.equal(V, V_ref)
    assert hopper_linalg.sym_eig.by_n == {}
    if batch > 1:
        A_nan = A.clone()
        A_nan[1, 0, 0] = float("nan")
        w, V = linalg.eigh_or_nan(A_nan)
        keep = torch.arange(batch) != 1
        assert torch.isnan(w[1]).all() and torch.isnan(V[1]).all()
        assert torch.equal(w[keep], w_ref[keep]) and torch.equal(V[keep], V_ref[keep])


def test_sym_eig_checks_its_input():
    with pytest.raises(TypeError):
        hopper_linalg.sym_eig(torch.eye(4, dtype=torch.float16))
    with pytest.raises(ValueError):
        hopper_linalg.sym_eig(torch.zeros(3, 4))


def _pinv_case(case, seed=15):
    rng = np.random.default_rng(seed)
    n = 15
    if case == "spd":
        X = rng.normal(size=(n + 3, n))
        return X.T @ X
    if case == "zero block":                   # a marginalized prior's rank loss
        X = rng.normal(size=(n + 3, n))
        A = X.T @ X
        A[12:, :] = 0.0
        A[:, 12:] = 0.0
        return A
    if case == "rank 12":
        X = rng.normal(size=(12, n))
        return X.T @ X
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))  # px^2 beside m^2
    return (Q * np.logspace(0.0, 8.0, n)) @ Q.T


@pytest.mark.parametrize("case,dtype", [
    ("spd", np.float32), ("zero block", np.float32),
    ("spd", np.float64), ("rank 12", np.float64), ("1e8 spread", np.float64)])
def test_pinv_sym_matches_reference_svd_pinv(case, dtype):
    A = _pinv_case(case)
    A = (0.5 * (A + A.T)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jmarg._pinv_psd(jnp.asarray(A)))
    assert ref.dtype == dtype
    got = linalg.pinv_sym(torch.from_numpy(A))
    tol = PINV_TOL_F32 if dtype == np.float32 else PINV_TOL_F64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())


def test_pinv_sym_nan_member():
    A = torch.from_numpy(_pinv_case("spd").astype(np.float32))
    A[3, 4] = float("nan")
    assert torch.isnan(linalg.pinv_sym(A)).all()


@pytest.fixture(scope="module")
def frame():
    """A MonoSlam past its initialisation on the corridor at 240x180, and
    the next frame's features with the motion model's predicted pose."""
    render = tsd.make_box_renderer("corridor", W, H, FX, device="cpu")
    pose = tsd.make_trajectory("corridor", 10.0)
    cam = np.asarray([FX, FX, W / 2.0, H / 2.0, 0, 0, 0, 0, 0], np.float32)
    slam = tsys.MonoSlam(cam, pipelined=False, device="cpu", **KW)
    img = lambda i: (render(np.asarray(pose(i / FPS), np.float32)) * 255.0).to(torch.uint8)
    i = 0
    while slam.state != tsys.OK and i < 7:
        slam.process_image(img(i), i / FPS)
        i += 1
    assert slam.state == tsys.OK
    img = img(i)
    feats = frontend.extract(img, max_kp=slam.map.N)
    xy = cam_mod.undistort_points(slam.cam, feats.xy)
    return (slam.map, slam.cam, xy, feats.octave, feats.desc_pm1, feats.valid,
            slam.velocity @ slam.T_last)


@pytest.mark.parametrize("branch", ["narrow", "wide"])
def test_batched_retry_equals_two_searches(frame, branch):
    kw = dict(img_w=W, img_h=H)
    narrow = tracking.track_frame(*frame, **kw)
    wide = tracking.track_frame(*frame, search_radius=tracking.WIDE_RADIUS,
                                nn_ratio=tracking.WIDE_NN_RATIO, **kw)
    n0 = int(narrow.n_inliers)
    assert n0 >= 10 and not torch.equal(narrow.feat_lm, wide.feat_lm)
    # the narrow search's own count decides: below the threshold -> wide
    retry = n0 + 1 if branch == "wide" else n0
    got = tracking.track_frame_with_retry(*frame, retry, **kw)
    ref = wide if branch == "wide" else narrow
    for field in ("feat_lm", "inlier", "n_matched", "n_inliers"):
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
    assert float((got.Tcw - ref.Tcw).abs().max()) <= POSE_TOL
