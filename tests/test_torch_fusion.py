"""Event-ORB fusion of the port (``slam/fusion.py``) against the JAX package
on the scenarios of tests/test_fusion.py: two event chains each in its own
Sim3 gauge, a noisy chain pulled toward the image trajectory, and the
degenerate inputs. The same numpy trajectories go to both.

Tolerances: the same chain count, anchor count, vertex and edge counts and
entry kinds; the interpolated poses within 1e-6; the recovered gauge
scales within 1e-6 relative (host numpy on both sides, over centres that
the float32 interpolation gives); the fused poses within 1e-6. Both
packages solve the pose graph in float32, as the reference does: 15
Gauss-Newton iterations take it to its fixed point, where the two
summation orders agree to 1e-6.
"""

import numpy as np
import pytest
import torch

from eorb_slam_tpu.slam import fusion as jfu
from eorb_slam_tpu_torch.slam import fusion as tfu
from tests.test_fusion import _pose, _regauge

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the machine's cores); the process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rot(v):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(v).as_matrix()


def _two_chains():
    im = [(float(t), _pose(float(t))) for t in np.arange(0, 8, 0.25)]
    ch1 = [(float(t), _pose(float(t))) for t in np.arange(0.5, 3.0, 0.1)]
    ch2 = [(float(t), _pose(float(t))) for t in np.arange(5.0, 7.5, 0.1)]
    ev = _regauge(ch1, 0.4, _rot([0.1, -0.2, 0.05]), np.asarray([2.0, -1.0, 0.5]))
    ev += _regauge(ch2, 2.5, _rot([-0.3, 0.1, 0.2]), np.asarray([-3.0, 0.0, 1.0]))
    return im, ev, {"chain_gap_s": 1.0}


def _noisy_chain():
    rng = np.random.default_rng(0)
    im = [(float(t), _pose(float(t))) for t in np.arange(0, 6, 0.2)]
    ev = []
    for t in np.arange(0.5, 5.5, 0.1):
        T = _pose(float(t)).copy()
        T[:3, 3] += rng.normal(0, 0.05, 3)
        ev.append((float(t), T))
    return im, ev, {"anchor_weight": 3.0, "odo_weight": 1.0}


def _same_fusion(rt, rj):
    assert rt["chains"] == rj["chains"] and rt["anchored"] == rj["anchored"]
    assert len(rt["fused"]) == len(rj["fused"])
    for k in ("kinds", "n_vertices", "n_edges"):
        assert rt.get(k) == rj.get(k), k
    for g_t, g_j in zip(rt.get("gauges", []), rj.get("gauges", [])):
        assert g_t["n"] == g_j["n"]
        assert g_t["scale"] == pytest.approx(g_j["scale"], rel=TOL)
    for (ts_t, Tt), (ts_j, Tj) in zip(rt["fused"], rj["fused"]):
        assert ts_t == ts_j
        np.testing.assert_allclose(Tt, np.asarray(Tj), atol=TOL)


def test_interpolate_tcw_matches_jax():
    traj = [(float(t), _pose(float(t))) for t in np.arange(0, 5, 0.5)]
    for t in (0.0, 0.3, 1.25, 2.0, 3.999, 4.5):
        np.testing.assert_allclose(tfu.interpolate_tcw(traj, t),
                                   np.asarray(jfu.interpolate_tcw(traj, t)), atol=TOL)
    assert tfu.interpolate_tcw(traj, -1.0) is None and tfu.interpolate_tcw(traj, 99.0) is None
    # a repeated timestamp gives the earlier sample's pose
    dup = [(0.0, _pose(0.0)), (1.0, _pose(1.0)), (1.0, _pose(1.1))]
    np.testing.assert_allclose(tfu.interpolate_tcw(dup, 1.0),
                               np.asarray(jfu.interpolate_tcw(dup, 1.0)), atol=TOL)


@pytest.mark.parametrize("scenario", [_two_chains, _noisy_chain])
def test_fuse_event_orb_matches_jax(scenario):
    im, ev, kw = scenario()
    rj = jfu.fuse_event_orb(im, ev, **kw)
    rt = tfu.fuse_event_orb(im, ev, device="cpu", **kw)
    assert rt["chains"] >= 1
    _same_fusion(rt, rj)


def test_fuse_degenerate_inputs_match_jax():
    im = [(0.0, np.eye(4)), (1.0, _pose(1.0))]
    ev_out = [(float(t), _pose(float(t))) for t in np.arange(10, 11, 0.1)]
    for a, b in (([], []), (im, []), ([], [(0.0, np.eye(4))]), (im, ev_out),
                 (im, ev_out[:2])):
        rj = jfu.fuse_event_orb(a, b)
        rt = tfu.fuse_event_orb(a, b, device="cpu")
        assert rt["chains"] == rj["chains"] == 0
        assert [ts for ts, _ in rt["fused"]] == [ts for ts, _ in rj["fused"]]
