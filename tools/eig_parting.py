"""Where run_slam EVENT_ONLY parts when the triangulations' 4x4
eigendecomposition runs through torch.linalg.eigh instead of the sym_eig
kernel, both on the card.

chip_smoke.py's EVENT_ONLY phase (configs/synth_ev_only.yaml on the
generated shakes sequence) runs three times in one process: with the
kernel, with ``geometry/triangulation.eigh_or_nan`` swapped for the plain
version (``optim/linalg._eigh_plain``, cuSOLVER's eigh), and with the
kernel again (the run must repeat bit for bit, or a difference could be
noise). Every ``triangulation_checks`` call is recorded (caller, inputs,
points, and each gate's value: depths, parallax cosine, both squared
reprojection errors), and so is the mask each keyframe hands to
``map_state.alloc_landmarks``. The runs are compared call by call: the
first call whose points differ, the first whose inputs differ, and the
first landmark decision that differs, with the gate that flipped, its
value in both runs and its distance from the threshold; then the
trajectories pose by pose and the ATE.

    python3 tools/eig_parting.py [--out chiprun_out/eig_parting.json]

Needs a CUDA device (about 3 minutes on an H100).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import eorb_slam_tpu_torch  # noqa: E402,F401  (sets TF32 off)
from eorb_slam_tpu_torch.geometry import lie, triangulation  # noqa: E402
from eorb_slam_tpu_torch.optim import linalg  # noqa: E402
from eorb_slam_tpu_torch.slam import local_mapping  # noqa: E402

TIE = 1e-6          # a gate value this close to its threshold (relative) is a tie


def _gates(T1, T2, ray1, ray2, pts_w, min_parallax_cos=0.9998, max_reproj_err2=5.991,
           inv_sigma1=1.0, inv_sigma2=1.0):
    """triangulation_checks' gate values, by its own ops: (z1, z2, cos,
    err1, err2) as float64 numpy, and the thresholds."""
    pc1 = lie.se3_apply(T1, pts_w)
    pc2 = lie.se3_apply(T2, pts_w)
    d1 = pts_w - lie.se3_trans(lie.se3_inv(T1))
    d2 = pts_w - lie.se3_trans(lie.se3_inv(T2))
    cos = torch.sum(d1 * d2, dim=-1) / (
        torch.linalg.norm(d1, dim=-1) * torch.linalg.norm(d2, dim=-1) + 1e-12)
    z1 = torch.where(torch.abs(pc1[..., 2]) < 1e-9, 1e-9, pc1[..., 2])
    z2 = torch.where(torch.abs(pc2[..., 2]) < 1e-9, 1e-9, pc2[..., 2])
    s1 = torch.as_tensor(inv_sigma1, dtype=pts_w.dtype, device=pts_w.device)[..., None]
    s2 = torch.as_tensor(inv_sigma2, dtype=pts_w.dtype, device=pts_w.device)[..., None]
    e1 = (pc1[..., :2] / z1[..., None] - ray1[..., :2]) * s1
    e2 = (pc2[..., :2] / z2[..., None] - ray2[..., :2]) * s2
    vals = dict(z1=pc1[..., 2], z2=pc2[..., 2], cos=cos, err1=torch.sum(e1 * e1, -1),
                err2=torch.sum(e2 * e2, -1))
    # the thresholds as the comparison sees them: in the operands' type
    as_t = np.float32 if pts_w.dtype == torch.float32 else np.float64
    return ({k: v.double().cpu().numpy() for k, v in vals.items()},
            dict(cos=float(as_t(min_parallax_cos)), err=float(as_t(max_reproj_err2))))


def _np(x):
    return x.detach().cpu().numpy().copy() if torch.is_tensor(x) else np.asarray(x)


class _Recorder:
    """Records triangulation_checks calls and the landmark masks."""

    def __init__(self):
        self.checks, self.allocs = [], []

    def __enter__(self):
        self._checks = triangulation.triangulation_checks
        self._alloc = local_mapping.ms.alloc_landmarks

        def checks(T1, T2, ray1, ray2, pts_w, **kw):
            ok, cos = self._checks(T1, T2, ray1, ray2, pts_w, **kw)
            vals, thr = _gates(T1, T2, ray1, ray2, pts_w, **kw)
            f = sys._getframe(1)
            self.checks.append(dict(
                site=f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}",
                inputs=[_np(x) for x in (T1, T2, ray1, ray2)], pts=_np(pts_w),
                ok=_np(ok), vals=vals, thr=thr))
            mine = ((vals["z1"] > 0) & (vals["z2"] > 0) & (vals["cos"] < thr["cos"])
                    & (vals["err1"] < thr["err"]) & (vals["err2"] < thr["err"]))
            if not (np.array_equal(_np(cos).astype(np.float64), vals["cos"])
                    and np.array_equal(mine, _np(ok))):
                raise RuntimeError("the recorded gates are not triangulation_checks' own")
            return ok, cos

        def alloc(m, pts, desc, ok, *a, **kw):
            f = sys._getframe(1)
            self.allocs.append(dict(
                site=f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}",
                n_checks=len(self.checks), ok=_np(ok)))
            return self._alloc(m, pts, desc, ok, *a, **kw)

        triangulation.triangulation_checks = checks
        local_mapping.ms.alloc_landmarks = alloc
        return self

    def __exit__(self, *exc):
        triangulation.triangulation_checks = self._checks
        local_mapping.ms.alloc_landmarks = self._alloc


def _run(work, root, route):
    """One EVENT_ONLY run, the triangulations' eigh on ``route``."""
    eigh = triangulation.eigh_or_nan
    if route == "library":
        triangulation.eigh_or_nan = linalg._eigh_plain
    out_dir = os.path.join(work, "results_ev")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        with _Recorder() as rec:
            res = cs.run_app_event_only(work, root)
    finally:
        triangulation.eigh_or_nan = eigh
    poses = np.zeros((0, 8))
    for path in glob.glob(os.path.join(out_dir, "**", "*.txt"), recursive=True):
        with open(path) as f:
            if f.readline().startswith("# tracking:"):
                poses = np.loadtxt(path, ndmin=2)
    return dict(route=route, ate_frac=res["ate_frac"], checks=rec.checks,
                allocs=rec.allocs, poses=poses)


def _flip(rec_a, rec_b, i):
    """The gates of element ``i`` (a flat index) in two records."""
    out = {}
    for name, rec in (("a", rec_a), ("b", rec_b)):
        v = {k: float(x.reshape(-1)[i]) for k, x in rec["vals"].items()}
        out[name] = v
    thr = rec_a["thr"]
    margins = {}
    for k, t in (("cos", thr["cos"]), ("err1", thr["err"]), ("err2", thr["err"])):
        if (out["a"][k] < t) != (out["b"][k] < t):
            margins[k] = dict(threshold=t, rel_a=abs(out["a"][k] - t) / t,
                              rel_b=abs(out["b"][k] - t) / t)
    for k in ("z1", "z2"):
        if (out["a"][k] > 0) != (out["b"][k] > 0):
            margins[k] = dict(threshold=0.0, a=out["a"][k], b=out["b"][k])
    out["flipped"] = margins
    out["tie"] = bool(margins) and all(
        m.get("rel_a", 1.0) < TIE or m.get("rel_b", 1.0) < TIE for m in margins.values())
    return out


def _compare(a, b):
    """Call by call: the first parting of points, of inputs, of a gate and
    of a landmark decision; then the trajectories."""
    out = dict(routes=[a["route"], b["route"]], calls=[len(a["checks"]), len(b["checks"])],
               ate_frac=[a["ate_frac"], b["ate_frac"]])
    first = dict(points=None, inputs=None, gate=None, landmarks=None)
    for k, (ra, rb) in enumerate(zip(a["checks"], b["checks"])):
        same_in = all(np.array_equal(x, y) for x, y in zip(ra["inputs"], rb["inputs"]))
        if first["inputs"] is None and not same_in:
            first["inputs"] = dict(call=k, site=ra["site"], max_abs=max(
                float(np.abs(x - y).max()) for x, y in zip(ra["inputs"], rb["inputs"])
                if x.shape == y.shape))
        if first["points"] is None and not np.array_equal(ra["pts"], rb["pts"]):
            d = np.abs(ra["pts"] - rb["pts"])
            first["points"] = dict(call=k, site=ra["site"], inputs_equal=same_in,
                                   max_abs=float(np.nanmax(d)),
                                   max_rel=float(np.nanmax(d / (np.abs(ra["pts"]) + 1e-30))))
        if first["gate"] is None and not np.array_equal(ra["ok"], rb["ok"]):
            idx = np.flatnonzero(ra["ok"].reshape(-1) != rb["ok"].reshape(-1))
            first["gate"] = dict(call=k, site=ra["site"], inputs_equal=same_in,
                                 n=int(idx.size), elements=idx[:8].tolist(),
                                 first=_flip(ra, rb, int(idx[0])))
    for j, (la, lb) in enumerate(zip(a["allocs"], b["allocs"])):
        if not np.array_equal(la["ok"], lb["ok"]):
            k = la["n_checks"] - 1
            idx = np.flatnonzero(la["ok"] != lb["ok"])
            ra, rb = a["checks"][k], b["checks"][k]
            same_in = all(np.array_equal(x, y) for x, y in zip(ra["inputs"], rb["inputs"]))
            first["landmarks"] = dict(
                alloc_call=j, site=la["site"], check_call=k, check_site=ra["site"],
                inputs_equal=same_in, n=int(idx.size), elements=idx[:8].tolist(),
                landmarks=[int(la["ok"].sum()), int(lb["ok"].sum())],
                gates=[_flip(ra, rb, int(i)) for i in idx[:4]]
                if ra["ok"].size == la["ok"].size else None)
            break
    out["first"] = first
    pa, pb = a["poses"], b["poses"]
    n = min(len(pa), len(pb))
    if n:
        d = np.linalg.norm(pa[:n, 1:4] - pb[:n, 1:4], axis=1)
        part = np.flatnonzero(d > 0)
        out["poses"] = dict(n=[len(pa), len(pb)], first_differing=int(part[0]) if part.size
                            else None, max_abs=float(d.max()),
                            at=[float(d[i]) for i in np.linspace(0, n - 1, 5).astype(int)])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "eig_parting.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("eig_parting: no CUDA device visible", file=sys.stderr)
        return 1
    from eorb_slam_tpu_torch.ops import hopper_linalg, hopper_splat

    hopper_splat.build()
    hopper_linalg.build()
    cs._log(f"gpu: {cs._gpu_line()}")
    work = tempfile.mkdtemp(prefix="eig_parting_")
    try:
        root = cs.run_generate(work)["root"]
        runs = [_run(work, root, r) for r in ("kernel", "library", "kernel")]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report = dict(kernel_vs_library=_compare(runs[0], runs[1]),
                  kernel_vs_kernel=_compare(runs[0], runs[2]))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    cs._log(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
