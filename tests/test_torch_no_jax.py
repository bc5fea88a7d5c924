"""The port imports neither jax nor the JAX package: every module of
eorb_slam_tpu_torch (and chip_smoke.py) imports in a fresh interpreter where
both are blocked."""

import os
import pkgutil
import subprocess
import sys

import eorb_slam_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    mods = ["eorb_slam_tpu_torch"]
    for info in pkgutil.walk_packages(eorb_slam_tpu_torch.__path__,
                                      "eorb_slam_tpu_torch."):
        mods.append(info.name)
    return mods


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "eorb_slam_tpu_torch.ops.hopper_splat" in mods
    assert "eorb_slam_tpu_torch.event.builder" in mods
    for name in ("optim.robust", "optim.linalg", "optim.reprojection",
                 "optim.pose_only", "optim.schur_ba", "ops.matching",
                 "geometry.triangulation", "geometry.twoview",
                 "slam.map_state", "slam.tracking", "slam.local_mapping",
                 "slam.relocalization", "slam.atlas", "slam.system",
                 "slam.event_system", "convert", "_host"):
        assert f"eorb_slam_tpu_torch.{name}" in mods, name
    code = "\n".join([
        "import sys, importlib",
        "for name in ('jax', 'jaxlib', 'eorb_slam_tpu'):",
        "    sys.modules[name] = None",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'eorb_slam_tpu') and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('ok', len(sys.modules))",
    ])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
