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
                 "slam.event_system", "convert", "_host",
                 "io.config", "io.native", "io.trajectory", "io.datasets",
                 "io.synth_dataset", "evals.ate", "evals.rpe",
                 "evals.kitti_odom", "slam.covisibility", "geometry.camera",
                 "apps.run_slam", "imu.preintegration", "optim.inertial",
                 "optim.marginalize", "optim.vi_ba", "slam.vi_system",
                 "slam.event_inertial", "ops.stereo_match", "slam.rgbd_stereo",
                 "geometry.sim3_solver", "optim.pose_graph", "retrieval.bow",
                 "slam.loop_closing", "utils.logging", "slam.fusion",
                 "slam.ev_image_system", "slam.event_continuous",
                 "event.feature_tracks", "ops.akaze", "io.checkpoint",
                 "io.rosbag", "viz.viewer", "parallel.mesh_utils",
                 "parallel.dist_ba", "parallel.dist_splat", "parallel.multihost"):
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


def test_port_modules_need_no_yaml_or_pil_to_import():
    """PyYAML, Pillow and matplotlib are used inside the functions that
    read settings and images or draw; importing the port (and
    chip_smoke.py) needs none of them."""
    code = "\n".join([
        "import sys, importlib",
        "for name in ('yaml', 'PIL', 'h5py', 'matplotlib'):",
        "    sys.modules[name] = None",
        f"for m in {_port_modules()!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_every_jax_module_has_a_counterpart():
    """Module for module, the port mirrors the JAX package: every module of
    eorb_slam_tpu has a file of the same path in eorb_slam_tpu_torch, with
    one named exception, the Pallas kernel's module, whose counterpart is
    the Hopper kernel's."""
    renamed = {"ops/pallas_splat.py": "ops/hopper_splat.py"}
    jax_root = os.path.join(REPO, "eorb_slam_tpu")
    missing, n = [], 0
    for d, _, files in os.walk(jax_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), jax_root).replace(os.sep, "/")
            n += 1
            if not os.path.exists(os.path.join(REPO, "eorb_slam_tpu_torch",
                                               renamed.get(rel, rel))):
                missing.append(rel)
    assert n >= 70 and not missing, missing


def test_clis_start_without_jax(tmp_path):
    """Both command lines run in an interpreter where jax and the JAX package
    are blocked (here on the CPU, at a tiny size)."""
    code = "\n".join([
        "import sys",
        "for name in ('jax', 'jaxlib', 'eorb_slam_tpu'):",
        "    sys.modules[name] = None",
        "from eorb_slam_tpu_torch.io import synth_dataset",
        "from eorb_slam_tpu_torch.apps import run_slam",
        f"root = {str(tmp_path)!r}",
        "synth_dataset.main(['--out', root, '--kind', 'euroc', '--seq', 'c',",
        "                    '--duration', '0.15', '--size', '96x64', '--device', 'cpu'])",
        "scene = synth_dataset.make_scene('corridor', 96, 64, 458.0, n_dots=4)",
        "y = synth_dataset.write_settings_yaml(root + '/s.yaml', fmt='euroc', root=root,",
        "        seqs=['c'], sensor='monocular', scene=scene, fps=20.0, ts_factor=1e9,",
        "        n_features=128)",
        "res = run_slam.main([y, '--device', 'cpu', '--out', root + '/out'])",
        "assert res[0]['iterations'] == 3 and res[0]['device'] == 'cpu', res",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
