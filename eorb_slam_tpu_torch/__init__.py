"""eorb_slam_tpu_torch — the PyTorch/CUDA port of ``eorb_slam_tpu`` for one
NVIDIA H100.

Module for module it mirrors the JAX package, which stays the reference the
port is held against (tests/test_torch_*.py). Plain tensor code is PyTorch;
the one Pallas kernel of the reference (the fused Gaussian event splat) is a
hand-written CUDA kernel for ``sm_90a`` (csrc/splat.cu, ops/hopper_splat.py).
This package never imports jax nor ``eorb_slam_tpu``.
"""

import torch as _torch

# Geometry/optimizer math needs true f32 products (the reference forces the
# highest matmul precision for the same reason, eorb_slam_tpu/__init__.py:20):
# TF32 keeps ~3 decimal digits and breaks rotation orthonormality.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
