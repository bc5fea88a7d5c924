from eorb_slam_tpu_torch.ops import pyramid, fast, orb  # noqa: F401
