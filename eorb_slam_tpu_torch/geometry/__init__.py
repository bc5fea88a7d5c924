from eorb_slam_tpu_torch.geometry import lie, camera  # noqa: F401
