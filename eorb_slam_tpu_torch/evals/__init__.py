"""Trajectory evaluation (numpy): ATE, RPE, KITTI odometry."""
