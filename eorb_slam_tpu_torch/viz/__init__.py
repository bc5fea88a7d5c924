"""Headless host visualization (the reference viewer layer, without Pangolin)."""
