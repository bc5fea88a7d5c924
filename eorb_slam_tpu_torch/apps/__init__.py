"""Dataset-driven runners."""
