"""Host I/O of the port: settings, datasets, native fast I/O, trajectories."""
