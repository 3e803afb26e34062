"""I/O layer: point sources (LAS/LAZ) and node persistence sinks."""
