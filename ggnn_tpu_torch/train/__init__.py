"""Training support; this slice carries the checkpoint format only."""
