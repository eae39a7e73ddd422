"""Grid operations on tensors the frozen astrophysics reads: FFTs, k-grids, filters."""
