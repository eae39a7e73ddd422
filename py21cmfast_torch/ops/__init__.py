"""Grid operations on tensors: FFTs, k-grids, filters, CIC and the deposit kernel."""
