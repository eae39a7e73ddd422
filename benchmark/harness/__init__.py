"""The benchmark harness: cells, the run loop, tracing, the comparison, the reference."""
