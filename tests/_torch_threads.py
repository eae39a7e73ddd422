"""Caps torch's intra-op threads in the port's CPU test processes.

The tier-1 run spreads the test files over several worker processes, and
each torch process would otherwise start one intra-op thread per core: the
workers' threads then outnumber the cores and crowd out the JAX package's
wall-clock gate (tests/test_benchmarks.py) and one another.  Each port test
process takes its share of the cores instead.  Imported by the
`tests/test_torch_*.py` files only.
"""

import os

import torch

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))
