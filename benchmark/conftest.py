"""Shared fixtures of the benchmark's own tests (run from the repository
root: `python -m pytest benchmark -q -p no:cacheprovider`).

The CPU tests drive the harness at tiny boxes with `device="cpu"`; tests
that need the card are marked `cuda` and skip inside the `cuda_device`
fixture where there is none.
"""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# a sixth of the cores a process, as the repository's CPU tests do
torch.set_num_threads(max(1, (torch.get_num_threads() or 6) // 6))

# tiny boxes of each configuration, and a short ladder, for CPU runs: the
# smallest box BOX_LEN = 1.5 HII_DIM allows with R_BUBBLE_MAX = 50 (the
# latest template) and with the simple template's 15 Mpc
TINY = {
    "latest-256-768": dict(HII_DIM=34, DIM=136, BOX_LEN=51.0, ZPRIME_STEP_FACTOR=1.2),
    "simple-256-768": dict(HII_DIM=16, DIM=48, BOX_LEN=24.0, ZPRIME_STEP_FACTOR=1.2),
}
SEED = 2**31 + 4711  # seeds past 32 signed bits must work


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
