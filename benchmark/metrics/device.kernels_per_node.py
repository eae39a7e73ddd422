"""device.kernels_per_node: device kernels (memory copies and sets left out)
in the profiler window, over its nodes: cuFFT, the hand-written kernels and
torch's elementwise and reduction kernels (ops/*)."""

UNIT = "kernels/node"
LAYER = "device"
MOVES = "lightcone_s"


def read(record):
    w = record.get("window") or {}
    if "kernels" not in w or not w.get("nodes"):
        return None
    return w["kernels"] / w["nodes"]
