"""perturb.ms_per_node: milliseconds of `perturb_field` (models/perturb.py,
ops/deposit.py) a node, the window's spans over its nodes."""

UNIT = "ms"
LAYER = "perturb"
MOVES = "lightcone_s"


def read(record):
    s = record["layer_s"].get("perturb")
    return None if s is None or not record["nodes"] else 1e3 * s / record["nodes"]
