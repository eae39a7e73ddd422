"""scroll.self_ms_per_node: milliseconds a node of the coeval scroll
(drivers/coeval.py) and the lightcone driver's node loop outside the stage
spans: the window's node walls minus the perturb, Ts, ionize, Tb and slice
spans inside them, over its nodes."""

UNIT = "ms"
LAYER = "coeval scroll"
MOVES = "lightcone_s"


def read(record):
    n = record["nodes"]
    return None if not n else 1e3 * (record["node_wall_s"] - record["node_stage_s"]) / n
