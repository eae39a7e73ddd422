"""ionize.s_per_node: seconds of `compute_ionization_field`
(models/ionization.py) a node, the window's spans over its nodes."""

UNIT = "s"
LAYER = "ionization"
MOVES = "lightcone_s"


def read(record):
    s = record["layer_s"].get("ionize")
    return None if s is None or not record["nodes"] else s / record["nodes"]
