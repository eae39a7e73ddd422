"""ts.s_per_node: seconds of `compute_spin_temperature` (models/spintemp.py
with its host tables in heating.py, lya_heating.py, hmf.py) a node, the
window's spans over its nodes.  Nothing to read where Ts does not run."""

UNIT = "s"
LAYER = "spin temperature"
MOVES = "lightcone_s"


def read(record):
    s = record["layer_s"].get("Ts")
    return None if s is None or not record["nodes"] else s / record["nodes"]
