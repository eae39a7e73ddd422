"""ics.s: seconds of the ICs' first call in the run, a span around
`compute_initial_conditions` in set-up (models/ics.py)."""

UNIT = "s"
LAYER = "initial conditions"
MOVES = "setup_s"


def read(record):
    return record.get("ics_s")
