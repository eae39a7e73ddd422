"""ts.xe_tables_s_per_node: seconds a node of the spin temperature's
<x_e>-bound host tables, the program's span `ts.xe_tables` (a child of
`ts.host_tables`) around the tau_X = 1 horizons of the whole shell ladder
and their frequency integrals in `ts_host_tables` (models/spintemp.py):
the part of the host tables that waits on the step's <x_e> sync, so no
prefetch can take it. The window's cones are the last `record["cones"]`
runs of the program's recorder (`py21cmfast_torch.tracing.runs()`): the
warm-up cone of set-up is the run before them, and the reference imports
nothing of the program. None unless the node counts of those runs add up
to `record["nodes"]`, where the program has no recorder, or where it books
no such span."""

UNIT = "s"
LAYER = "spin temperature"
MOVES = "lightcone_s"
SPAN = "ts.xe_tables"


def _books(record):
    """Every book of the window's cones (each run's own and its nodes' from
    `record["band_first"]` on), or None unless the program has a recorder
    and its last `record["cones"]` runs hold `record["nodes"]` such nodes."""
    try:
        from py21cmfast_torch import tracing
    except ImportError:
        return None
    cones = record.get("cones") or 0
    runs = tracing.runs(last=cones) if cones else []
    first = record.get("band_first", 0)
    if len(runs) != cones or not cones or \
            sum(len(r["nodes"]) - first for r in runs) != record.get("nodes"):
        return None
    return [b for r in runs for b in [r] + r["nodes"][first:]]


def read(record):
    books = _books(record)
    found = [b["spans"][SPAN][1] for b in books or () if SPAN in b["spans"]]
    if not found:
        return None
    return sum(found) / record["nodes"]
