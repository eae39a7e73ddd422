"""ts.scan_s_per_node: host seconds a node of the spin temperature's shell
scan, the program's span `ts.scan` around `_ts_shell_scan`
(models/spintemp.py): its launches, and its waits where the card is behind.
The window's cones are the last `record["cones"]` runs of the program's
recorder (`py21cmfast_torch.tracing.runs()`): the warm-up cone of set-up is
the run before them, and the reference imports nothing of the program. None
unless the node counts of those runs add up to `record["nodes"]`, or where
the program has no recorder."""

UNIT = "s"
LAYER = "spin temperature"
MOVES = "lightcone_s"
SPAN = "ts.scan"


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
