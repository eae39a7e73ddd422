"""ts.prefetch_overlap_pct: the share of the SFRD prefetch's build that the
nodes did not wait for, 100 (1 - `ts.sfrd_wait` s / `ts.sfrd_build` s), the
program's spans around the future's result and around the prefetch worker's
build (models/spintemp.py), each build booked to the node that asked for it.
The window's cones are the last `record["cones"]` runs of the program's
recorder (`py21cmfast_torch.tracing.runs()`): the warm-up cone of set-up is
the run before them, and the reference imports nothing of the program. None
unless the node counts of those runs add up to `record["nodes"]`, or where
the program has no recorder."""

UNIT = "%"
LAYER = "spin temperature"
MOVES = "lightcone_s"


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
    build = sum(b["spans"]["ts.sfrd_build"][1] for b in books or ()
                if "ts.sfrd_build" in b["spans"])
    if not build:
        return None
    wait = sum(b["spans"]["ts.sfrd_wait"][1] for b in books if "ts.sfrd_wait" in b["spans"])
    return 100.0 * (1.0 - wait / build)
