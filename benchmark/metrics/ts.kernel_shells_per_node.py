"""ts.kernel_shells_per_node: shells a node that the spin temperature's
fused shell kernels took (csrc/ts_shell.cu), the program's counter
`ts.kernel_shells` under the stage `ts`: the ladder's length at each Ts
step on the kernel path; the torch path books none. It says that the
kernels engage on the cell's main path. The window's cones are the last
`record["cones"]` runs of the program's recorder
(`py21cmfast_torch.tracing.runs()`): the warm-up cone of set-up is the run
before them, and the reference imports nothing of the program. None unless
the node counts of those runs add up to `record["nodes"]`, or where the
program has no recorder or books no such counter."""

UNIT = "shells/node"
LAYER = "spin temperature"
MOVES = "lightcone_s"
COUNTER = "ts.kernel_shells"
STAGE = "ts"


def _books(record):
    """Every book of the window's cones (each run's own and its nodes'), or
    None unless the program has a recorder and its last `record["cones"]`
    runs hold `record["nodes"]` nodes."""
    try:
        from py21cmfast_torch import tracing
    except ImportError:
        return None
    cones = record.get("cones") or 0
    runs = tracing.runs(last=cones) if cones else []
    if len(runs) != cones or not cones or \
            sum(len(r["nodes"]) for r in runs) != record.get("nodes"):
        return None
    return [b for r in runs for b in [r] + r["nodes"]]


def read(record):
    books = _books(record)
    found = [b["counters"][COUNTER][STAGE] for b in books or ()
             if STAGE in b["counters"].get(COUNTER, {})]
    if not found:
        return None
    return sum(found) / record["nodes"]
