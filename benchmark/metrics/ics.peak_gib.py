"""ics.peak_gib: the device memory the ICs reach, the program's counter
`ics.peak_bytes` (models/ics.py), `torch.cuda.max_memory_allocated` read at
the end of `compute_initial_conditions`, in GiB. The program never resets
the allocator's peak; the harness resets it just before the ICs, so this is
the ICs' own peak. Read from the process totals of the program's recorder
(`py21cmfast_torch.tracing.totals()`), a call's mean over the `ics` calls
booked (one in a run's set-up). None off the card (the counter is booked on
CUDA only), for a record of no run that made its ICs (no `ics_s`), where the
program has no recorder, or where it books no such counter."""

UNIT = "GiB"
LAYER = "initial conditions"
MOVES = "peak_gib"
COUNTER = "ics.peak_bytes"


def read(record):
    if not record.get("ics_s"):  # not the record of a run that made its ICs
        return None
    try:
        from py21cmfast_torch import tracing
    except ImportError:
        return None
    booked = tracing.totals()
    peaks = booked["counters"].get(COUNTER)
    calls = booked["spans"].get("ics", (0,))[0]
    return sum(peaks.values()) / calls / 2**30 if peaks and calls else None
