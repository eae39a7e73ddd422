"""deposit.roofline_pct: the CIC deposit kernel's share of its byte
roofline (csrc/cic_deposit.cu): the bytes the deposit needs, counted from
the shapes whatever implements it (4 DIM^3 + 16 HII_DIM^3), over the H100's
3.35e12 B/s, divided by the profiler window's mean time of a device op named
cic_deposit.  Nothing to read where the window saw no such op."""

UNIT = "%"
LAYER = "CIC deposit kernel"
MOVES = "lightcone_s"


def read(record):
    w = record.get("window") or {}
    t = w.get("deposit_s_per_call")
    return None if not t else 100.0 * record["deposit_bound_s"] / t
