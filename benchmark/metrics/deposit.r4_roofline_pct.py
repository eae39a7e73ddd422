"""deposit.r4_roofline_pct: the ratio-4 CIC deposit kernel's share of its
byte roofline (csrc/cic_deposit.cu, `cic_deposit_swept_kernel<4>`): the
bytes the deposit needs, counted from the shapes whatever implements it
(4 DIM^3 + 16 HII_DIM^3, 4563.4 MB at 1024^3 -> 256^3), over the H100's
3.35e12 B/s (1.362 ms), divided by the profiler window's mean time of a
device op named cic_deposit.

A name of its own beside `deposit.roofline_pct`: the ratio-4 instantiation
is a separately compiled kernel with its own register budget (it spills
where the ratio-3 one does not), so its share is read only in the cells
that run it and is never averaged with the other's.  Nothing to read where
the window saw no such op."""

UNIT = "%"
LAYER = "CIC deposit kernel"
MOVES = "lightcone_s"


def read(record):
    w = record.get("window") or {}
    t = w.get("deposit_s_per_call")
    return None if not t else 100.0 * record["deposit_bound_s"] / t
