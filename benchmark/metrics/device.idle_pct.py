"""device.idle_pct: the device's idle share of the profiler window (three
consecutive nodes at the middle of the first window cone): 100 (1 - union of
device activity / the window's wall)."""

UNIT = "%"
LAYER = "device"
MOVES = "lightcone_s"


def read(record):
    w = record.get("window") or {}
    if "busy_s" not in w or not w.get("window_s"):
        return None
    return 100.0 * (1.0 - w["busy_s"] / w["window_s"])
