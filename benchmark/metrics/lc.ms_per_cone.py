"""lc.ms_per_cone: milliseconds a cone of the lightcone driver's own calls
(drivers/lightcone.py, lightconers.py, rsds.py): the spans around
`make_lightcone_slices`, `include_dvdr_in_tau21` and `apply_rsds`, over the
window's cones."""

UNIT = "ms"
LAYER = "lightcone driver"
MOVES = "lightcone_s"


def read(record):
    s = sum(record["layer_s"].get(k, 0.0) for k in ("slices", "dvdr", "RSDs"))
    return None if not record["cones"] else 1e3 * s / record["cones"]
