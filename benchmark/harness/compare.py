"""The comparison that decides `correct`: what the timed path produced
against the reference's own computation of the same cone.

Each number is the relative L2 gap of one output, ||p - r|| / ||r||, in
float64, taken over every cell of it:

- `ics`: the worst of the initial conditions' fields (the hires density, the
  lowres density, the velocities and their 2LPT terms);
- one per lightcone quantity of the cone (`Tb` is the finished brightness
  temperature, after the velocity-gradient correction and the RSDs), which
  holds every node's perturbed density, spin temperature, x_e and xH through
  the slices interpolated between nodes.

A cone whose quantities or shape differ from the reference's reads inf.
Each number has its own limit, in `limits/<workload>.toml`; a number with no
limit fails.
"""

from __future__ import annotations

import math

SHORT = {
    "brightness_temp": "Tb",
    "density": "density",
    "spin_temperature": "Ts",
    "xray_ionised_fraction": "x_e",
    "neutral_fraction": "xH",
    "tau_21": "tau21",
    "velocity_z": "v_z",
}
IC_FIELDS = ("hires_density", "lowres_density", "vx", "vy", "vz", "vx_2LPT", "vy_2LPT", "vz_2LPT")
ROWS = 32  # leading-axis rows a block, so float64 copies stay small


def rel_l2(p, r) -> float:
    """||p - r|| / ||r|| in float64, in blocks of rows, on r's device."""
    import torch

    if p is None or r is None or tuple(p.shape) != tuple(r.shape):
        return math.inf
    num = den = 0.0
    for i in range(0, r.shape[0], ROWS):
        rb = r[i:i + ROWS].to(torch.float64)
        pb = p[i:i + ROWS].to(device=r.device, dtype=torch.float64)
        num += float(torch.sum((pb - rb) ** 2))
        den += float(torch.sum(rb ** 2))
    if not math.isfinite(num):
        return math.inf
    return math.sqrt(num / den) if den > 0 else (0.0 if num == 0 else math.inf)


def ics_reading(prog_ics, ref_ics) -> float:
    worst = 0.0
    for name in IC_FIELDS:
        p, r = getattr(prog_ics, name, None), getattr(ref_ics, name, None)
        if p is None and r is None:
            continue
        worst = max(worst, rel_l2(p, r))
    return worst


def cone_readings(prog_cones: dict, ref_cones: dict) -> dict:
    """One number per lightcone quantity; inf where the two cones differ in
    their quantities."""
    out = {}
    for q in sorted(set(prog_cones) | set(ref_cones)):
        out[SHORT.get(q, q)] = rel_l2(prog_cones.get(q), ref_cones.get(q))
    return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}})."""
    checks, ok = {}, True
    for name, value in readings.items():
        limit = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= float(limit):
            ok = False
    return ok, checks
