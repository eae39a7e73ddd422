"""The reference: `ref21cm` computes the ICs and the cone again from the
cell's inputs, and the control puts it in the program's place one precision
lower.

`ref21cm` imports nothing of the program and takes nothing the program made:
it builds its own inputs from the configuration and traffic files and the
seed, its own ICs, perturbed fields (a plain float64 scatter for the CIC
deposit), host tables, slices and RSDs.  Its ICs (float32), perturb,
brightness temperature, slices, velocity-gradient correction and RSDs
(float64) are written for the benchmark (`ref21cm/plain.py`); its spin temperature and
ionization are a frozen copy of the port's plain code, in float32 as the
program states them (see `ref21cm/__init__.py`).

The control (`precision="bfloat16"`) is the reference with every stage's
output rounded to bfloat16, the precision below the float32 the program's
fields are stated in: the ICs, each node's perturbed field, HaloBox and
XraySourceBox, spin temperature and its carried state, ionized box and
brightness temperature.  A limit that this passes is too loose to tell
float32 from bfloat16.

Where the configuration samples halos, the one thing the reference takes
from the program is the compared cone's halo catalogs, as the host copies
that its scroll parks there (`loop.py`): the sampler is random, so its
catalogs are the cone's random input, as a model's seeded weights are.  The
reference computes everything after them itself (`ref21cm/halos.py`: the
perturbed catalog, the HaloBox, the XraySourceBox), and `gate` holds the
catalogs to the conditional mass function by the reference's own tables
(`ref21cm/gate.py`).  The catalogs, being input, are not rounded by the
control; the HaloBox grids and the source box are.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import cells


def round_bf16(obj):
    """Float tensors rounded to bfloat16 and back to their type, through
    dataclasses and tuples; everything else as it is."""
    import torch

    if isinstance(obj, torch.Tensor):
        if obj.dtype in (torch.float32, torch.float64):
            return obj.to(torch.bfloat16).to(obj.dtype)
        return obj
    if isinstance(obj, tuple):
        return tuple(round_bf16(o) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: round_bf16(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _rounding(precision: str):
    if precision == "float32":
        return lambda x: x
    if precision != "bfloat16":
        raise ValueError(f"unknown precision {precision!r}")
    return round_bf16


def inputs(cell, seed, overrides=None):
    import ref21cm

    return cells.build_inputs(ref21cm.InputParameters, cell, seed, overrides)


def initial_conditions(cell, seed, dev, overrides=None, precision="float32"):
    """The reference's ICs of the cell at `seed`."""
    from ref21cm import plain

    return _rounding(precision)(plain.initial_conditions(inputs(cell, seed, overrides), dev))


def catalogs_of(host_catalogs: dict) -> dict:
    """The program's host catalogs as the reference reads them: {float32
    node redshift: ref21cm HaloCatalog} holding the same tensors."""
    from ref21cm.outputs import HaloCatalog

    return {float(np.float32(c.redshift)): HaloCatalog(
        redshift=np.float32(c.redshift), halo_masses=c.halo_masses, halo_coords=c.halo_coords,
        star_rng=c.star_rng, sfr_rng=c.sfr_rng, xray_rng=c.xray_rng, n_halos=int(c.n_halos))
        for c in host_catalogs.values()}


def gate(cell, seed, catalogs, ics, overrides=None) -> dict:
    """The catalog gate's numbers beside their limits (`ref21cm/gate.py`),
    at the reference's own Lagrangian density."""
    from ref21cm import gate as gate_module

    return gate_module.check(inputs(cell, seed, overrides), catalogs, ics.lowres_density)


def cone(cell, seed, ics, dev, overrides=None, precision="float32", catalogs=None) -> dict:
    """The reference's finished cone from its own ICs: {quantity: tensor},
    with the quantities the program's cone holds.  It runs its own chain over
    the same node ladder (from Z_HEAT_MAX where the physics carries a
    history) and slices the same band; where the configuration samples
    halos, from `catalogs` (`catalogs_of`)."""
    from ref21cm import cone as cone_module

    inp = inputs(cell, seed, overrides)
    use_ts = inp.astro_options.USE_TS_FLUCT
    dvdr = bool(cell.traffic["include_dvdr_in_tau21"])
    rsds = bool(cell.traffic["apply_rsds"])
    quantities = list(cells.lightcone_quantities(cell, use_ts))
    if dvdr or rsds:
        quantities.append("velocity_z")
    band = cells.band_nodes(cell, inp)
    return cone_module.cone(inp, ics, tuple(dict.fromkeys(quantities)), dvdr, rsds, dev,
                            _rounding(precision), band=(min(band), max(band)),
                            catalogs=catalogs)
