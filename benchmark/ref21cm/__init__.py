"""ref21cm: the benchmark's reference of the 21cmFAST lightcone path.

Two parts, neither importing anything of the program under test:

- `plain` and `cone`, written for the benchmark from the equations, in
  float32 (the initial conditions) and float64 (the rest): the initial conditions, the 2LPT perturbed density and
  velocity with a plain cloud-in-cell scatter, the brightness temperature,
  the node ladder, the lightcone slices, the velocity-gradient correction
  and the RSDs;
- `halos` and `gate`, written for the benchmark from the equations in
  float64, where the configuration samples halos: the catalogs are the
  compared cone's own, handed over by the harness as the cone's random
  input (the one thing the reference takes from the program); `halos`
  moves and grids them into the HaloBox and the XraySourceBox that the
  frozen spin temperature and ionization read, and `gate` holds them to the
  conditional mass function by the reference's own tables;
- the astrophysics of the spin temperature and the ionization
  (`models/`, with the input parameters, the background cosmology and the
  host tables they read: `inputs.py`, `cosmology/`, `ops/`, `_data/`), a
  frozen copy of the port's plain PyTorch and numpy code taken when the
  benchmark was written.  It decides whether the program has drifted from
  those layers as they stood then, not whether they were right then.
"""

from .inputs import InputParameters

__all__ = ["InputParameters"]
