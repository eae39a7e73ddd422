"""ref21cm: the benchmark's reference of the 21cmFAST lightcone path.

Two parts, neither importing anything of the program under test:

- `plain` and `cone`, written for the benchmark from the equations, in
  float32 (the initial conditions) and float64 (the rest): the initial conditions, the 2LPT perturbed density and
  velocity with a plain cloud-in-cell scatter, the brightness temperature,
  the node ladder, the lightcone slices, the velocity-gradient correction
  and the RSDs;
- the astrophysics of the spin temperature and the ionization
  (`models/`, with the input parameters, the background cosmology and the
  host tables they read: `inputs.py`, `cosmology/`, `ops/`, `_data/`), a
  frozen copy of the port's plain PyTorch and numpy code taken when the
  benchmark was written.  It decides whether the program has drifted from
  those layers as they stood then, not whether they were right then.
"""

from .inputs import InputParameters

__all__ = ["InputParameters"]
