"""On-disk box cache + run-level resume.

Equivalent of reference io/caching.py:31-621, with the scheme of
py21cmfast_tpu/io/caching.py: a hash-keyed directory tree
  {matter_cosmo_hash[:16]}/{seed}/{zgrid_hash[:8]}/z{redshift:.5f}/{astro_hash[:16]}/{Class}.h5
(`OutputCache`; the InitialConditions sit at {matter_cosmo_hash[:16]}/{seed}),
a run-completeness view (`RunCache`) from which the coeval and lightcone
scrolls resume after the last fully cached node, and per-box-type write flags
(`CacheConfig`).  The port hashes its inputs as the JAX package does, so one
set of inputs has one path in both packages and either reads the other's
files.  Reads return the grids on the `device` they are given.  The files
need h5py (io/h5.py).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from ..inputs import InputParameters
from . import h5 as h5io

__all__ = ["OutputCache", "RunCache", "CacheConfig"]

_Z_INDEPENDENT = ("InitialConditions",)


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Which box types get written (reference CacheConfig, caching.py:554)."""

    initial_conditions: bool = True
    perturbed_field: bool = True
    halobox: bool = True
    spin_temp: bool = True
    ionized_box: bool = True
    brightness_temp: bool = True
    halo_catalogs: bool = True

    _map = {
        "InitialConditions": "initial_conditions",
        "PerturbedField": "perturbed_field",
        "HaloBox": "halobox",
        "XraySourceBox": "spin_temp",
        "TsBox": "spin_temp",
        "IonizedBox": "ionized_box",
        "BrightnessTemp": "brightness_temp",
        "HaloCatalog": "halo_catalogs",
        "PerturbedHaloCatalog": "halo_catalogs",
    }

    def writes(self, cls_name: str) -> bool:
        return getattr(self, self._map.get(cls_name, "initial_conditions"))

    @classmethod
    def off(cls):
        return cls(**{f.name: False for f in dataclasses.fields(cls)})


class OutputCache:
    """Hash-keyed HDF5 cache of individual output boxes."""

    def __init__(self, direc):
        self.direc = Path(direc)

    def _path(self, cls_name: str, inputs: InputParameters, redshift: float | None):
        parts = [inputs.matter_cosmo_hash[:16], str(inputs.random_seed)]
        if cls_name not in _Z_INDEPENDENT:
            parts.append(inputs.zgrid_hash[:8])
            parts.append(f"z{redshift:.5f}")
            parts.append(inputs.astro_hash[:16])
        return self.direc.joinpath(*parts, f"{cls_name}.h5")

    def write(self, output, inputs: InputParameters, redshift: float | None = None):
        cls_name = type(output).__name__
        if redshift is None and hasattr(output, "redshift"):
            redshift = float(output.redshift)
        path = self._path(cls_name, inputs, redshift)
        h5io.write_output_to_hdf5(output, path, inputs=inputs)
        return path

    def exists(self, cls, inputs: InputParameters, redshift: float | None = None) -> bool:
        name = cls if isinstance(cls, str) else cls.__name__
        return self._path(name, inputs, redshift).exists()

    def read(self, cls, inputs: InputParameters, redshift: float | None = None, *,
             device="cuda"):
        """The cached box, its grids on `device`, or None."""
        name = cls if isinstance(cls, str) else cls.__name__
        path = self._path(name, inputs, redshift)
        if not path.exists():
            return None
        box, _ = h5io.read_output_from_hdf5(path, device=device)
        return box

    def find_existing(self, inputs: InputParameters):
        """List cached (cls_name, redshift) pairs for this input set."""
        out = []
        for cls_name in h5io._OUTPUT_CLASSES:
            if cls_name in _Z_INDEPENDENT:
                if self.exists(cls_name, inputs):
                    out.append((cls_name, None))
            else:
                base = self.direc / inputs.matter_cosmo_hash[:16] / str(
                    inputs.random_seed
                ) / inputs.zgrid_hash[:8]
                if base.exists():
                    for zdir in base.iterdir():
                        p = zdir / inputs.astro_hash[:16] / f"{cls_name}.h5"
                        if p.exists():
                            out.append((cls_name, float(zdir.name[1:])))
        return out


class RunCache:
    """A full-run view over OutputCache: resume support (caching.py:280-537)."""

    def __init__(self, cache: OutputCache, inputs: InputParameters):
        self.cache = cache
        self.inputs = inputs

    def required_classes(self):
        ao = self.inputs.astro_options
        mo = self.inputs.matter_options
        req = ["PerturbedField", "IonizedBox", "BrightnessTemp"]
        if ao.USE_TS_FLUCT:
            req.append("TsBox")
            # the Ts shell ladder in the halo-sampler path rebuilds the
            # XraySourceBox from the HaloBox node history, so resume needs it
            if mo.source_model_uses_halo_sampler:
                req.append("HaloBox")
        return req

    def is_complete_at(self, redshift: float) -> bool:
        return all(
            self.cache.exists(c, self.inputs, redshift) for c in self.required_classes()
        )

    def last_complete_node(self):
        """Largest index i such that node_redshifts[0..i] are all cached."""
        last = -1
        for i, z in enumerate(self.inputs.node_redshifts):
            if self.is_complete_at(z):
                last = i
            else:
                break
        return last

    def load_at(self, redshift: float, *, device="cuda"):
        return {
            c: self.cache.read(c, self.inputs, redshift, device=device)
            for c in self.required_classes()
        }
