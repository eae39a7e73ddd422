"""Versioned HDF5 read/write of output boxes.

Equivalent of reference io/h5.py:70-428, with the layout of
py21cmfast_tpu/io/h5.py: each output struct is one HDF5 file whose attrs hold
`format_version`, `output_class` and the full InputParameters (`inputs`, the
JSON of `serialize_inputs`), with one group named after the class holding a
dataset per array field (gzip at ndim >= 3) and the 0-d fields as group
attrs.  So any box is reproducible from its file alone, and a file of either
package reads in the other.

Tensors are copied to the host to be written.  The readers return the grids
as tensors on `device` and the per-snapshot scalars as numpy float32, as the
port's structs hold them.  h5py is imported inside the functions: it is
optional, and `import py21cmfast_torch` does not need it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from .. import outputs as outputs_module
from .._device import resolve_device
from ..input_serialization import deserialize_inputs, serialize_inputs

__all__ = [
    "FORMAT_VERSION",
    "require_h5py",
    "write_output_to_hdf5",
    "read_output_from_hdf5",
    "read_output_struct",
    "read_inputs",
]

FORMAT_VERSION = "py21cmfast_torch:1"

_OUTPUT_CLASSES = {
    cls.__name__: cls
    for cls in (
        outputs_module.InitialConditions,
        outputs_module.PerturbedField,
        outputs_module.IonizedBox,
        outputs_module.TsBox,
        outputs_module.BrightnessTemp,
        outputs_module.HaloBox,
        outputs_module.XraySourceBox,
        outputs_module.HaloCatalog,
        outputs_module.PerturbedHaloCatalog,
    )
}

_CATALOGS = ("HaloCatalog", "PerturbedHaloCatalog")


def require_h5py():
    """The h5py module, or an ImportError that names it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "the output cache and the HDF5 files of py21cmfast_torch need the optional "
            "`h5py` package, which is not installed"
        ) from e
    return h5py


def write_output_to_hdf5(output, path, inputs=None, extra_attrs=None):
    """Write one output struct to an HDF5 file."""
    h5py = require_h5py()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.attrs["format_version"] = FORMAT_VERSION
        f.attrs["output_class"] = type(output).__name__
        if inputs is not None:
            f.attrs["inputs"] = json.dumps(serialize_inputs(inputs))
        for k, v in (extra_attrs or {}).items():
            f.attrs[k] = v
        grp = f.create_group(type(output).__name__)
        for field in dataclasses.fields(output):
            val = getattr(output, field.name)
            if val is None:
                continue
            arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
            if arr.ndim == 0:
                grp.attrs[field.name] = float(arr)
            else:
                grp.create_dataset(field.name, data=arr, compression="gzip" if arr.ndim >= 3 else None)
    return path


def _catalog(cls, grp, dev):
    """A halo catalog from its group: the first `n_halos` entries of each
    per-halo array (the JAX package's catalogs may carry padding beyond
    them) as float32 tensors, `n_halos` an int."""
    n = int(grp.attrs["n_halos"])

    def take(name, shape):
        return torch.as_tensor(np.asarray(grp[name][...], np.float32)[:n].reshape(shape), device=dev)

    return cls(
        redshift=np.float32(grp.attrs["redshift"]),
        halo_masses=take("halo_masses", (n,)),
        halo_coords=take("halo_coords", (n, 3)),
        star_rng=take("star_rng", (n,)),
        sfr_rng=take("sfr_rng", (n,)),
        xray_rng=take("xray_rng", (n,)),
        n_halos=n,
    )


def read_output_from_hdf5(path, cls=None, *, device="cuda"):
    """Read an output struct and its InputParameters (or None).  Float grids
    become float32 tensors on `device`, 0-d fields numpy float32."""
    h5py = require_h5py()
    dev = resolve_device(device)
    path = Path(path)
    with h5py.File(path, "r") as f:
        cls_name = f.attrs["output_class"]
        if cls is None:
            cls = _OUTPUT_CLASSES[cls_name]
        elif cls.__name__ != cls_name:
            raise ValueError(f"file holds {cls_name}, requested {cls.__name__}")
        grp = f[cls_name]
        if cls_name in _CATALOGS:
            box = _catalog(cls, grp, dev)
        else:
            kwargs = {}
            for field in dataclasses.fields(cls):
                if field.name in grp:
                    arr = grp[field.name][...]
                    if arr.dtype.kind == "f":
                        arr = arr.astype(np.float32, copy=False)
                    kwargs[field.name] = torch.as_tensor(arr, device=dev)
                elif field.name in grp.attrs:
                    kwargs[field.name] = np.float32(grp.attrs[field.name])
            box = cls(**kwargs)
        inputs = None
        if "inputs" in f.attrs:
            inputs = deserialize_inputs(json.loads(f.attrs["inputs"]))
    return box, inputs


def read_output_struct(path, struct=None, *, device="cuda"):
    """Read one output box from an HDF5 file (reference io/h5.py:338
    `read_output_struct`): returns the struct alone."""
    box, _inputs = read_output_from_hdf5(path, cls=struct, device=device)
    return box


def read_inputs(path):
    """Read the InputParameters stored in an output HDF5 file (reference
    io/h5.py:384 `read_inputs`)."""
    h5py = require_h5py()
    path = Path(path)
    with h5py.File(path, "r") as f:
        if "inputs" not in f.attrs:
            raise KeyError(f"{path} stores no InputParameters")
        return deserialize_inputs(json.loads(f.attrs["inputs"]))
