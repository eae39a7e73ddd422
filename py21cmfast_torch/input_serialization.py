"""Input parameter (de)serialization: dict / TOML round trips.

Equivalent of reference input_serialization.py:86-288.  TOML reading uses the
stdlib tomllib; writing uses a minimal emitter (tomlkit is not available in the
runtime image, and our needs are flat tables of scalars).
"""

from __future__ import annotations

import tomllib
from pathlib import Path

import attrs

from .inputs import (
    AstroOptions,
    AstroParams,
    CosmoParams,
    InputParameters,
    MatterOptions,
    SimulationOptions,
)

_GROUPS = {
    "cosmo_params": CosmoParams,
    "matter_options": MatterOptions,
    "simulation_options": SimulationOptions,
    "astro_options": AstroOptions,
    "astro_params": AstroParams,
}


def serialize_inputs(inputs: InputParameters) -> dict:
    out = {"random_seed": inputs.random_seed, "node_redshifts": list(inputs.node_redshifts)}
    for gname, cls in _GROUPS.items():
        grp = getattr(inputs, gname)
        out[gname] = {
            f.name: getattr(grp, f.name)
            for f in attrs.fields(cls)
            if getattr(grp, f.name) is not None
        }
    return out


def deserialize_inputs(d: dict) -> InputParameters:
    kwargs = {}
    for gname, cls in _GROUPS.items():
        if gname in d:
            valid = {f.name for f in attrs.fields(cls)}
            kwargs[gname] = cls(**{k: v for k, v in d[gname].items() if k in valid})
    return InputParameters(
        random_seed=d.get("random_seed", 0),
        node_redshifts=tuple(d.get("node_redshifts", ())),
        **kwargs,
    )


def _toml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return repr(v)


def write_inputs_to_toml(inputs: InputParameters, path):
    d = serialize_inputs(inputs)
    lines = []
    for k, v in d.items():
        if not isinstance(v, dict):
            lines.append(f"{k} = {_toml_value(v)}")
    for gname, grp in d.items():
        if isinstance(grp, dict):
            lines.append(f"\n[{gname}]")
            for k, v in grp.items():
                lines.append(f"{k} = {_toml_value(v)}")
    Path(path).write_text("\n".join(lines) + "\n")


def read_inputs_from_toml(path) -> InputParameters:
    with open(path, "rb") as f:
        return deserialize_inputs(tomllib.load(f))
