"""Named parameter templates (reference _templates.py:1-169 + templates/*.toml)."""

from __future__ import annotations

import tomllib
from pathlib import Path

from .inputs import InputParameters

_TEMPLATE_DIR = Path(__file__).parent / "templates"


def _load_manifest():
    with open(_TEMPLATE_DIR / "manifest.toml", "rb") as f:
        return tomllib.load(f)["templates"]


def list_templates():
    """All available templates with descriptions."""
    return _load_manifest()


def _resolve(name: str):
    for entry in _load_manifest():
        if name == entry["name"] or name in entry.get("aliases", ()):
            return entry
    raise ValueError(
        f"unknown template {name!r}; available: "
        f"{[e['name'] for e in _load_manifest()]}"
    )


def write_template(inputs: InputParameters, template_file, mode: str = "full"):
    """Write a set of input parameters to a TOML template file (reference
    _templates.py:129-169 `write_template`).  The file round-trips through
    `create_params_from_template` / `read_inputs_from_toml`."""
    if mode not in ("full", "minimal"):
        raise ValueError("mode must be 'full' or 'minimal'")
    from .input_serialization import write_inputs_to_toml

    return write_inputs_to_toml(inputs, template_file)


def create_params_from_template(name: str, *, random_seed: int, **overrides):
    """Build InputParameters from one or more templates ('+'-separated),
    applied left to right, then flat overrides."""
    merged: dict = {}
    for part in name.split("+"):
        entry = _resolve(part.strip())
        with open(_TEMPLATE_DIR / entry["file"], "rb") as f:
            data = tomllib.load(f)
        for group, vals in data.items():
            merged.setdefault(group, {}).update(vals)

    inputs = InputParameters(random_seed=random_seed)
    flat = {}
    for group, vals in merged.items():
        flat.update(vals)
    flat.update(overrides)
    return inputs.evolve_input_structs(**flat)
