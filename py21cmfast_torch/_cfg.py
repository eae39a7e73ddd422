"""Machine/environment configuration (reference _cfg.py:20-109).

A small global `config` dict backed by ~/.py21cmfast_tpu/config.toml, for
settings that do not define a run (cache directory, memory knobs).  There is
no C `config_settings` mirror — jitted kernels read everything explicitly.
"""

from __future__ import annotations

import os
import tomllib
from pathlib import Path

_DEFAULTS = {
    "direc": str(Path(os.environ.get("PY21CMFAST_TPU_CACHE", "~/21cmFAST-tpu-cache")).expanduser()),
    "ignore_R_BUBBLE_MAX_error": False,
    "HALO_CATALOG_MEM_FACTOR": 1.5,
    "EXTRA_HALOBOX_FIELDS": False,
    "cache_param_sigfigs": 6,
    # per-snapshot NaN/Inf guard in the drivers (reference: in-kernel isfinite
    # sweeps, SpinTemperatureBox.c:1915-1935); device-side, one scalar per field
    "validate_outputs": True,
}

_CONFIG_PATH = Path("~/.py21cmfast_tpu/config.toml").expanduser()


class Config(dict):
    """Dict with defaults + optional on-disk persistence."""

    def __init__(self):
        super().__init__(_DEFAULTS)
        if _CONFIG_PATH.exists():
            with open(_CONFIG_PATH, "rb") as f:
                self.update(tomllib.load(f))

    def write(self):
        _CONFIG_PATH.parent.mkdir(parents=True, exist_ok=True)
        lines = []
        for k, v in self.items():
            if isinstance(v, bool):
                lines.append(f"{k} = {'true' if v else 'false'}")
            elif isinstance(v, str):
                lines.append(f'{k} = "{v}"')
            else:
                lines.append(f"{k} = {v}")
        _CONFIG_PATH.write_text("\n".join(lines) + "\n")


config = Config()
