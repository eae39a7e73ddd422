"""The card a run measures, and the published peaks its rooflines use."""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM (data sheet): HBM3 bytes/s at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi prints it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def device_record(dev, chips: int, peak_bytes: int) -> dict:
    """The `device` object of the result line."""
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak_bytes}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(dev),
        "count": chips,
        "memory_peak_bytes": peak_bytes,
        "power_limit": power_limit(),
    }


def deposit_bytes(dim: int, hii_dim: int) -> int:
    """Bytes the swept CIC deposit needs, counted from the shapes whatever
    implements it: the float32 hires density read once (DIM^3), the three
    float32 lowres displacements read once and the float32 lowres result
    written once (4 HII_DIM^3)."""
    return 4 * dim**3 + 4 * 4 * hii_dim**3


def deposit_bound_s(dim: int, hii_dim: int) -> float:
    """The least time the deposit could take: its bytes over the HBM peak."""
    return deposit_bytes(dim, hii_dim) / PEAK_BYTES_PER_S
