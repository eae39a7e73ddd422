"""Device selection for the public entry points.

Every entry point takes `device="cuda"` and runs on the card.  The CPU is used
only when the caller asks for it (`device="cpu"`, as the CPU tests do); a
request for the card on a machine without one raises instead of falling back.
Every tensor made from host data goes through `to_device`, which counts it.
"""

from __future__ import annotations

import torch

from . import tracing


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev



def to_device(a, device, dtype=None) -> torch.Tensor:
    """`torch.as_tensor(a, dtype=dtype, device=device)` of host data (numpy or
    Python values), counted as one `h2d.uploads` under the open stage."""
    tracing.count("h2d.uploads")
    return torch.as_tensor(a, dtype=dtype, device=device)
