"""Typed exceptions + output validation.

Equivalent of reference exceptions.h:12-21 + wrapper/exceptions.py:8-117: the C
exit-code protocol becomes plain Python exceptions; the per-cell NaN/Inf
sweeps of the C kernels (e.g. SpinTemperatureBox.c:1915-1935) become one
device-side count per snapshot.

The drivers call `check_nonfinite(z, *outputs)`: the counts of every float
field of a snapshot are stacked on the device and fetched in one transfer.
`validate_box` and `validate_snapshot` keep the JAX package's names and
messages for callers that check a box or a snapshot themselves.  The JAX
package's `begin_validate_snapshot` and its pending handle have no
counterpart: they exist to overlap the sweep of one node with the next
node's jitted program on the TPU, and here the count is one small transfer
after the node's kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "ParameterError",
    "TableGenerationError",
    "InfinityOrNaNError",
    "PhotonConsError",
    "check_nonfinite",
    "validate_box",
    "validate_snapshot",
]


class ParameterError(ValueError):
    """Invalid or inconsistent input parameters."""


class TableGenerationError(RuntimeError):
    """An interpolation table could not be built (bad limits, non-finite)."""


class InfinityOrNaNError(FloatingPointError):
    """A computed box contains non-finite values."""


class PhotonConsError(RuntimeError):
    """The photon-conservation correction failed (e.g. stalled reionization)."""


def validate_box(output, fields=None, context=""):
    """Raise InfinityOrNaNError if any named float field of `output` is
    non-finite (all fields when `fields` is None).  Tensors are counted on
    their device, one scalar transfer a field.  Returns `output`."""
    for f in dataclasses.fields(output):
        if fields is not None and f.name not in fields:
            continue
        val = getattr(output, f.name)
        if val is None:
            continue
        if isinstance(val, torch.Tensor):
            if not val.is_floating_point():
                continue
            bad = int((~torch.isfinite(val)).sum())
        else:
            arr = np.asarray(val)
            if arr.dtype.kind != "f":
                continue
            bad = int(np.sum(~np.isfinite(arr)))
        if bad:
            raise InfinityOrNaNError(
                f"{type(output).__name__}.{f.name} has {bad} non-finite values"
                + (f" ({context})" if context else "")
            )
    return output


def validate_snapshot(z, *outputs):
    """Validate every box of a snapshot if config['validate_outputs'] is set."""
    check_nonfinite(z, *outputs)


def check_nonfinite(z, *outputs):
    """Raise InfinityOrNaNError if any float field of the given output structs
    holds a NaN or Inf.  The counts of all device fields are stacked on the
    device and fetched in one transfer.  Skipped when
    `config["validate_outputs"]` is off."""
    from ._cfg import config

    if not config.get("validate_outputs", True):
        return
    names, counts, bad = [], [], []
    for out in outputs:
        if out is None or not dataclasses.is_dataclass(out):
            continue
        for f in dataclasses.fields(out):
            val = getattr(out, f.name)
            label = f"{type(out).__name__}.{f.name}"
            if isinstance(val, torch.Tensor):
                if val.is_floating_point():
                    names.append(label)
                    counts.append((~torch.isfinite(val)).sum())
            elif val is not None:
                arr = np.asarray(val)
                if arr.dtype.kind == "f" and (n := int(np.sum(~np.isfinite(arr)))):
                    bad.append((label, n))
    if counts:
        vals = torch.stack([c.to(counts[0].device) for c in counts]).cpu().tolist()
        bad += [(n, v) for n, v in zip(names, vals) if v]
    if bad:
        msgs = ", ".join(f"{n} has {v} non-finite values" for n, v in bad)
        raise InfinityOrNaNError(f"{msgs} (z={float(z):.3f})")
