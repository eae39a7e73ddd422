"""Typed exceptions + output validation.

Equivalent of reference exceptions.h:12-21 + wrapper/exceptions.py:8-117: the C
exit-code protocol becomes plain Python exceptions; the per-cell NaN/Inf
sweeps of the C kernels (e.g. SpinTemperatureBox.c:1915-1935) become one
device-side count per snapshot.

The scroll validates one node late, as the JAX package's does:
`begin_validate_snapshot` stacks the counts of every float field of a
snapshot on the device and starts their copy to the host without waiting,
and `check_nonfinite` of that handle, called at the next node (and once
after the last), waits on the copy and raises.  `validate_snapshot` does
both at once; `validate_box` checks one box.
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
    "begin_validate_snapshot",
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
    check_nonfinite(begin_validate_snapshot(z, *outputs))


def begin_validate_snapshot(z, *outputs):
    """Start the non-finite sweep of a snapshot without waiting on it.

    Returns a pending handle for `check_nonfinite`, or None when
    `config["validate_outputs"]` is off.  The counts of every float device
    field with ndim > 0 are stacked in one device op; on a CUDA device they
    are copied into pinned host memory without blocking and an event is
    recorded after the copy, so the scroll checks node i while node i+1
    computes.  Host (numpy) fields are counted at once."""
    from ._cfg import config

    if not config.get("validate_outputs", True):
        return None
    names, counts, host_bad = [], [], []
    for out in outputs:
        if out is None or not dataclasses.is_dataclass(out):
            continue
        for f in dataclasses.fields(out):
            val = getattr(out, f.name)
            if val is None:
                continue
            label = f"{type(out).__name__}.{f.name}"
            if isinstance(val, torch.Tensor):
                if val.is_floating_point() and val.ndim > 0:
                    names.append(label)
                    counts.append((~torch.isfinite(val)).sum())
            else:
                arr = np.asarray(val)
                if arr.dtype.kind == "f" and (n := int(np.sum(~np.isfinite(arr)))):
                    host_bad.append((label, n))
    stacked, done = None, None
    if counts:
        stacked = torch.stack([c.to(counts[0].device) for c in counts])
        if stacked.is_cuda:
            host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
            host.copy_(stacked, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            stacked = host
    return (float(z), names, stacked, done, host_bad)


def check_nonfinite(pending):
    """Wait on a `begin_validate_snapshot` handle (its copy's event, not the
    whole device) and raise InfinityOrNaNError on any non-finite count."""
    if pending is None:
        return
    z, names, counts, done, host_bad = pending
    bad = list(host_bad)
    if counts is not None:
        if done is not None:
            done.synchronize()
        bad += [(n, v) for n, v in zip(names, counts.tolist()) if v]
    if bad:
        msgs = ", ".join(f"{n} has {v} non-finite values" for n, v in bad)
        raise InfinityOrNaNError(f"{msgs} (z={z:.3f})")
