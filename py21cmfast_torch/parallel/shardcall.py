"""Run a GridOps-aware physics scan on this rank's slabs.

The scans (`_ionize_scan`, `_ts_shell_scan`, `_annulus_scan`) are written
against the `ops.gridops.GridOps` seam.  Under SPMD their grid arguments
already are this rank's x-slabs, so the call only checks that they are and
hands the scan the mesh's GridOps, which swaps in the slab FFT and the means
over the ranks.  Follows py21cmfast_tpu/parallel/shardcall.py, where
`shard_map` does the slicing that the ranks' own data does here.
"""

from __future__ import annotations

import torch

from ..ops.gridops import GridOps

__all__ = ["sharded_kernel_call"]


def _check_slabs(obj, lo_shape, local, where="argument"):
    """Raise for a tensor whose trailing three dims are the global grid's
    (a whole box handed to a rank) when the rank's slab is smaller."""
    if isinstance(obj, torch.Tensor):
        if obj.dim() >= 3 and tuple(obj.shape[-3:]) == tuple(lo_shape) and local != tuple(lo_shape):
            raise ValueError(
                f"sharded_kernel_call: a whole {tuple(lo_shape)} grid was handed to a rank as "
                f"{where}; each rank takes its x-slab {local}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _check_slabs(v, lo_shape, local, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _check_slabs(v, lo_shape, local, f"{where}[{i}]")


def sharded_kernel_call(mesh, kernel, args, static_kwargs, lo_shape):
    """`kernel(*args, **static_kwargs, gops=GridOps(mesh))` after checking
    that no grid among the arguments is a whole box.  Returns the kernel's
    outputs, this rank's slabs."""
    gops = GridOps(mesh)
    local = gops.local_shape(lo_shape)
    _check_slabs(tuple(args), lo_shape, local)
    _check_slabs(static_kwargs, lo_shape, local, "keyword")
    return kernel(*args, **static_kwargs, gops=gops)
