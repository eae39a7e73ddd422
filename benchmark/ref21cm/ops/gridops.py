"""Grid-global operations: the seam between the single-device and the
slab-sharded runs of the physics scans.

The scans (`models/ionization._ionize_scan`, `models/spintemp._ts_shell_scan`
and `_ts_cell_update`, `models/xray_source._annulus_scan`) call
`gops.rfft3 / irfft3 / kmag / mean` instead of the FFT helpers.  `SINGLE`
is the plain single-device behaviour; a `GridOps` holding a mesh of more
than one rank swaps in the slab FFT (parallel/pfft.py) and means summed over
the ranks.  A mesh of one rank is not sharded.  `shape` arguments are
always the global grid shape; the arrays are this rank's slabs (x-slabs in
real space, ky-shards in k-space).  Follows py21cmfast_tpu/ops/gridops.py.
"""

from __future__ import annotations

import dataclasses

import torch

from . import fft, grids


@dataclasses.dataclass(frozen=True)
class GridOps:
    """Dispatcher for the grid-global operations; `mesh` is a
    parallel.mesh.Mesh or None."""

    mesh: object = None

    @property
    def sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def local_shape(self, shape):
        """This rank's real-space slab of a grid of global `shape`."""
        if not self.sharded:
            return tuple(shape)
        x0, x1 = self.mesh.bounds(shape[0])
        return (x1 - x0,) + tuple(shape[1:])

    def rfft3(self, x):
        if self.sharded:
            from ..parallel import pfft

            return pfft.rfft3(self.mesh, x)
        return fft.rfft3(x)

    def irfft3(self, k, shape):
        if self.sharded:
            from ..parallel import pfft

            return pfft.irfft3(self.mesh, k, shape[2])
        return fft.irfft3(k, shape)

    def kmag(self, shape, box_lens, device):
        if self.sharded:
            from ..parallel import pfft

            return pfft.local_kmag(self.mesh, shape, box_lens, device)
        return grids.kmag_grid(shape, box_lens, device)

    def mean(self, x, global_shape):
        """Global mean of a real-space grid, a 0-d tensor of x's dtype."""
        if self.sharded:
            n_tot = global_shape[0] * global_shape[1] * global_shape[2]
            return self.mesh.all_reduce(x.sum()) / n_tot
        return x.mean()

    def means(self, xs, global_shape):
        """The global means of several grids, one host list (one collective
        when sharded)."""
        if self.sharded:
            n_tot = global_shape[0] * global_shape[1] * global_shape[2]
            return (self.mesh.all_reduce(torch.stack([x.sum() for x in xs])) / n_tot).tolist()
        return torch.stack([x.mean() for x in xs]).tolist()


SINGLE = GridOps()


def for_mesh(mesh) -> GridOps:
    """The GridOps of a stage function's `mesh=` argument (SINGLE for None)."""
    if mesh is None:
        return SINGLE
    if not hasattr(mesh, "all_to_all"):
        raise TypeError(f"mesh must be a py21cmfast_torch.parallel.mesh.Mesh, got {type(mesh).__name__}")
    return GridOps(mesh)
