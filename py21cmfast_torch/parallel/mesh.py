"""The process mesh of a multi-GPU run, and every collective the port uses.

The boxes are split into x-slabs over the ranks of one process group: rank r
holds rows slab_bounds(nx, p)[r] of every real-space grid, and after the
slab FFT's transpose (parallel/pfft.py) the ky rows r*ny/p ... (r+1)*ny/p of
every k-space half-box.  This is the SPMD counterpart of the JAX package's
`shard_map` over a 1D `Mesh`: every rank runs the same driver on its own
slab, and the few places where the ranks meet are the methods of `Mesh`.

Backends: NCCL on `cuda:LOCAL_RANK` by default; gloo only when the caller
asks for it (the CPU tests, and two ranks sharing one card).  Under gloo a
CUDA tensor is copied to the host for the collective and back by the
collective itself (the recorder's counter `mesh.host_bytes` counts those
bytes, beside `mesh.calls`, `mesh.bytes` and the span `mesh.collective`:
`tracing.totals()`, since the sharded drivers run outside any run).  Complex
tensors travel as their `torch.view_as_real` float32 views.  No collective
falls back to anything: a failed initialization or a collective error
raises.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from .._device import to_device

__all__ = ["Mesh", "make_mesh", "slab_bounds", "gather_slabs"]


def slab_bounds(nx: int, n_slabs: int):
    """[(x0, x1)] of each slab: nx rows over n_slabs, the first nx % n_slabs
    slabs one row wider."""
    base, rem = divmod(nx, n_slabs)
    bounds, x0 = [], 0
    for s in range(n_slabs):
        w = base + (1 if s < rem else 0)
        bounds.append((x0, x0 + w))
        x0 += w
    return bounds


class Mesh:
    """One process group seen from one rank: the group, this rank, the world
    size, this rank's device and the backend, with the collectives."""

    def __init__(self, group, rank: int, size: int, device: torch.device, backend: str):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        # with `timed` the card is synchronised around each collective, so
        # that the span `mesh.collective` holds its wall seconds
        self.timed = False

    def __repr__(self):
        return f"Mesh(rank={self.rank}, size={self.size}, device={self.device}, backend={self.backend})"

    # -- slabs -------------------------------------------------------------

    def bounds(self, nx: int):
        return slab_bounds(nx, self.size)[self.rank]

    def local_slab(self, x):
        """This rank's x-slab of a global array (numpy or tensor), as a
        float32 tensor on the mesh's device when given numpy."""
        x0, x1 = self.bounds(x.shape[0])
        if isinstance(x, np.ndarray):
            return to_device(np.ascontiguousarray(x[x0:x1]), self.device)
        return x[x0:x1].contiguous()

    # -- plumbing ----------------------------------------------------------

    @contextmanager
    def _collective(self, nbytes: int):
        tracing.count("mesh.calls")
        tracing.count("mesh.bytes", int(nbytes))
        sync = self.timed and self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        with tracing.span("mesh.collective"):
            yield
            if sync:
                torch.cuda.synchronize(self.device)

    def _wire(self, t):
        """The tensor the backend takes: real, contiguous, and on the host
        under gloo."""
        if t.is_complex():
            t = torch.view_as_real(t)
        t = t.contiguous()
        if self.backend == "gloo" and t.device.type == "cuda":
            tracing.count("mesh.host_bytes", t.numel() * t.element_size())
            t = t.cpu()
        return t

    def _unwire(self, t, like):
        """Back to the device and dtype of `like`."""
        if t.device != like.device:
            tracing.count("mesh.host_bytes", t.numel() * t.element_size())
            t = t.to(like.device)
        if like.is_complex():
            t = torch.view_as_complex(t.contiguous())
        return t

    # -- collectives -------------------------------------------------------

    def all_to_all(self, x, split_axis: int, concat_axis: int):
        """The tiled all-to-all of `jax.lax.all_to_all`: `split_axis` is cut
        into `size` equal chunks, chunk j goes to rank j, and the chunks
        received are concatenated along `concat_axis` in rank order.
        `all_to_all_single` exchanges along dim 0 only, so the split axis is
        moved to the front, exchanged, moved back, and the rank axis merged
        into the concat axis."""
        p = self.size
        n = x.shape[split_axis]
        if n % p:
            raise ValueError(f"all_to_all: axis {split_axis} of length {n} is not divisible by {p}")
        xs = x.movedim(split_axis, 0)
        send = xs.reshape((p, n // p) + tuple(xs.shape[1:]))
        wire = self._wire(send)
        recv = torch.empty_like(wire)
        with self._collective(wire.numel() * wire.element_size()):
            dist.all_to_all_single(recv, wire, group=self.group)
        recv = self._unwire(recv, send)
        # recv[i]: rank i's chunk, its split axis in front; put it back, then
        # merge the rank axis into the concat axis, rank-major
        y = recv.movedim(1, split_axis + 1).movedim(0, concat_axis)
        shape = list(y.shape)
        shape[concat_axis:concat_axis + 2] = [shape[concat_axis] * shape[concat_axis + 1]]
        return y.reshape(shape)

    def exchange(self, to_left, to_right):
        """Each rank sends `to_left` to its left neighbour (rank - 1) and
        `to_right` to its right one (rank + 1), periodically, and returns
        (from_right, from_left): what its right neighbour sent left and its
        left neighbour sent right.  One all-to-all with a split a peer, so
        that with two ranks, whose left and right neighbours are one rank,
        the two parts stay apart (the left-going part first); with one rank
        the parts come back to it, as `ppermute` to self does."""
        p = self.size
        if p == 1:
            return to_left, to_right
        left, right = (self.rank - 1) % p, (self.rank + 1) % p
        a, b = self._wire(to_left).reshape(-1), self._wire(to_right).reshape(-1)
        n = a.numel()
        if b.numel() != n:
            raise ValueError("exchange: the two parts must have one size")
        send_parts, in_split, out_split = [], [0] * p, [0] * p
        for d in range(p):
            if d == left:
                send_parts.append(a)
                in_split[d] += n
            if d == right:
                send_parts.append(b)
                in_split[d] += n
            # from source d: its left-going part if I am its left neighbour
            # (d is my right), then its right-going part if d is my left
            out_split[d] = n * ((d == right) + (d == left))
        send = torch.cat(send_parts)
        recv = torch.empty(sum(out_split), dtype=send.dtype, device=send.device)
        with self._collective(send.numel() * send.element_size()):
            dist.all_to_all_single(recv, send, out_split, in_split, group=self.group)
        offs = np.concatenate([[0], np.cumsum(out_split)])
        from_right = recv[offs[right]:offs[right] + n]
        from_left = recv[offs[left + 1] - n:offs[left + 1]]
        return (self._unwire(from_right, to_left).reshape(to_left.shape),
                self._unwire(from_left, to_right).reshape(to_right.shape))

    def all_reduce(self, x, op: str = "sum"):
        """A new tensor: the sum or max of `x` over the ranks."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        wire = self._wire(x).clone()
        with self._collective(wire.numel() * wire.element_size()):
            dist.all_reduce(wire, op=red, group=self.group)
        return self._unwire(wire, x)

    def all_reduce_floats(self, values, op: str = "sum"):
        """The sums (or maxima) over the ranks of a list of Python floats,
        in float64."""
        t = to_device(np.asarray(values, np.float64), self.device)
        return self.all_reduce(t, op).cpu().tolist()

    def all_gather(self, x):
        """The ranks' equal-shape tensors concatenated along dim 0 in rank order."""
        wire = self._wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        with self._collective(wire.numel() * wire.element_size() * self.size):
            dist.all_gather(parts, wire, group=self.group)
        return self._unwire(torch.cat(parts), x)

    def all_gather_rows(self, x):
        """The ranks' tensors of any number of rows (same trailing shape)
        concatenated along dim 0 in rank order: the counts first, then the
        rows padded to the longest."""
        counts = self.all_gather(
            to_device([x.shape[0]], self.device, torch.int64)).cpu().tolist()
        n_max = max(counts)
        pad = torch.zeros((n_max,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        pad[:x.shape[0]] = x
        rows = self.all_gather(pad).reshape((self.size, n_max) + tuple(x.shape[1:]))
        return torch.cat([rows[r, :c] for r, c in enumerate(counts)])

    def barrier(self):
        wire = self._wire(torch.zeros(1, device=self.device))
        with self._collective(0):
            dist.all_reduce(wire, group=self.group)


def gather_slabs(mesh: Mesh, x):
    """The whole box from each rank's x-slab (every rank gets it): the
    counterpart of `np.asarray` on a sharded `jax.Array`."""
    if mesh.size == 1:
        return x
    return mesh.all_gather_rows(x)


def _resolve_device(device, backend):
    from . import multihost

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: device='cuda' was requested but no CUDA device is "
                               "available; pass device='cpu' and backend='gloo'")
        if dev.index is None:
            dev = torch.device("cuda", multihost.local_device_index())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"make_mesh: {dev} asked for, {torch.cuda.device_count()} "
                               "CUDA device(s) present")
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    return dev


def make_mesh(n_devices: int | None = None, *, backend: str | None = None,
              device="cuda") -> Mesh:
    """The mesh over every rank of the default process group (initialized
    from torchrun's environment by `multihost.initialize` when it is not
    yet).  `backend` defaults to NCCL on `cuda:LOCAL_RANK`, and to gloo for
    `device="cpu"`; a backend other than the default group's gets a group of
    its own.  Raises when `n_devices` is given and the world has fewer (or
    more) ranks: in SPMD a mesh spans every rank."""
    from . import multihost

    if backend is None:
        backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}: use 'nccl' or 'gloo'")
    if not dist.is_initialized():
        multihost.initialize(backend=backend)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise RuntimeError(
            f"make_mesh: requested {n_devices} ranks but the process group has {world}; "
            "launch one process a rank (torchrun --nproc_per_node=N) and call "
            "multihost.initialize() first")
    dev = _resolve_device(device, backend)
    group = None if dist.get_backend() == backend else dist.new_group(backend=backend)
    return Mesh(group, dist.get_rank(), world, dev, backend)

