"""Plotting utilities (reference plotting.py:135-522), following
py21cmfast_tpu/plotting.py.  They take the port's Coeval, LightCone and
GlobalEvolution, whose grids are tensors: the plotted slices are copied to
the host.  matplotlib is imported inside the functions: it is optional, and
`import py21cmfast_torch` does not need it."""

from __future__ import annotations

import numpy as np
import torch


def _host(x):
    """A tensor or array as a numpy array on the host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def coeval_sliceplot(coeval, quantity="brightness_temp", slice_index=0, slice_axis=2,
                     ax=None, fig=None, cmap=None, **imshow_kw):
    """Plot a 2D slice of a coeval box (reference coeval_sliceplot:135)."""
    import matplotlib.pyplot as plt

    from .lightconers import RectilinearLightconer

    field = RectilinearLightconer([0.0]).get_field(coeval, quantity)
    index = [slice(None)] * 3
    index[slice_axis] = slice_index
    sl = _host(field[tuple(index)])
    if ax is None:
        fig, ax = plt.subplots()
    if cmap is None:
        cmap = "coolwarm" if quantity == "brightness_temp" else "viridis"
    im = ax.imshow(sl.T, origin="lower", cmap=cmap, **imshow_kw)
    ax.set_xlabel("x [cells]")
    ax.set_ylabel("y [cells]")
    ax.set_title(f"{quantity} @ z={coeval.redshift:.2f}")
    if fig is not None:
        fig.colorbar(im, ax=ax)
    return fig, ax


def lightcone_sliceplot(lightcone, quantity="brightness_temp", slice_index=0,
                        ax=None, fig=None, **imshow_kw):
    """Plot an (LoS, transverse) slice through a lightcone
    (reference lightcone_sliceplot:225)."""
    import matplotlib.pyplot as plt

    sl = _host(lightcone.lightcones[quantity][slice_index, :, :])
    if ax is None:
        fig, ax = plt.subplots(figsize=(12, 3))
    z = lightcone.lc_redshifts
    im = ax.imshow(
        sl, origin="lower", aspect="auto", cmap="coolwarm",
        extent=[z[0], z[-1], 0, sl.shape[0]], **imshow_kw,
    )
    ax.set_xlabel("redshift")
    ax.set_ylabel("y [cells]")
    ax.set_title(quantity)
    if fig is not None:
        fig.colorbar(im, ax=ax)
    return fig, ax


def plot_global_history(lightcone_or_global, quantity="neutral_fraction", ax=None, fig=None):
    """Plot a global history vs redshift (reference plot_global_history:461)."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots()
    obj = lightcone_or_global
    if hasattr(obj, "global_quantities"):
        z = obj.node_redshifts
        y = obj.global_quantities[quantity]
    else:
        z = obj.redshifts
        y = getattr(obj, quantity)
    ax.plot(_host(z), _host(y))
    ax.set_xlabel("redshift")
    ax.set_ylabel(quantity)
    ax.invert_xaxis()
    return fig, ax
