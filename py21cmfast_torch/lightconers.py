"""Lightconers: interpolate coeval snapshots onto lightcone slices.

Equivalent of py21cmfast_tpu/lightconers.py (reference lightconers.py:35-700).
A `Lightconer` owns the grid of comoving distances of the lightcone slices;
for each pair of adjacent coevals it emits the slices whose distances fall
between them, linearly interpolated in comoving distance.  The rectilinear
variant maps distance -> periodic LoS pixel; the angular one samples the box
along sightlines.  Distances, redshifts and the slice schedule are host
float64 numpy; the slices are float32 tensors on the coevals' device.
"""

from __future__ import annotations

import numpy as np
import torch

from .inputs import InputParameters
from .ops import cic

__all__ = ["Lightconer", "RectilinearLightconer", "AngularLightconer"]


class Lightconer:
    """Base: holds lc distances + redshifts, provides coeval interpolation."""

    # per-quantity interpolation kind (reference lightconers.py:107-109,
    # 289-318): "mean" = linear in comoving distance; "mean_max" = linear,
    # except where the bracketing values straddle zero take the max (used for
    # z_reion, whose -1 sentinel must not be averaged into real redshifts)
    DEFAULT_INTERP_KINDS = {"z_reion": "mean_max"}

    def __init__(self, lc_distances, quantities=("brightness_temp",),
                 interp_kinds=None):
        self.interp_kinds = dict(self.DEFAULT_INTERP_KINDS)
        if interp_kinds:
            self.interp_kinds.update(interp_kinds)
        self.lc_distances = np.asarray(lc_distances, dtype=np.float64)
        self.quantities = tuple(quantities)
        self._lc_redshifts = None

    @classmethod
    def with_equal_cdist_slices(
        cls,
        min_redshift: float,
        max_redshift: float,
        inputs: InputParameters,
        quantities=("brightness_temp",),
        resolution=None,
    ):
        cosmo = inputs.cosmology
        res = resolution if resolution is not None else (
            inputs.simulation_options.box_len / inputs.simulation_options.HII_DIM
        )
        d_min = cosmo.comoving_distance(min_redshift)
        d_max = cosmo.comoving_distance(max_redshift)
        n = int(np.floor((d_max - d_min) / res)) + 1
        dists = d_min + np.arange(n) * res
        obj = cls(dists, quantities)
        obj._inputs = inputs
        return obj

    def lc_redshifts(self, cosmo):
        if self._lc_redshifts is None:
            z_grid = np.linspace(0.0, 60.0, 4096)
            d_grid = cosmo.comoving_distance(z_grid)
            self._lc_redshifts = np.interp(self.lc_distances, d_grid, z_grid)
        return self._lc_redshifts

    @property
    def n_slices(self):
        return len(self.lc_distances)

    def _selected(self, coeval_low, coeval_high, cosmo):
        """Indices and distances of the slices in [d(z_low), d(z_high)), and
        the two distances; the indices are None where no slice falls there."""
        d_low = cosmo.comoving_distance(coeval_low.redshift)
        d_high = cosmo.comoving_distance(coeval_high.redshift)
        sel = (self.lc_distances >= d_low) & (self.lc_distances < d_high)
        idx = np.where(sel)[0] if np.any(sel) else None
        return idx, d_low, d_high

    def make_lightcone_slices(self, coeval_low, coeval_high, cosmo, inputs, quantity):
        """Return (slice_indices, values) for lc slices between the two coevals.

        coeval_low is at the lower redshift (smaller distance)."""
        raise NotImplementedError

    def get_field(self, coeval, quantity, device=False):
        """The named field of a Coeval: a host numpy array, or with
        `device=True` the tensor on the run's device (slicing and means then
        run there and only the slices move); None where the configuration
        does not fill it."""
        if quantity == "brightness_temp":
            out = coeval.brightness_temperature.brightness_temp
        elif quantity == "tau_21":
            out = coeval.brightness_temperature.tau_21
        elif quantity in ("density", "velocity_z", "velocity_x", "velocity_y"):
            out = getattr(coeval.perturbed_field, quantity)
        elif quantity in ("neutral_fraction", "z_reion", "ionisation_rate_G12",
                          "cumulative_recombinations"):
            out = getattr(coeval.ionized_box, quantity)
        elif quantity in ("spin_temperature", "kinetic_temp_neutral",
                          "xray_ionised_fraction", "J_21_LW"):
            if coeval.spin_temp is None:
                raise ValueError(f"{quantity} requires USE_TS_FLUCT")
            out = getattr(coeval.spin_temp, quantity)
        else:
            raise ValueError(f"unknown lightcone quantity {quantity}")
        if device or out is None:
            return out
        return out.detach().cpu().numpy()


class RectilinearLightconer(Lightconer):
    """Slices taken along the box z-axis, periodic tiling in distance
    (reference RectilinearLightconer:483-540)."""

    def _slice_schedule(self, coeval_low, coeval_high, cosmo, inputs):
        """(idx, pix, w) of the slices between two coevals: the cone's slice
        indices, the box's LoS pixel of each, and the float32 weight of the
        higher-redshift box; None where no slice falls between them."""
        idx, d_low, d_high = self._selected(coeval_low, coeval_high, cosmo)
        if idx is None:
            return None
        dists = self.lc_distances[idx]
        cell = inputs.simulation_options.box_len / inputs.simulation_options.HII_DIM
        n_los = inputs.simulation_options.lowres_shape[2]
        pix = np.round(dists / cell).astype(np.int32) % n_los
        w = ((dists - d_low) / max(d_high - d_low, 1e-30)).astype(np.float32)
        return idx, pix, w

    def make_lightcone_slices(self, coeval_low, coeval_high, cosmo, inputs, quantity):
        """(idx, vals): the cone's slice indices as a tensor and the (N, N,
        len(idx)) interpolated slices, on the coevals' device; (None, None)
        where no slice falls between the two or the field is not filled."""
        sched = self._slice_schedule(coeval_low, coeval_high, cosmo, inputs)
        box_lo = self.get_field(coeval_low, quantity, device=True)
        box_hi = self.get_field(coeval_high, quantity, device=True)
        if sched is None or box_lo is None or box_hi is None:
            return None, None
        idx, pix, w = sched
        dev = box_lo.device
        pix = torch.as_tensor(pix, dtype=torch.int64, device=dev)
        w = torch.as_tensor(w, device=dev)
        lo = box_lo[:, :, pix]
        hi = box_hi[:, :, pix]
        vals = lo * (1 - w) + hi * w
        if self.interp_kinds.get(quantity) == "mean_max":
            vals = torch.where(lo * hi < 0, torch.maximum(lo, hi), vals)
        return torch.as_tensor(idx, device=dev), vals


class AngularLightconer(Lightconer):
    """Lightcone on angular sightlines (reference AngularLightconer:541-700).

    Each sightline is a unit vector from the observer; slices are trilinear
    samples of the periodic coeval box at the slice's comoving distance along
    each ray (the role cosmotile plays for the reference).  Pixelizations are
    user-provided or generated by `like_rectilinear` (a flat-sky bundle
    matching the rectilinear geometry).
    """

    def __init__(self, lc_distances, sightline_vectors, origin=(0.0, 0.0, 0.0),
                 quantities=("brightness_temp",)):
        super().__init__(lc_distances, quantities)
        self.sightlines = np.asarray(sightline_vectors, dtype=np.float64)  # (npix, 3)
        self.sightlines /= np.linalg.norm(self.sightlines, axis=-1, keepdims=True)
        self.origin = np.asarray(origin, dtype=np.float64)

    @classmethod
    def like_rectilinear(cls, min_redshift, max_redshift, inputs, quantities=("brightness_temp",),
                         opening_angle_deg: float | None = None):
        """Sightline bundle subtending the box's transverse extent at the
        central lightcone distance (reference like_rectilinear:579)."""
        base = Lightconer.with_equal_cdist_slices(
            min_redshift, max_redshift, inputs, quantities
        )
        n = inputs.simulation_options.HII_DIM
        L = inputs.simulation_options.box_len
        d_mid = 0.5 * (base.lc_distances[0] + base.lc_distances[-1])
        half = (
            np.deg2rad(opening_angle_deg) / 2
            if opening_angle_deg is not None
            else np.arctan(L / 2 / d_mid)
        )
        ang = np.linspace(-half, half, n)
        tx, ty = np.meshgrid(ang, ang, indexing="ij")
        vecs = np.stack([np.tan(tx), np.tan(ty), np.ones_like(tx)], axis=-1).reshape(-1, 3)
        obj = cls(base.lc_distances, vecs, quantities=quantities)
        obj.shape2d = (n, n)
        return obj

    def make_lightcone_slices(self, coeval_low, coeval_high, cosmo, inputs, quantity):
        """(idx, vals): the cone's slice indices as a tensor and the (npix,
        len(idx)) float32 samples, on the coevals' device."""
        idx, d_low, d_high = self._selected(coeval_low, coeval_high, cosmo)
        box_lo = self.get_field(coeval_low, quantity, device=True)
        box_hi = self.get_field(coeval_high, quantity, device=True)
        if idx is None or box_lo is None or box_hi is None:
            return None, None
        dists = self.lc_distances[idx]
        cell = inputs.simulation_options.box_len / inputs.simulation_options.HII_DIM
        dev = box_lo.device

        # positions along every sightline at each selected distance, in cell
        # units, float32 as the box reads them: (n_slice, npix, 3)
        pos = (
            self.origin[None, None, :]
            + dists[:, None, None] * self.sightlines[None, :, :]
        ) / cell
        px, py, pz = (torch.as_tensor(pos[..., a].astype(np.float32), device=dev) for a in range(3))
        v_lo = cic.cic_read(box_lo, px, py, pz).double()
        v_hi = cic.cic_read(box_hi, px, py, pz).double()
        w = torch.as_tensor((dists - d_low) / max(d_high - d_low, 1e-30), device=dev)
        vals = v_lo * (1 - w)[:, None] + v_hi * w[:, None]  # (n_slice, npix), float64
        return torch.as_tensor(idx, device=dev), vals.T.float()
