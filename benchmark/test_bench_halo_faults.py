"""A golden `latest-discrete` run with the halo path broken underneath reads
`correct` false: the harness's whole run on the CPU (`test_bench_halos.py`'s
golden cell), with one fault planted in the program each time.

The faults of the halo path: an answer altered where it is produced (the
HaloBox's SFR), part of the work left out (one XraySourceBox shell), and
the catalogs, which the reference takes as the cone's input, altered (the
masses, a share of the halos, a property draw).  The first two the
comparison of the cone catches, the last three the catalog gate.
"""

import dataclasses
import importlib

import pytest
import torch
from conftest import SEED
from test_bench_halos import GATE, run_golden


def _scaled(field, factor):
    def make(fn):
        def altered(*a, **kw):
            out = fn(*a, **kw)
            return dataclasses.replace(out, **{field: getattr(out, field) * factor})
        return altered
    return make


def _shell_dropped(fn):
    def dropped(*a, **kw):
        box = fn(*a, **kw)
        keep = torch.ones(box.filtered_sfr.shape[0], dtype=box.filtered_sfr.dtype,
                          device=box.filtered_sfr.device)
        keep[0] = 0.0
        view = (-1,) + (1,) * (box.filtered_sfr.dim() - 1)
        return dataclasses.replace(box, filtered_sfr=box.filtered_sfr * keep.view(view),
                                   filtered_xray=box.filtered_xray * keep.view(view))
    return dropped


def _halos_dropped(fn):
    """Every 33rd halo of each catalog left out: 3% of them."""
    def dropped(*a, **kw):
        cat = fn(*a, **kw)
        keep = torch.arange(cat.n_halos, device=cat.halo_masses.device) % 33 != 0
        return dataclasses.replace(
            cat, halo_masses=cat.halo_masses[keep], halo_coords=cat.halo_coords[keep],
            star_rng=cat.star_rng[keep], sfr_rng=cat.sfr_rng[keep], xray_rng=cat.xray_rng[keep],
            n_halos=int(keep.sum()))
    return dropped


HALOS = "py21cmfast_torch.models.halos"
FAULTS = {
    "halobox_sfr_up_5pct": ("py21cmfast_torch.models.halobox", "compute_halo_grid",
                            _scaled("halo_sfr", 1.05)),
    "source_shell_dropped": ("py21cmfast_torch.models.xray_source", "compute_xray_source_field",
                             _shell_dropped),
    "catalog_masses_up_10pct": (HALOS, "determine_halo_catalog", _scaled("halo_masses", 1.1)),
    "three_pct_of_halos_dropped": (HALOS, "determine_halo_catalog", _halos_dropped),
    "sfr_rng_up_30pct": (HALOS, "determine_halo_catalog", _scaled("sfr_rng", 1.3)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_halo_path_reads_incorrect(fault, monkeypatch):
    path, attr, make = FAULTS[fault]
    owner = importlib.import_module(path)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    result, lines, _ = run_golden(SEED)
    assert result["correct"] is False, lines
    failed = {k for k, c in result["checks"].items() if not c["value"] <= c["limit"]}
    assert failed, lines
    # the catalogs' faults are the gate's to catch, the others the cone's
    assert bool(failed & GATE) == (attr == "determine_halo_catalog"), failed
