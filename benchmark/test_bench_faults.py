"""A run with the timed path broken underneath reads `correct` false: the
harness's whole run on the CPU at tiny boxes, past its look for a card, with
one fault planted in the program each time.

The faults a lightcone cell can have: a step that returns its state
unchanged (the spin temperature's, the ionization's), an answer altered
where it is produced (the perturbed density), and half of the work left out
(the slices of every other node never written into the cone).  The
exchange between chips does not exist on one card, and there is no batch
whose mean could be taken over half of it.
"""

import time

import pytest
import torch
from conftest import SEED, TINY

from harness import cells, loop

CPU = torch.device("cpu")


def _stale(module, attr):
    """From its second call on, the entry returns its first output."""
    fn = getattr(module, attr)
    first = []

    def stale(*a, **kw):
        out = fn(*a, **kw)
        if not first:
            first.append(out)
        return first[0]
    return stale


def _altered_density(module, attr):
    fn = getattr(module, attr)

    def altered(*a, **kw):
        import dataclasses

        pf = fn(*a, **kw)
        return dataclasses.replace(pf, density=pf.density * 1.01)
    return altered


def _half_the_slices(owner, attr):
    fn = getattr(owner, attr)
    calls = [0]

    def half(self, *a, **kw):
        calls[0] += 1
        return (None, None) if calls[0] % 2 else fn(self, *a, **kw)
    return half


FAULTS = {
    "ts_state_unchanged": ("py21cmfast_torch.models.spintemp", "compute_spin_temperature",
                           _stale, ["latest-dawn"]),
    "ionized_state_unchanged": ("py21cmfast_torch.models.ionization",
                                "compute_ionization_field", _stale,
                                ["latest-dawn", "simple-eor"]),
    "density_altered": ("py21cmfast_torch.models.perturb", "perturb_field", _altered_density,
                        ["latest-dawn", "simple-eor"]),
    "half_the_slices": ("py21cmfast_torch.lightconers:RectilinearLightconer",
                        "make_lightcone_slices", _half_the_slices,
                        ["latest-dawn", "simple-eor"]),
}
CASES = [(f, w) for f, (_, _, _, ws) in FAULTS.items() for w in ws]


@pytest.mark.parametrize("fault,workload", CASES)
def test_a_broken_timed_path_reads_incorrect(fault, workload, monkeypatch):
    import importlib

    path, attr, make, _ = FAULTS[fault]
    module, _, cls = path.partition(":")
    owner = importlib.import_module(module)
    owner = getattr(owner, cls) if cls else owner
    monkeypatch.setattr(owner, attr, make(owner, attr))
    cell = cells.resolve(workload)
    result, lines = loop.run(cell, SEED, 0.0, False, CPU, time.perf_counter(),
                             overrides=TINY[cell.config_name])
    assert result["correct"] is False, lines
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
