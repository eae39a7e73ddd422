"""The faithful cell, `faithful-dawn` (latest's physics at DIM = 4 HII_DIM
with MINIMIZE_MEMORY), on the CPU: the harness's whole run at a tiny box
against the reference, the four readers of the cell, and the truncated
2LPT source that its 1024^3 ICs take, against the reference's."""

import math
import time

import pytest
import torch
from conftest import SEED

from harness import card, cells, compare, loop, reference

CPU = torch.device("cpu")
WORKLOAD = "faithful-dawn"
# ratio 4 with MINIMIZE_MEMORY, as the cell runs, at latest's tiny box
TINY = dict(HII_DIM=34, DIM=136, BOX_LEN=51.0, ZPRIME_STEP_FACTOR=1.2)
READERS = ("ics.sample_s", "ics.2lpt_s", "ics.peak_gib", "deposit.r4_roofline_pct")
# the truncated 2LPT terms, program against reference: float32 FFTs on both
# sides and the program's coarser P(k) table (2048 points against 65537)
# read ~1.6e-6; the reference's fields in bfloat16 read ~1.7e-3, and a
# program that truncates where the reference does not ~0.1
TOL_2LPT = 1e-4


@pytest.fixture(scope="module")
def traced_run():
    """One traced run of the cell at the tiny box, from an empty recorder."""
    from py21cmfast_torch import tracing

    tracing.reset()
    cell = cells.resolve(WORKLOAD)
    result, _ = loop.run(cell, SEED, 0.0, True, CPU, time.perf_counter(), overrides=TINY)
    return cell, result


def test_the_cell_is_latest_at_ratio_4_with_minimize_memory():
    cell = cells.resolve(WORKLOAD)
    latest = cells.resolve("latest-dawn")
    assert cell.traffic == latest.traffic and cell.chips == 1
    params, base = dict(cell.config["params"]), dict(latest.config["params"])
    assert (params.pop("DIM"), params.pop("MINIMIZE_MEMORY")) == (4 * params["HII_DIM"], True)
    assert (base.pop("DIM"), base.pop("MINIMIZE_MEMORY")) == (3 * base["HII_DIM"], False)
    assert params == base
    assert set(READERS) <= {m["name"] for m in cell.per_layer}


def test_the_tiny_cell_agrees_with_the_reference(traced_run):
    cell, result = traced_run
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["checks"]) == {"ics", "Tb", "density", "Ts", "x_e", "xH", "tau21", "v_z"}
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
    assert result["correct"] is True


def test_readers_read_the_traced_run(traced_run):
    """The ICs' spans are read from the run's one ICs call; the peak counter
    and the deposit's window need the card."""
    cell, result = traced_run
    got = set(result["metrics"])
    assert {"ics.sample_s", "ics.2lpt_s"} <= got <= {m["name"] for m in cell.per_layer}
    assert not got & {"ics.peak_gib", "deposit.r4_roofline_pct"}
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert result["metrics"]["ics.sample_s"]["value"] < result["info"]["ics_s"]


def test_r4_roofline_share_of_the_faithful_shapes():
    bound = card.deposit_bound_s(1024, 256)
    assert card.deposit_bytes(1024, 256) == 4 * 1024**3 + 16 * 256**3
    assert math.isclose(bound, 1.3622e-3, rel_tol=1e-4)
    record = {"deposit_bound_s": bound, "window": {"deposit_s_per_call": 7.0e-3}}
    assert math.isclose(cells.read_metric("deposit.r4_roofline_pct", record),
                        100 * bound / 7.0e-3)


@pytest.fixture
def two_ics_calls():
    """The recorder holding only two ICs calls' spans and peaks, 3 and 5
    GiB; emptied again afterwards."""
    from py21cmfast_torch import tracing

    tracing.reset()
    for peak in (3, 5):
        with tracing.span("ics"):
            for stage in ("ics.sample", "ics.2lpt"):
                with tracing.span(stage):
                    pass
            tracing.count("ics.peak_bytes", peak * 2**30)
    yield
    tracing.reset()


def test_peak_reader_is_the_counter_over_the_ics_calls(two_ics_calls):
    assert cells.read_metric("ics.peak_gib", {"ics_s": 1.0}) == 4.0


@pytest.mark.parametrize("metric", READERS)
def test_reader_is_none_on_an_empty_record(two_ics_calls, metric):
    assert cells.read_metric(metric, {}) is None


@pytest.mark.parametrize("metric", READERS[:3])
def test_ics_readers_are_none_without_the_programs_recorder(two_ics_calls, monkeypatch,
                                                            metric):
    """A program without `py21cmfast_torch.tracing` gives nothing to read."""
    import sys

    import py21cmfast_torch

    assert cells.read_metric(metric, {"ics_s": 1.0}) is not None
    monkeypatch.delattr(py21cmfast_torch, "tracing")
    monkeypatch.setitem(sys.modules, "py21cmfast_torch.tracing", None)
    assert cells.read_metric(metric, {"ics_s": 1.0}) is None


def test_truncated_2lpt_agrees_with_the_reference(monkeypatch):
    """The branch a 1024^3 grid takes, at a small size: the 2LPT source formed
    from the modes of a grid half as fine as the hires one (64^3 -> 32^3,
    over a 16^3 lowres grid), in the program and in the reference."""
    import py21cmfast_torch as p21
    from py21cmfast_torch.models import ics as ics_module
    from ref21cm import plain

    monkeypatch.setattr(ics_module, "_2LPT_MAX_INHBM_CELLS", 64**3)
    monkeypatch.setattr(ics_module, "_2LPT_TRUNC_DIM", 32)
    monkeypatch.setattr(plain, "TRUNC_MIN_CELLS", 64**3)
    monkeypatch.setattr(plain, "TRUNC_DIM", 32)
    truncated = []
    trunc = ics_module._truncate_dk

    def spy(d_k, **kw):
        truncated.append(kw["trunc_shape"])
        return trunc(d_k, **kw)

    monkeypatch.setattr(ics_module, "_truncate_dk", spy)
    cell = cells.resolve(WORKLOAD)
    small = dict(HII_DIM=16, DIM=64, BOX_LEN=51.0)
    prog = p21.compute_initial_conditions(
        cells.build_inputs(p21.InputParameters, cell, SEED, small), device=CPU)
    assert truncated == [(32, 32, 32)]
    ref = reference.initial_conditions(cell, SEED, CPU, small)
    for name in ("vx_2LPT", "vy_2LPT", "vz_2LPT"):
        assert compare.rel_l2(getattr(prog, name), getattr(ref, name)) < TOL_2LPT, name
    assert compare.ics_reading(prog, ref) < TOL_2LPT
