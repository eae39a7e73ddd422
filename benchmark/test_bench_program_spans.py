"""The readers of the program's own spans and counters (metrics/ that read
`py21cmfast_torch.tracing.runs()`), on the CPU at tiny boxes: a warm-up cone
and one window cone through the harness's `run_cone`, then each reader of the
cell against a record of one cone and its nodes."""

import math
import sys
import time

import pytest
import torch
from conftest import SEED, TINY

from harness import cells, loop

CPU = torch.device("cpu")
# the readers of the program's recorder, by the cells they report in
PROGRAM = {
    "latest-dawn": ("ts.host_s_per_node", "ts.prefetch_wait_s_per_node",
                    "ts.prefetch_overlap_pct", "ts.scan_s_per_node", "ts.uploads_per_node",
                    "ionize.radii_per_node", "scroll.validate_ms_per_node",
                    "lc.schedule_ms_per_cone"),
    "simple-eor": ("ionize.host_s_per_node", "ionize.uploads_per_node",
                   "ionize.radii_per_node", "scroll.validate_ms_per_node",
                   "lc.schedule_ms_per_cone"),
}
CASES = [(w, m) for w, ms in PROGRAM.items() for m in ms]


@pytest.fixture(scope="module")
def window(request):
    """A cell's warm-up cone and one window cone: (cell, nodes a cone)."""
    import py21cmfast_torch as p21

    cell = cells.resolve(request.param)
    inputs = cells.build_inputs(p21.InputParameters, cell, SEED, TINY[cell.config_name])
    ics = p21.compute_initial_conditions(inputs, device=CPU)
    for _ in range(2):
        _, nodes, _, _ = loop.run_cone(p21, cell, inputs, ics, CPU)
    assert nodes == len(inputs.node_redshifts)
    return cell, nodes


def test_the_cells_list_exactly_these_readers():
    readers = {m for ms in PROGRAM.values() for m in ms}
    for workload, names in PROGRAM.items():
        listed = {m["name"] for m in cells.resolve(workload).per_layer}
        assert listed & readers == set(names)


@pytest.mark.parametrize("window,metric", CASES, indirect=["window"])
def test_reader_reads_the_window_cone(window, metric):
    cell, nodes = window
    value = cells.read_metric(metric, {"cones": 1, "nodes": nodes})
    assert value is not None and math.isfinite(value), (metric, value)
    assert value >= 0
    if metric == "ionize.radii_per_node" and cell.name == "latest-dawn":
        assert value == 0  # the ladder is skipped above z = 22
    if metric.endswith("_pct"):
        assert value <= 100


@pytest.mark.parametrize("window,metric", CASES, indirect=["window"])
def test_reader_is_none_when_the_nodes_do_not_add_up(window, metric):
    _, nodes = window
    for record in ({"cones": 1, "nodes": nodes + 1}, {"cones": 2, "nodes": nodes},
                   {"cones": 0, "nodes": 0}):
        assert cells.read_metric(metric, record) is None, record


@pytest.mark.parametrize("metric", sorted({m for ms in PROGRAM.values() for m in ms}))
def test_reader_is_none_without_the_programs_recorder(monkeypatch, metric):
    """A program without `py21cmfast_torch.tracing` gives nothing to read."""
    monkeypatch.setitem(sys.modules, "py21cmfast_torch.tracing", None)
    assert cells.read_metric(metric, {"cones": 1, "nodes": 3}) is None


def test_traced_run_reads_the_program_spans_beside_the_harness_spans():
    cell = cells.resolve("simple-eor")
    result, _ = loop.run(cell, SEED, 0.0, True, CPU, time.perf_counter(),
                         overrides=TINY[cell.config_name])
    assert result["correct"] is True
    # the device's metrics need the card; Ts does not run in this cell
    assert set(result["metrics"]) == {
        "ics.s", "perturb.ms_per_node", "ionize.s_per_node", "scroll.self_ms_per_node",
        "scroll.host_syncs_per_node", "lc.ms_per_cone", *PROGRAM["simple-eor"]}
    assert result["metrics"]["ionize.radii_per_node"]["value"] > 0
