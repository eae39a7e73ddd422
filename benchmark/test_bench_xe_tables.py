"""The reader of the spin temperature's <x_e>-bound host tables
(`metrics/ts.xe_tables_s_per_node.py`, the program's span `ts.xe_tables`),
on the CPU at the tiny dawn box: a warm-up cone and one window cone through
the harness's `run_cone`, then the reader against a record of that cone."""

import math

import pytest
import torch
from conftest import SEED, TINY

from harness import cells, loop

CPU = torch.device("cpu")
METRIC = "ts.xe_tables_s_per_node"


@pytest.fixture(scope="module")
def dawn_window():
    """latest-dawn's warm-up cone and one window cone: nodes a cone."""
    import py21cmfast_torch as p21

    cell = cells.resolve("latest-dawn")
    inputs = cells.build_inputs(p21.InputParameters, cell, SEED, TINY[cell.config_name])
    ics = p21.compute_initial_conditions(inputs, device=CPU)
    for _ in range(2):
        _, nodes, _, _ = loop.run_cone(p21, cell, inputs, ics, CPU)
    assert nodes == len(inputs.node_redshifts)
    return nodes


def test_only_the_dawn_cell_lists_the_reader():
    for workload, listed in (("latest-dawn", True), ("simple-eor", False)):
        names = {m["name"] for m in cells.resolve(workload).per_layer}
        assert (METRIC in names) is listed, workload


def test_reader_reads_the_window_cone_inside_the_host_tables(dawn_window):
    record = {"cones": 1, "nodes": dawn_window}
    value = cells.read_metric(METRIC, record)
    host = cells.read_metric("ts.host_s_per_node", record)
    assert value is not None and math.isfinite(value) and value > 0, value
    assert value <= host


@pytest.mark.parametrize("extra_cones,extra_nodes", [(0, 1), (1, 0), (-1, None)])
def test_reader_is_none_when_the_nodes_do_not_add_up(dawn_window, extra_cones, extra_nodes):
    record = {"cones": 1 + extra_cones,
              "nodes": 0 if extra_nodes is None else dawn_window + extra_nodes}
    assert cells.read_metric(METRIC, record) is None, record


def test_reader_is_none_for_a_program_without_the_span(dawn_window, monkeypatch):
    """A program whose recorder books no `ts.xe_tables` (one from before the
    span) gives nothing to read, and the reader does not raise."""
    from py21cmfast_torch import tracing

    runs = tracing.runs

    def without_span(last=None):
        kept = runs(last=last)
        for run in kept:
            for book in [run] + run["nodes"]:
                book["spans"].pop("ts.xe_tables", None)
        return kept

    monkeypatch.setattr(tracing, "runs", without_span)
    assert cells.read_metric(METRIC, {"cones": 1, "nodes": dawn_window}) is None
