"""The reader of the spin temperature's batched SFRD-table quadrature
(`metrics/ts.sfrd_batched_shells_per_node.py`, the program's counter
`ts.sfrd_batched_shells`), against records of the program's recorder made
here by hand."""

import sys

import pytest

from harness import cells

METRIC = "ts.sfrd_batched_shells_per_node"


def test_the_dawn_cells_list_the_reader():
    for workload, listed in (("latest-dawn", True), ("faithful-dawn", True),
                             ("simple-eor", False)):
        names = {m["name"] for m in cells.resolve(workload).per_layer}
        assert (METRIC in names) is listed, workload


def _runs(per_node):
    """Two cones of three nodes: the first node of each starts the Ts chain
    (no host tables), the others book `per_node` shells under `ts` (None:
    no booking)."""
    def book(n):
        counters = {} if n is None else {"ts.sfrd_batched_shells": {"ts": n}}
        return {"spans": {}, "counters": counters}

    return [{"entry": "generate_lightcone", **book(None),
             "nodes": [{"index": i, "z": 30.0 - i, **book(None if i == 0 else per_node)}
                       for i in range(3)]}
            for _ in range(2)]


@pytest.fixture
def recorder(monkeypatch):
    from py21cmfast_torch import tracing

    def use(per_node):
        runs = _runs(per_node)
        monkeypatch.setattr(tracing, "runs", lambda last=None: runs[-last:] if last else [])
    return use


@pytest.mark.parametrize("per_node", [40, 0])
def test_reader_reads_the_shells_a_node(recorder, per_node):
    """40 shells a Ts step; GAMMA-APPROX books 0, which reads 0, not None."""
    recorder(per_node)
    assert cells.read_metric(METRIC, {"cones": 2, "nodes": 6}) == pytest.approx(per_node * 4 / 6)


@pytest.mark.parametrize("record", [{"cones": 2, "nodes": 7}, {"cones": 1, "nodes": 6},
                                    {"cones": 0, "nodes": 0}])
def test_reader_is_none_when_the_nodes_do_not_add_up(recorder, record):
    recorder(40)
    assert cells.read_metric(METRIC, record) is None


def test_reader_is_none_where_the_program_books_no_counter(recorder):
    """A program from before the batched quadrature books no
    `ts.sfrd_batched_shells`: nothing to read, and the reader does not
    raise."""
    recorder(None)
    assert cells.read_metric(METRIC, {"cones": 2, "nodes": 6}) is None


def test_reader_is_none_without_the_programs_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "py21cmfast_torch.tracing", None)
    assert cells.read_metric(METRIC, {"cones": 1, "nodes": 3}) is None


def test_reader_reads_a_window_cone_on_the_cpu():
    """latest-dawn at its tiny box: a warm-up cone and a window cone through
    the harness's `run_cone`; every node but the first (which starts the Ts
    chain) books the ladder's shells under `ts`."""
    import torch
    from conftest import SEED, TINY

    import py21cmfast_torch as p21
    from harness import loop

    cpu = torch.device("cpu")
    cell = cells.resolve("latest-dawn")
    inputs = cells.build_inputs(p21.InputParameters, cell, SEED, TINY[cell.config_name])
    ics = p21.compute_initial_conditions(inputs, device=cpu)
    for _ in range(2):
        _, nodes, _, _ = loop.run_cone(p21, cell, inputs, ics, cpu)
    shells = inputs.astro_params.N_STEP_TS
    assert cells.read_metric(METRIC, {"cones": 1, "nodes": nodes}) == \
        pytest.approx(shells * (nodes - 1) / nodes)
