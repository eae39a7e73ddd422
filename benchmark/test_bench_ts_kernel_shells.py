"""The reader of the spin temperature's fused shell kernels
(`metrics/ts.kernel_shells_per_node.py`, the program's counter
`ts.kernel_shells`), against records of the program's recorder: the
kernels run only on the card, so the books are made here by hand."""

import sys

import pytest

from harness import cells

METRIC = "ts.kernel_shells_per_node"


def test_the_dawn_cells_list_the_reader():
    for workload, listed in (("latest-dawn", True), ("faithful-dawn", True),
                             ("simple-eor", False)):
        names = {m["name"] for m in cells.resolve(workload).per_layer}
        assert (METRIC in names) is listed, workload


def _runs(per_node):
    """Two cones of three nodes: the first node of each starts the Ts chain
    (no shell scan), the others book `per_node` shells under `ts` (None:
    no booking)."""
    def book(n):
        counters = {} if n is None else {"ts.kernel_shells": {"ts": n}}
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


def test_reader_reads_the_shells_a_node(recorder):
    recorder(40)
    assert cells.read_metric(METRIC, {"cones": 2, "nodes": 6}) == pytest.approx(40 * 4 / 6)


@pytest.mark.parametrize("record", [{"cones": 2, "nodes": 7}, {"cones": 1, "nodes": 6},
                                    {"cones": 0, "nodes": 0}])
def test_reader_is_none_when_the_nodes_do_not_add_up(recorder, record):
    recorder(40)
    assert cells.read_metric(METRIC, record) is None


def test_reader_is_none_where_the_kernels_never_ran(recorder):
    """The torch path (and a program from before the kernels) books no
    `ts.kernel_shells`: nothing to read, and the reader does not raise."""
    recorder(None)
    assert cells.read_metric(METRIC, {"cones": 2, "nodes": 6}) is None


def test_reader_is_none_without_the_programs_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "py21cmfast_torch.tracing", None)
    assert cells.read_metric(METRIC, {"cones": 1, "nodes": 3}) is None
