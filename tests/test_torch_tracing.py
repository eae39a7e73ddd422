"""The port's recorder (py21cmfast_torch/tracing.py) on the CPU, at 8^3.

One lightcone with the spin temperature (E-INTEGRAL, so the SFRD tables are
prefetched) from z=36 to z=9: the ionization ladder is skipped at its two
highest nodes (HII_ROUND_ERR) and runs below.  The recorder must hold one
run for it, a node per node redshift, every span with its parent, the
ladder's length where it ran and 0 where it was skipped, and the Ts step's
uploads as its shells' tables count them.  Under a CPU profiler every span
is a `cpu_op` event inside its parent's range; with none running, no
profiler range is opened.  No JAX.
"""

import _torch_threads  # noqa: F401
import json
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import py21cmfast_torch as t21
from py21cmfast_torch import tracing
from py21cmfast_torch.models import ionization as tion
from py21cmfast_torch.models import spintemp as tsp

# (span, parent): what drivers/coeval.py, drivers/lightcone.py, lightconers.py,
# models/spintemp.py and models/ionization.py book on the main thread
PARENTS = {
    "node": None, "perturb": "node", "ts": "node", "ionize": "node", "tb": "node",
    "scroll.validate": "node", "ts.host_tables": "ts", "ts.sfrd_wait": "ts.host_tables",
    "ts.xe_tables": "ts.host_tables",
    "ts.upload": "ts", "ts.scan": "ts", "ionize.host_tables": "ionize", "lc.slices": None,
    "lc.schedule": "lc.slices", "lc.finalize": None,
}


# what models/ics.py books for a 2LPT run, by parent
ICS_PARENTS = {"ics": None, "ics.sample": "ics", "ics.lowres": "ics", "ics.2lpt": "ics"}


def _inputs(z_min=9.0):
    return t21.InputParameters(random_seed=3).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL", ZPRIME_STEP_FACTOR=1.3,
        Z_HEAT_MAX=30.0, N_STEP_TS=6, USE_TS_FLUCT=True,
    ).with_logspaced_redshifts(z_min, 30.0)


@pytest.fixture(scope="module")
def cone():
    """One lightcone on the CPU with what its steps handed the recorder: the
    radius ladder's length at each ionization step that built one, and each
    full Ts step's host tables and shells."""
    inputs = _inputs()
    seen = {"ladder": {}, "ts": {}}
    ionize, setup_radii = tion.compute_ionization_field, tion.setup_radii
    host_tables, shells_from = tsp.ts_host_tables, tsp.shells_from_tables
    state = {}

    def rec_ionize(z, *a, **kw):
        state["z"] = float(z)
        return ionize(z, *a, **kw)

    def rec_radii(*a, **kw):
        ladder = setup_radii(*a, **kw)
        seen["ladder"][state["z"]] = ladder.n
        return ladder

    def rec_tables(z, *a, **kw):
        h = host_tables(z, *a, **kw)
        seen["ts"][float(z)] = {"h": h}
        state["ts_z"] = float(z)
        return h

    def rec_shells(h, device):
        shells = shells_from(h, device)
        seen["ts"][state["ts_z"]]["shells"] = shells
        return shells

    before = len(tracing.runs())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tion, "compute_ionization_field", rec_ionize)
        mp.setattr(tion, "setup_radii", rec_radii)
        mp.setattr(tsp, "ts_host_tables", rec_tables)
        mp.setattr(tsp, "shells_from_tables", rec_shells)
        t21.run_lightcone(inputs, device="cpu")
    runs = tracing.runs()
    return dict(inputs=inputs, seen=seen, run=runs[-1], new_runs=len(runs) - before)


def _books(run):
    return [run] + run["nodes"]


def test_one_run_a_lightcone_with_a_node_a_redshift(cone):
    run = cone["run"]
    assert cone["new_runs"] == 1 and run["entry"] == "generate_lightcone"
    zs = [float(z) for z in cone["inputs"].node_redshifts]
    assert [n["index"] for n in run["nodes"]] == list(range(len(zs)))
    assert [n["z"] for n in run["nodes"]] == zs
    # the finalization, the last node's NaN check and the ICs the cone made
    # itself are the run's own
    assert set(run["spans"]) == {"lc.finalize", "scroll.validate", *ICS_PARENTS}


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_span_booked_with_its_parent_and_self_time(cone, name):
    """In a node, each span under its parent; in the run's own book (outside
    any node) the finalization and the last node's NaN check, under none."""
    run = cone["run"]
    booked = [(b is run, b["spans"][name]) for b in _books(run) if name in b["spans"]]
    assert booked, f"{name} was never booked"
    for in_run, (count, seconds, parent) in booked:
        assert parent == (None if in_run else PARENTS[name]) and count >= 1 and seconds > 0
    for book in _books(cone["run"]):
        if name in book["spans"]:
            assert tracing.self_seconds(book["spans"], name) >= 0


def test_ionize_radii_the_ladder_where_it_ran_and_0_where_it_was_skipped(cone):
    ladder = cone["seen"]["ladder"]
    radii = {n["z"]: n["counters"]["ionize.radii"] for n in cone["run"]["nodes"]}
    skipped = [z for z in radii if z not in ladder]
    assert skipped and len(ladder) >= 2, (skipped, ladder)
    for z, by_stage in radii.items():
        assert by_stage == {"ionize": ladder.get(z, 0)}
    assert all(n > 0 for n in ladder.values())


def test_ts_uploads_are_the_shells_tables(cone):
    """Each full Ts step uploads its shells' tables, the x_e axis, the three
    k axes of the shell scan and the cell update's two Lya tables and its
    kappa knots, each once."""
    steps = cone["seen"]["ts"]
    nodes = {n["z"]: n for n in cone["run"]["nodes"]}
    assert len(steps) == len(nodes) - 1  # the first node starts the Ts chain
    for z, step in steps.items():
        tables = sum(isinstance(v, torch.Tensor) for sh in step["shells"] for v in sh.values())
        assert tables >= len(step["shells"]) * 3
        want = tables + 1 + 3 + 2 + len(step["h"]["kappa_knots"])
        assert nodes[z]["counters"]["h2d.uploads"]["ts"] == want


def test_each_ts_step_books_its_xe_tables_once(cone):
    """The <x_e>-bound tables of a full Ts step (its tau_X = 1 horizons and
    frequency integrals) run as one batched call for the whole ladder: one
    `ts.xe_tables` a node with a Ts step, inside its host tables."""
    steps = cone["seen"]["ts"]
    for n in cone["run"]["nodes"]:
        booked = n["spans"].get("ts.xe_tables")
        if n["z"] not in steps:
            assert booked is None
            continue
        count, seconds, parent = booked
        assert count == 1 and parent == "ts.host_tables"
        assert 0 < seconds <= n["spans"]["ts.host_tables"][1]


def test_prefetch_build_and_wait_booked(cone):
    """Every node but the last asks the worker for the next node's SFRD
    tables (booked to the asking node); every node with a full Ts step
    takes them."""
    nodes = cone["run"]["nodes"]
    built = [n["index"] for n in nodes if "ts.sfrd_build" in n["spans"]]
    waited = [n["index"] for n in nodes if "ts.sfrd_wait" in n["spans"]]
    assert built == list(range(len(nodes) - 1))
    assert waited == list(range(1, len(nodes)))
    for n in nodes:
        if "ts.sfrd_build" in n["spans"]:
            count, seconds, parent = n["spans"]["ts.sfrd_build"]
            assert count == 1 and seconds > 0 and parent is None


@pytest.mark.parametrize("n_runs", [1, tracing.MAX_RUNS + 6])
def test_runs_kept_at_most_64_and_all_in_the_totals(n_runs):
    @tracing.traced_run
    def chain(k):
        tracing.begin_node(0, float(k))
        with tracing.span("test.node"):
            tracing.count("test.count", 2)
        yield k

    before = tracing.totals()
    done0 = before["spans"].get("test.node", (0, 0.0, None))[0]
    counted0 = sum(before["counters"].get("test.count", {}).values())
    for k in range(n_runs):
        assert list(chain(k)) == [k]
    kept = tracing.runs()
    assert len(kept) <= tracing.MAX_RUNS
    mine = [r for r in kept if r["entry"] == "chain"][-min(n_runs, tracing.MAX_RUNS):]
    assert [r["nodes"][0]["z"] for r in mine] == [float(k) for k in range(n_runs)][-len(mine):]
    assert all(r["nodes"][0]["counters"] == {"test.count": {"test.node": 2}} for r in mine)
    after = tracing.totals()
    assert after["spans"]["test.node"][0] - done0 == n_runs
    assert sum(after["counters"]["test.count"].values()) - counted0 == 2 * n_runs


def test_work_outside_a_run_goes_to_the_totals_alone():
    runs0 = len(tracing.runs())
    with tracing.span("test.outside"):
        tracing.count("test.outside_count")
    assert len(tracing.runs()) == runs0
    booked = tracing.totals()
    assert booked["spans"]["test.outside"][2] is None
    assert booked["counters"]["test.outside_count"]["test.outside"] >= 1
    assert all("test.outside" not in b["spans"] for r in tracing.runs() for b in _books(r))


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """A three-node cone under a CPU profiler: its trace's events by name."""
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t21.run_lightcone(_inputs(z_min=16.0), device="cpu")
    prof.export_chrome_trace(str(path))
    events = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("name") in PARENTS:
            events.setdefault(ev["name"], []).append(ev)
    return events


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_span_is_a_cpu_op_inside_its_parent(profiled, name):
    events = profiled.get(name)
    assert events, f"no profiler event named {name}"
    assert all(ev["cat"] == "cpu_op" for ev in events), {ev["cat"] for ev in events}
    parent = PARENTS[name]
    if parent is None:
        return
    if name == "scroll.validate":  # the last node's check runs after the scroll
        events = sorted(events, key=lambda ev: ev["ts"])[:-1]
    for ev in events:
        assert any(p["tid"] == ev["tid"] and p["ts"] <= ev["ts"]
                   and ev["ts"] + ev["dur"] <= p["ts"] + p["dur"]
                   for p in profiled[parent]), f"{name} at {ev['ts']} outside every {parent}"


def test_no_profiler_range_opened_without_a_profiler(monkeypatch):
    opened = []

    class Fake:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, "_RecordFunctionFast", Fake)
    with tracing.span("test.off"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("test.on"):
            pass
    assert opened == ["test.on"]


def test_threads_booking_their_own_names_into_one_node_lose_nothing():
    """The prefetch worker books into the node that asked while the main
    thread books other names there: with more threads than cores and a short
    switch interval, no booking is lost."""
    n_threads, n_spans = 12, 2000

    @tracing.traced_run
    def threaded_chain():
        tracing.begin_node(0, 1.0)
        book = tracing.here()

        def work(k):
            for _ in range(n_spans):
                with tracing.span(f"test.thread{k}", at=book):
                    pass

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for _ in range(n_spans):
                with tracing.span("test.main"):
                    tracing.count("test.main_count")
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        yield

    list(threaded_chain())
    node = tracing.runs()[-1]["nodes"][0]
    assert node["spans"]["test.main"][0] == n_spans
    assert node["counters"]["test.main_count"] == {"test.main": n_spans}
    for k in range(n_threads):
        assert node["spans"][f"test.thread{k}"][0] == n_spans


@pytest.fixture(scope="module")
def golden_ics():
    """ICs at golden size outside any run, twice: from an empty recorder,
    and again after `reset()`; what each booked into the totals."""
    inputs = t21.InputParameters(random_seed=11).evolve_input_structs(
        HII_DIM=24, DIM=72, BOX_LEN=36.0, PERTURB_ALGORITHM="2LPT")
    out = []
    for _ in range(2):
        tracing.reset()
        runs0 = len(tracing.runs())
        ics = t21.compute_initial_conditions(inputs, device="cpu")
        out.append((ics, tracing.totals(), len(tracing.runs()) - runs0, tracing.runs()))
    return out


def test_ics_book_their_stages_into_the_totals_alone(golden_ics):
    for _, totals, new_runs, kept in golden_ics:
        spans = totals["spans"]
        assert {k: v[2] for k, v in spans.items()} == ICS_PARENTS
        assert all(count == 1 and seconds > 0 for count, seconds, _ in spans.values())
        assert tracing.self_seconds(spans, "ics") >= 0
        assert new_runs == 0 and kept == []


def test_ics_book_no_peak_counter_off_the_card(golden_ics):
    for _, totals, _, _ in golden_ics:
        assert "ics.peak_bytes" not in totals["counters"]


def test_ics_fields_bit_equal_with_the_recorder_and_after_reset(golden_ics):
    (first, *_), (second, *_) = golden_ics
    for name in ("hires_density", "lowres_density", "vx", "vy", "vz",
                 "vx_2LPT", "vy_2LPT", "vz_2LPT"):
        assert torch.equal(getattr(first, name), getattr(second, name)), name
