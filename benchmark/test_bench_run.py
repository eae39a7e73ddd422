"""The harness's loop on the CPU at tiny boxes: the result line, the traced
record, the reference's agreement with the program, and what the harness and
the reference load."""

import json
import subprocess
import sys
import time

import pytest
import torch
from conftest import BENCH_DIR, SEED, TINY

from harness import cells, loop

ROOT = BENCH_DIR.parent
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
CPU = torch.device("cpu")


def _run(workload, trace=False):
    cell = cells.resolve(workload)
    return cell, loop.run(cell, SEED, 0.0, trace, CPU, time.perf_counter(),
                          overrides=TINY[cell.config_name])


@pytest.fixture(scope="module", params=["latest-dawn", "simple-eor"])
def tiny_run(request):
    return _run(request.param)


def test_line_has_the_contract_keys_and_checks_last(tiny_run):
    cell, (result, lines) = tiny_run
    line = json.loads(json.dumps(result))
    assert KEYS <= set(line)
    assert list(line)[-1] == "checks"
    assert line["attempted"] == 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"lightcone_s", "setup_s"}  # no peak off the card
    for m in line["metrics"].values():
        assert m["value"] > 0
    assert lines == [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
                     for k, c in line["checks"].items()]


def test_the_reference_and_the_program_agree(tiny_run):
    cell, (result, _) = tiny_run
    checks = result["checks"]
    want = {"ics", "Tb", "density", "xH", "v_z"}
    if cell.config["params"]["USE_TS_FLUCT"]:
        want |= {"Ts", "x_e", "tau21"}
    assert set(checks) == want
    for name, c in checks.items():
        assert c["value"] <= c["limit"], name
    assert result["correct"] is True


def test_traced_run_reads_its_layers():
    cell, (result, _) = _run("simple-eor", trace=True)
    assert result["correct"] is True
    got = set(result["metrics"])
    assert {"ics.s", "perturb.ms_per_node", "ionize.s_per_node", "scroll.self_ms_per_node",
            "scroll.host_syncs_per_node", "lc.ms_per_cone"} <= got
    assert got <= {m["name"] for m in cell.per_layer}
    # the device's metrics need the card; Ts does not run in this cell
    assert not got & {"device.idle_pct", "device.kernels_per_node", "deposit.roofline_pct"}
    assert not any(name.startswith("ts.") for name in got)
    assert "busy_s" not in result["device"] and result["device"]["window_s"] > 0
    assert result["metrics"]["ionize.s_per_node"]["value"] > 0


def _modules_loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, check=True).stdout.strip().splitlines()[-1]
    return set(json.loads(out))


PRELUDE = (
    "import sys, json, pkgutil, importlib, torch; torch.set_num_threads(2); "
    f"sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]; "
)
TOP = "print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))"


def test_the_harness_and_the_reference_load_no_jax():
    code = PRELUDE + (
        "import ref21cm, harness; "
        "[importlib.import_module(m.name) for p in (ref21cm, harness) "
        " for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
        "import py21cmfast_torch, harness.loop, harness.tracing; " + TOP)
    assert not _modules_loaded(code) & {"jax", "jaxlib", "flax", "py21cmfast_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    tiny = TINY["simple-256-768"]
    code = PRELUDE + (
        "import ref21cm; "
        "[importlib.import_module(m.name) for m in "
        " pkgutil.walk_packages(ref21cm.__path__, 'ref21cm.')]; "
        "from harness import cells, reference, compare; "
        "cell = cells.resolve('simple-eor'); dev = torch.device('cpu'); "
        f"ics = reference.initial_conditions(cell, 5, dev, {tiny!r}); "
        f"reference.cone(cell, 5, ics, dev, {tiny!r}); " + TOP)
    loaded = _modules_loaded(code)
    assert "ref21cm" in loaded
    assert not loaded & {"py21cmfast_torch", "jax", "jaxlib", "flax", "py21cmfast_tpu"}


def test_run_without_a_card_prints_no_result_and_exits_nonzero():
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "simple-eor", "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import run

    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax_like_but_not", object())
    monkeypatch.setitem(sys.modules, "py21cmfast_tpu_extra.sub", object())
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert "jaxlib" in run.forbidden_modules()
