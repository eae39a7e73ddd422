"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import math
import re
import shutil

import pytest
from conftest import BENCH_DIR

from harness import cells

ROOT = BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fit_the_check_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in BENCH[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= e["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert e["source"] in SOURCES and 1 <= len(e["layer"]) <= 200
        assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(e["name"]) and e["name"] not in seen, e["name"]
        seen.add(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in {"lower", "higher"}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = cells.resolve(w["name"], BENCH)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_workload_resolves_its_files_by_name(workload):
    cell = cells.resolve(workload, BENCH)
    entry = next(c for c in BENCH["configs"] if c["name"] == cell.config_name)
    assert entry["file"].startswith("benchmark/configs/")
    assert cell.config["name"] == cell.config_name
    assert cell.config["reduced"] == entry["reduced"]
    assert cell.config["source"] == entry["source"]
    for key in entry["reduced"]:
        assert key in cell.config or key in cell.config["params"], key
    assert cell.traffic["loop"] == "closed"
    assert cell.limits, f"limits/{workload}.toml is missing"
    for m in cell.per_layer:
        reader = cells.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
    z_min, z_max = cells.cone_band(cell, cell.config["params"]["Z_HEAT_MAX"])
    assert z_min < z_max


def test_metric_files_each_belong_to_a_metric():
    names = {m["name"] for m in BENCH["per_layer"]}
    assert {p.name[:-3] for p in (BENCH_DIR / "metrics").glob("*.py")} == names


def test_limits_lie_between_their_readings():
    for path in (BENCH_DIR / "limits").glob("*.toml"):
        for name, lim in cells._toml(path).items():
            assert lim["lower"] < lim["limit"] < lim["upper"], (path.name, name)
            assert lim["upper"] >= 3 * lim["lower"], (path.name, name)


def test_a_new_cell_from_new_files_alone_resolves(tmp_path):
    """A later change adds a configuration, a traffic mix, a per-layer metric
    and a cell as new files and entries: nothing of the harness changes."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR / "configs", bench_dir / "configs")
    shutil.copytree(BENCH_DIR / "traffic", bench_dir / "traffic")
    shutil.copytree(BENCH_DIR / "metrics", bench_dir / "metrics")
    shutil.copytree(BENCH_DIR / "limits", bench_dir / "limits")
    (bench_dir / "configs" / "tiny-16-48.toml").write_text(
        'name = "tiny-16-48"\nsource = "test"\nreduced = []\n'
        '[params]\nHII_DIM = 16\nDIM = 48\nBOX_LEN = 24.0\nSOURCE_MODEL = "E-INTEGRAL"\n'
        'Z_HEAT_MAX = 35.0\nZPRIME_STEP_FACTOR = 1.2\n')
    (bench_dir / "traffic" / "late.toml").write_text(
        'loop = "closed"\nz_min = 5.0\nz_max = 7.0\nquantities = ["brightness_temp"]\n'
        'include_dvdr_in_tau21 = true\napply_rsds = false\n')
    (bench_dir / "metrics" / "late.nodes.py").write_text(
        'UNIT = "nodes"\nLAYER = "coeval scroll"\nMOVES = "lightcone_s"\n\n\n'
        'def read(record):\n    return record.get("nodes")\n')
    (bench_dir / "limits" / "tiny-late.toml").write_text(
        "[Tb]\nlimit = 1e-4\nlower = 1e-6\nupper = 1e-2\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-16-48", "source": "test",
                             "file": "benchmark/configs/tiny-16-48.toml", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny-late", "config": "tiny-16-48",
                               "traffic": "late", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "late.nodes", "unit": "nodes", "better": "lower",
                               "source": "program_counter", "layer": "coeval scroll",
                               "moves": "lightcone_s", "workloads": ["tiny-late"]})
    cell = cells.resolve("tiny-late", bench, root=tmp_path, bench_dir=bench_dir)
    assert cell.traffic["z_max"] == 7.0 and cell.limits["Tb"]["limit"] == 1e-4
    assert [m["name"] for m in cell.per_layer] == ["late.nodes"]
    reader = cells.metric_reader("late.nodes", bench_dir)
    assert reader.read({"nodes": 3}) == 3

    import py21cmfast_torch as p21

    inputs = cells.build_inputs(p21.InputParameters, cell, seed=1)
    assert math.isclose(min(inputs.node_redshifts), 5.0)
    assert max(inputs.node_redshifts) <= 7.0 * 1.2
