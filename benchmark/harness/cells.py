"""Resolve a cell of BENCHMARK.json into its files, all found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix:

- the configuration is the TOML file its `configs` entry names
  (`configs/<name>.toml`): the source's parameters under `[params]`, the
  sizes assumed and the keys reduced;
- the traffic mix is `traffic/<traffic>.toml`: the redshift band of each
  cone, the lightcone quantities, the finalization and the loop;
- each per-layer metric is `metrics/<metric>.py`, a reader of the traced
  run's record (see `read_metric`);
- the limits of the comparison that decides `correct` are
  `limits/<workload>.toml`.

A later change adds a cell by adding these files and a `workloads` entry;
nothing here names a cell.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import tomllib
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple  # BENCHMARK.json entries this cell reports
    per_layer: tuple
    limits: dict


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _toml(path: Path) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


def resolve(name: str, bench: dict | None = None, root: Path = ROOT,
            bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` with its configuration, traffic and limits; `bench`
    is BENCHMARK.json's content (read from `root` when None)."""
    bench = load_benchmark(root) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _toml(root / configs[w["config"]]["file"])
    traffic = _toml(bench_dir / "traffic" / f"{w['traffic']}.toml")
    if traffic.get("loop") != "closed":
        raise ValueError(f"traffic {w['traffic']}: only the closed loop is driven")
    limits_file = bench_dir / "limits" / f"{name}.toml"
    limits = _toml(limits_file) if limits_file.exists() else {}
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=config,
        traffic_name=w["traffic"],
        traffic=traffic,
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
        limits=limits,
    )


def metric_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The module of `metrics/<metric>.py`: UNIT, LAYER, MOVES and
    `read(record) -> float | None`."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metric(metric: str, record: dict):
    """The metric's value from a traced run's record, or None where the
    record holds nothing for it to read."""
    value = metric_reader(metric).read(record)
    return None if value is None else float(value)


def cone_band(cell: Cell, z_heat_max: float) -> tuple[float, float]:
    """(z_min, z_max) of the cell's cones: the traffic's band, from the
    configuration's Z_HEAT_MAX where the traffic gives no upper end."""
    z_min = float(cell.traffic["z_min"])
    z_max = float(cell.traffic.get("z_max", z_heat_max))
    floor = cell.config.get("z_min")
    if floor is not None and z_min < float(floor):
        raise ValueError(
            f"traffic {cell.traffic_name} reaches z={z_min}, below the depth "
            f"{floor} that configuration {cell.config_name} is cut to")
    return z_min, z_max


def build_inputs(input_parameters, cell: Cell, seed: int, overrides: dict | None = None):
    """The cell's inputs for `seed`, built with the given InputParameters
    class (the program's or the reference's): the configuration's
    parameters, `overrides` over them, and the traffic's node ladder."""
    params = dict(cell.config["params"])
    params.update(overrides or {})
    inputs = input_parameters(random_seed=int(seed)).evolve_input_structs(**params)
    z_min, z_max = cone_band(cell, inputs.simulation_options.Z_HEAT_MAX)
    return inputs.with_logspaced_redshifts(z_min, z_max)


def lightcone_quantities(cell: Cell, use_ts: bool) -> tuple:
    """The traffic's lightcone quantities, with tau_21 where the spin
    temperature runs (the dvdr correction reads it)."""
    q = tuple(cell.traffic["quantities"])
    return q + (("tau_21",) if use_ts and "tau_21" not in q else ())
