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
WARMUP_NODES = 3  # the warm-up cone's nodes where the ladder runs above the band


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


def from_files(config_file: Path, traffic: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """A cell that BENCHMARK.json does not name yet: the configuration file
    under one traffic mix on one chip, with no metrics and no limits (for
    `calibrate.py`, which reads the limits' readings)."""
    config = _toml(Path(config_file))
    return Cell(name=f"{config['name']}.{traffic}", chips=1, config_name=config["name"],
                config=config, traffic_name=traffic,
                traffic=_toml(bench_dir / "traffic" / f"{traffic}.toml"),
                end_to_end=(), per_layer=(), limits={})


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
    parameters, `overrides` over them, and the node ladder: the band's, or
    where the physics carries a history (`carries_history`) the whole ladder
    from the band's low end up to Z_HEAT_MAX, as a user's cone must run it."""
    params = dict(cell.config["params"])
    params.update(overrides or {})
    inputs = input_parameters(random_seed=int(seed)).evolve_input_structs(**params)
    z_heat_max = inputs.simulation_options.Z_HEAT_MAX
    z_min, z_max = cone_band(cell, z_heat_max)
    return inputs.with_logspaced_redshifts(z_min, z_heat_max if carries_history(inputs) else z_max)


def carries_history(inputs) -> bool:
    """Whether a node's fields depend on the nodes above it, so that the
    scroll starts at Z_HEAT_MAX whatever the band: the spin temperature's
    X-ray and Lyman-alpha history, or recombinations that accumulate (the
    program's own test for a chain that evolves, `drivers/coeval.py`)."""
    astro = inputs.astro_options
    return bool(astro.USE_TS_FLUCT or astro.uses_recombination)


def band_nodes(cell: Cell, inputs) -> tuple[float, ...]:
    """The node redshifts whose slices the cone holds, descending: those of
    `inputs` that lie on the band's own ladder, which grows from the same
    low end by the same factor and so ends a longer ladder node for node.
    Every node, where the ladder is the band's."""
    nodes = tuple(float(z) for z in inputs.node_redshifts)
    band = {float(z) for z in inputs.with_logspaced_redshifts(
        *cone_band(cell, inputs.simulation_options.Z_HEAT_MAX)).node_redshifts}
    kept = tuple(z for z in nodes if z in band)
    if not kept or nodes[len(nodes) - len(kept):] != kept:
        raise ValueError(f"traffic {cell.traffic_name}: the band's nodes {sorted(band)} do "
                         f"not end the ladder {nodes}")
    return kept


def warmup_inputs(cell: Cell, inputs):
    """The inputs of set-up's warm-up cone: `inputs`, or where the ladder
    runs above the band only its lowest WARMUP_NODES nodes, which run every
    stage and shape of the window's cones (a cold Ts start, Ts steps with a
    history, the ionization ladder with its recombinations, the slices, dvdr
    and the RSDs) without set-up paying a whole chained cone."""
    nodes = tuple(float(z) for z in inputs.node_redshifts)
    if len(band_nodes(cell, inputs)) == len(nodes):
        return inputs
    warm = inputs.with_logspaced_redshifts(nodes[-1], nodes[-WARMUP_NODES])
    if tuple(float(z) for z in warm.node_redshifts) != nodes[-WARMUP_NODES:]:
        raise ValueError(f"traffic {cell.traffic_name}: warm-up nodes "
                         f"{warm.node_redshifts} are not the ladder's lowest {WARMUP_NODES}")
    return warm


def lightcone_quantities(cell: Cell, use_ts: bool) -> tuple:
    """The traffic's lightcone quantities, with tau_21 where the spin
    temperature runs (the dvdr correction reads it)."""
    q = tuple(cell.traffic["quantities"])
    return q + (("tau_21",) if use_ts and "tau_21" not in q else ())
