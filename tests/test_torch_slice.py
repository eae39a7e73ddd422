"""The port's saturated-Ts coeval slice against the JAX package, stage by stage
and end to end, at golden size (HII_DIM=24, DIM=72, BOX_LEN=36), on the CPU.

Each stage gets the JAX package's own inputs, carried across by
py21cmfast_torch.interop, so a stage is compared on identical state:
  perturb     density, velocity_z: max-abs <= 1e-4 std (float32 CIC sums in
              another order and FFTs of another library);
  ionization  share of cells with |dxH| > 1e-3 <= 1e-3 and global xH within
              1e-3 (thresholded cells flip on float32 rounding of fcoll);
  Tb          max-abs <= 1e-5 max|Tb|.
The whole coeval from one shared hires density meets the gates of
tests/test_golden.py against the JAX package run on that density.
Plus the port's guards: no JAX imports (py21cmfast_torch.parallel
included), `torch.distributed` imported only by py21cmfast_torch.parallel,
which `import py21cmfast_torch` does not load, no silent CPU fallback, and
the options of earlier slices running on the CPU, a device mesh among them.
And the parts of chip_smoke.py, the card check, that run without a card:
its headline inputs against bench.py's, its gates, and its exit without a
card.
"""

import _torch_threads  # noqa: F401
import ast
import subprocess
import sys
from pathlib import Path

import attrs
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ics import jax_inputs, numpy_grf, port_inputs

import bench
import chip_smoke
import py21cmfast_torch as t21
from py21cmfast_torch import interop
from py21cmfast_torch.models import brightness as tbright
from py21cmfast_torch.models.halobox import compute_fixed_halo_grid
from py21cmfast_torch.models import ionization as tion
from py21cmfast_torch.models import perturb as tpert
from py21cmfast_tpu.drivers.coeval import run_coeval as j_run_coeval
from py21cmfast_tpu.models import brightness as jbright
from py21cmfast_tpu.models import ics as jics
from py21cmfast_tpu.models import ionization as jion
from py21cmfast_tpu.models import perturb as jpert
from py21cmfast_tpu.ops import ps

REPO = Path(__file__).resolve().parent.parent
REDSHIFTS = [8.0, 10.5]


def _numpy(struct):
    """A JAX output struct as a dict of numpy arrays / scalars."""
    return {k: (None if v is None else np.asarray(v)) for k, v in vars(struct).items()}


@pytest.fixture(scope="module")
def jax_state():
    """JAX inputs, ICs from a numpy GRF, and per-z perturbed/ionized boxes."""
    jinp = jax_inputs()
    dens = numpy_grf(jinp, seed=5)
    j_ics = jics.compute_initial_conditions(jinp, initial_density=dens)
    pfs = {z: jpert.perturb_field(z, jinp, j_ics) for z in REDSHIFTS}
    ions = {z: jion.compute_ionization_field(z, jinp, pfs[z]) for z in REDSHIFTS}
    return dict(jinp=jinp, tinp=port_inputs(jinp), dens=dens, ics=j_ics, pf=pfs, ion=ions)


def _xh_gates(got, ref, ctx):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    flipped = np.mean(np.abs(got - ref) > 1e-3)
    assert flipped <= 1e-3, f"{ctx}: {flipped:.2e} of cells differ by > 1e-3"
    assert abs(got.mean() - ref.mean()) <= 1e-3, (ctx, got.mean(), ref.mean())


@pytest.mark.parametrize("z", REDSHIFTS)
def test_perturb_matches_jax(jax_state, z):
    ics = interop.initial_conditions_from_numpy(_numpy(jax_state["ics"]), "cpu")
    got = tpert.perturb_field(z, jax_state["tinp"], ics, device="cpu")
    ref = jax_state["pf"][z]
    assert float(got.redshift) == float(ref.redshift)
    for name in ("density", "velocity_z"):
        r = np.asarray(getattr(ref, name))
        err = np.abs(getattr(got, name).numpy() - r).max()
        assert err <= 1e-4 * r.std(), f"{name} z={z}: max-abs {err:.3e} > 1e-4 x {r.std():.3e}"


@pytest.mark.parametrize("z", REDSHIFTS)
def test_ionization_matches_jax(jax_state, z):
    pf = interop.perturbed_field_from_numpy(_numpy(jax_state["pf"][z]), "cpu")
    got = tion.compute_ionization_field(z, jax_state["tinp"], pf, device="cpu")
    ref = jax_state["ion"][z]
    _xh_gates(got.neutral_fraction.numpy(), ref.neutral_fraction, f"xH z={z}")
    np.testing.assert_allclose(got.mean_f_coll, ref.mean_f_coll, rtol=1e-6)
    ionized_agree = (got.neutral_fraction.numpy() < 1e-30) == (np.asarray(ref.neutral_fraction) < 1e-30)
    np.testing.assert_array_equal(
        got.z_reion.numpy()[ionized_agree], np.asarray(ref.z_reion)[ionized_agree]
    )
    # kinetic temperature is continuous where the neutral fraction agrees
    same = np.abs(got.neutral_fraction.numpy() - np.asarray(ref.neutral_fraction)) <= 1e-6
    tk, tk_ref = got.kinetic_temperature.numpy()[same], np.asarray(ref.kinetic_temperature)[same]
    assert np.abs(tk - tk_ref).max() <= 1e-5 * np.abs(tk_ref).max()


@pytest.mark.parametrize("branch", ["table-gather", "CONST-ION-EFF"])
def test_ionization_other_branches_match_jax(jax_state, monkeypatch, branch):
    """The per-R table gather (taken when a Chebyshev fit is poor) and the
    closed-form erfc of CONST-ION-EFF, at z=8 on the same perturbed field."""
    jinp, tinp = jax_state["jinp"], jax_state["tinp"]
    if branch == "table-gather":
        for mod in (tion, jion):
            fit = mod._fit_log_cheby
            monkeypatch.setattr(mod, "_fit_log_cheby", lambda t, c, fit=fit: (*fit(t, c)[:2], False))
    else:
        jinp = jinp.evolve_input_structs(SOURCE_MODEL="CONST-ION-EFF")
        tinp = tinp.evolve_input_structs(SOURCE_MODEL="CONST-ION-EFF")
    jpf = jax_state["pf"][8.0]
    ref = jion.compute_ionization_field(8.0, jinp, jpf)
    pf = interop.perturbed_field_from_numpy(_numpy(jpf), "cpu")
    got = tion.compute_ionization_field(8.0, tinp, pf, device="cpu")
    assert 0.0 < ref.global_xH < 1.0
    _xh_gates(got.neutral_fraction.numpy(), ref.neutral_fraction, branch)


@pytest.mark.parametrize("z", REDSHIFTS)
def test_brightness_matches_jax(jax_state, z):
    jinp = jax_state["jinp"]
    ref = jbright.brightness_temperature(jinp, jax_state["ion"][z], jax_state["pf"][z])
    ion = interop.ionized_box_from_numpy(_numpy(jax_state["ion"][z]), "cpu")
    pf = interop.perturbed_field_from_numpy(_numpy(jax_state["pf"][z]), "cpu")
    got = tbright.brightness_temperature(jax_state["tinp"], ion, pf, device="cpu")
    r = np.asarray(ref.brightness_temp)
    assert np.abs(got.brightness_temp.numpy() - r).max() <= 1e-5 * np.abs(r).max()
    assert got.tau_21 is None


def test_brightness_with_spin_temperature_matches_jax():
    """The optical-depth branch of _tb_kernel, on the same random grids.
    tau21 within 1e-5 max|tau|.  Tb = (1 - exp(-tau)) 1000 (Ts - Tcmb)/(1+z)
    cancels at small tau: two libraries' float32 exp, each within an ulp,
    leave up to 2 eps in 1 - exp(-tau), so Tb may also differ by
    2 eps 1000 |Ts - Tcmb| / (1+z) in each cell."""
    rng = np.random.default_rng(3)
    xh = rng.uniform(0, 1, (6, 6, 6)).astype(np.float32)
    delta = rng.normal(0, 0.5, (6, 6, 6)).clip(-0.9).astype(np.float32)
    ts = rng.uniform(5, 300, (6, 6, 6)).astype(np.float32)
    c, t_rad, zp1 = np.float32(25.0), np.float32(29.97), np.float32(11.0)
    ref_tb, ref_tau = (np.asarray(a) for a in jbright._tb_kernel(
        jnp.asarray(xh), jnp.asarray(delta), jnp.asarray(ts), c, t_rad, zp1, use_ts=True))
    tb, tau = tbright._tb_kernel(
        *(torch.from_numpy(a) for a in (xh, delta, ts)),
        *(torch.tensor(v) for v in (c, t_rad, zp1)), use_ts=True)
    assert np.abs(tau.numpy() - ref_tau).max() <= 1e-5 * np.abs(ref_tau).max()
    eps = np.finfo(np.float32).eps
    bound = 1e-5 * np.abs(ref_tb).max() + 2 * eps * 1000 * np.abs(ts - t_rad) / zp1
    assert np.all(np.abs(tb.numpy() - ref_tb) <= bound)


def test_simple_coeval_meets_golden_gates_against_jax(jax_state):
    """The port's whole coeval (its own ICs from the shared hires density, then
    perturb -> ionize -> Tb) against the JAX package's on the same density."""
    z = 10.5
    ref = j_run_coeval(jax_state["jinp"], z, initial_conditions=jax_state["ics"])
    ics = t21.compute_initial_conditions(
        jax_state["tinp"], initial_density=jax_state["dens"], device="cpu")
    got = t21.run_coeval(jax_state["tinp"], z, initial_conditions=ics, device="cpu")
    box_lens = jax_state["jinp"].simulation_options.box_lens
    bt, bt_ref = got.brightness_temp.numpy(), np.asarray(ref.brightness_temp)
    np.testing.assert_allclose(
        got.neutral_fraction.numpy().mean(), np.asarray(ref.neutral_fraction).mean(), atol=5e-3)
    np.testing.assert_allclose(bt.mean(), bt_ref.mean(), rtol=5e-3, atol=0.05)
    _, p, _ = ps.power_spectrum_1d(bt, box_lens, n_bins=8)
    _, p_ref, _ = ps.power_spectrum_1d(bt_ref, box_lens, n_bins=8)
    good = np.isfinite(p_ref) & (p_ref > 0)
    np.testing.assert_allclose(p[good], p_ref[good], rtol=1e-2)


def test_generate_coeval_yields_highest_redshift_first():
    inp = t21.InputParameters(random_seed=2).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL")
    out = list(t21.generate_coeval(inp, [7.0, 9.0, 8.0], device="cpu"))
    assert [c.redshift for c in out] == [9.0, 8.0, 7.0]
    ics = out[0].initial_conditions
    assert all(c.initial_conditions is ics for c in out)
    xh = [c.ionized_box.global_xH for c in out]
    assert xh[0] >= xh[1] >= xh[2]


@pytest.mark.parametrize(
    "cls, make",
    [
        (t21.InitialConditions, interop.initial_conditions_from_numpy),
        (t21.PerturbedField, interop.perturbed_field_from_numpy),
        (t21.IonizedBox, interop.ionized_box_from_numpy),
        (t21.BrightnessTemp, interop.brightness_temp_from_numpy),
        (t21.TsBox, interop.ts_box_from_numpy),
    ],
    ids=lambda v: getattr(v, "__name__", ""),
)
def test_interop_structs_round_trip(cls, make):
    """Every field name of the port's struct is accepted from a numpy dict:
    grids become float32 tensors, scalars numpy float32, absent fields None."""
    import dataclasses

    rng = np.random.default_rng(0)
    names = [f.name for f in dataclasses.fields(cls)]
    arrays = {n: (np.float64(9.5) if n.startswith(("redshift", "mean", "log10"))
                  else rng.normal(size=(3, 4, 5))) for n in names[:4]}
    struct = make(arrays, "cpu")
    back = struct.to_numpy()
    for n in names:
        if n not in arrays:
            assert back[n] is None
        elif np.ndim(arrays[n]):
            assert getattr(struct, n).dtype == torch.float32
            np.testing.assert_array_equal(back[n], arrays[n].astype(np.float32))
        else:
            assert back[n] == np.float32(arrays[n]) and isinstance(back[n], np.float32)


# ------------------------------------------------------------------- guards


def test_import_loads_no_jax():
    code = (
        "import sys; before = set(sys.modules); import py21cmfast_torch; "
        "new = [m for m in set(sys.modules) - before "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'py21cmfast_tpu')]; "
        "print(new); sys.exit(1 if new else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parallel_import_loads_no_jax():
    """Every module of the multi-GPU layer imports without JAX."""
    mods = [f"py21cmfast_torch.parallel.{p.stem}"
            for p in sorted((REPO / "py21cmfast_torch" / "parallel").glob("*.py"))
            if p.stem != "__init__"]
    assert len(mods) == 8
    code = (
        "import sys, importlib; before = set(sys.modules)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "new = [m for m in set(sys.modules) - before "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'py21cmfast_tpu')]; "
        "print(new); sys.exit(1 if new else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_forms_no_process_group():
    """`import py21cmfast_torch` loads no torch.distributed module beyond
    those `import torch` loads, not py21cmfast_torch.parallel, and forms no
    process group; and only py21cmfast_torch/parallel imports
    torch.distributed."""
    code = (
        "import sys, torch; before = {m for m in sys.modules if m.startswith('torch.distributed')}\n"
        "import py21cmfast_torch, torch.distributed as dist\n"
        "after = {m for m in sys.modules if m.startswith('torch.distributed')}\n"
        "assert after == before, sorted(after - before)\n"
        "assert not any(m.startswith('py21cmfast_torch.parallel') for m in sys.modules)\n"
        "assert not dist.is_initialized()\n"
        "print('CLEAN')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert "CLEAN" in proc.stdout, proc.stdout + proc.stderr
    files = sorted((REPO / "py21cmfast_torch").rglob("*.py"))
    users = {str(f.relative_to(REPO)) for f in files for m in _imported_modules(f)
             if m.startswith("torch.distributed")}
    assert users and all(u.startswith("py21cmfast_torch/parallel/") for u in users), users


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((REPO / "py21cmfast_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        (str(f.relative_to(REPO)), m) for f in files for m in _imported_modules(f)
        if m.split(".")[0] in ("jax", "jaxlib", "py21cmfast_tpu")
    ]
    assert not bad, bad


INPUT_GROUPS = ("cosmo_params", "matter_options", "simulation_options", "astro_options",
                "astro_params")


def _plain(inputs):
    return {**{g: attrs.asdict(getattr(inputs, g)) for g in INPUT_GROUPS},
            "random_seed": inputs.random_seed, "node_redshifts": list(inputs.node_redshifts)}


@pytest.mark.parametrize("dim", [768, 1024], ids=["256-768", "256-1024"])
def test_headline_inputs_equal_bench_py(dim):
    """chip_smoke.py's one headline builder is bench.py's, field for field,
    but for MINIMIZE_MEMORY, which chip_smoke.py turns on at DIM 768 too."""
    got = _plain(chip_smoke._headline_inputs(dim))
    ref = _plain(bench._headline_inputs(256, dim, 3, 5.0, 35.0, 1.02))
    assert got["matter_options"]["MINIMIZE_MEMORY"] is True
    assert ref["matter_options"]["MINIMIZE_MEMORY"] is (dim == 1024)
    ref["matter_options"]["MINIMIZE_MEMORY"] = True
    assert got == ref
    assert len(got["node_redshifts"]) == 92


@pytest.mark.parametrize("case", ["ts-shell-launches", "ts-shell-path", "coeval-fields",
                                  "host-memory"])
def test_chip_smoke_gates_fail_a_wrong_result(monkeypatch, case):
    """chip_smoke.py's gates that read no card pass a right result and raise
    on a wrong one: the Ts shell kernels' launches against the recorder's
    kernel shells, and against the path a run should take; a sharded node's
    fields against the single-device run's; the host's free memory."""
    from py21cmfast_torch.ops import ts_shell

    monkeypatch.setattr(chip_smoke, "TS_SHELL_BY_PATH", {})
    for kernel in (ts_shell.ts_shell_reduce, ts_shell.ts_shell_accumulate):
        monkeypatch.setattr(kernel, "launches", kernel.launches)
    if case == "ts-shell-launches":
        assert chip_smoke._ts_shell_read("right", chip_smoke._ts_shell_zero()) == 0
        shells0 = chip_smoke._ts_shell_zero()
        ts_shell.ts_shell_reduce.launches = ts_shell.ts_shell_accumulate.launches = 1
        with pytest.raises(AssertionError, match="kernel shells"):
            chip_smoke._ts_shell_read("wrong", shells0)
    elif case == "ts-shell-path":
        assert chip_smoke._ts_shell_read("right", chip_smoke._ts_shell_zero(), taken=False) == 0
        with pytest.raises(AssertionError, match="expected some"):
            chip_smoke._ts_shell_read("wrong", chip_smoke._ts_shell_zero(), taken=True)
    elif case == "coeval-fields":
        rng = np.random.default_rng(0)
        ref = dict(density=rng.normal(0, 1, (8, 8, 8)), xH=rng.uniform(0, 1, (8, 8, 8)),
                   Tb=rng.normal(10, 5, (8, 8, 8)))
        assert chip_smoke._coeval_gates("right", 8.0, dict(ref), ref)[1]
        assert not chip_smoke._coeval_gates("wrong", 8.0, dict(ref, density=ref["density"] + 1e-3),
                                            ref)[1]
    else:
        monkeypatch.setattr(chip_smoke, "DISCRETE_HOST_GIB", 0.0)
        chip_smoke.check_host_memory()
        monkeypatch.setattr(chip_smoke, "DISCRETE_HOST_GIB", float("inf"))
        with pytest.raises(SystemExit, match="host memory free"):
            chip_smoke.check_host_memory()


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


@pytest.mark.parametrize("how", ["main", "script"])
def test_chip_smoke_without_a_card_exits_nonzero(no_cuda, how):
    """Without a card, chip_smoke.py exits non-zero, names the missing card
    and prints no result line."""
    if how == "main":
        with pytest.raises(SystemExit) as exit_:
            chip_smoke.main()
        assert exit_.value.code not in (0, None)
        assert "no CUDA device" in str(exit_.value.code)
    else:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0 and '"ok"' not in proc.stdout
        assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize(
    "call",
    ["compute_initial_conditions", "perturb_field", "compute_ionization_field",
     "brightness_temperature", "run_coeval", "interop", "run_lightcone",
     "compute_xray_source_field", "compute_fixed_halo_grid", "determine_halo_catalog",
     "compute_halo_grid", "perturb_halo_catalog", "setup_photon_cons", "run_global_evolution"],
)
def test_entry_points_default_to_cuda(no_cuda, call):
    """Called without device=, an entry point asks for the card and raises
    where there is none, instead of running on the CPU."""
    inp = t21.InputParameters(random_seed=1).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL")
    calls = {
        "compute_initial_conditions": lambda: t21.compute_initial_conditions(inp),
        "perturb_field": lambda: t21.perturb_field(8.0, inp, None),
        "compute_ionization_field": lambda: t21.compute_ionization_field(8.0, inp, None),
        "brightness_temperature": lambda: t21.brightness_temperature(inp, None, None),
        "run_coeval": lambda: t21.run_coeval(inp, 8.0),
        "interop": lambda: interop.perturbed_field_from_numpy({"density": np.zeros((2, 2, 2))}),
        "run_lightcone": lambda: t21.run_lightcone(inp.with_logspaced_redshifts(8.0, 10.0)),
        "compute_xray_source_field": lambda: t21.compute_xray_source_field(8.0, inp, []),
        "compute_fixed_halo_grid": lambda: compute_fixed_halo_grid(
            8.0, inp.evolve_input_structs(SOURCE_MODEL="L-INTEGRAL"), None),
        "determine_halo_catalog": lambda: t21.determine_halo_catalog(
            8.0, inp.evolve_input_structs(SOURCE_MODEL="CHMF-SAMPLER"), None),
        "compute_halo_grid": lambda: t21.compute_halo_grid(
            8.0, inp.evolve_input_structs(SOURCE_MODEL="CHMF-SAMPLER"), None),
        "perturb_halo_catalog": lambda: t21.perturb_halo_catalog(8.0, inp, None, None),
        "setup_photon_cons": lambda: t21.setup_photon_cons(
            inp.evolve_input_structs(PHOTON_CONS_TYPE="Z-PHOTONCONS")),
        "run_global_evolution": lambda: t21.run_global_evolution(inp),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[call]()


# options that once raised here and run since the minihalo slice, the
# fixed-grid source slice, the discrete-halo slice and the slice of the
# progenitor samplers, photon conservation and the non-integer perturb
RUN_ON_CPU = (
    dict(USE_TS_FLUCT=True, USE_MINI_HALOS=True),
    dict(USE_TS_FLUCT=True, RECOMB_MODEL="HOMOGENEOUS", SOURCE_MODEL="DEXM-ESF"),
    dict(USE_MINI_HALOS=True),
    dict(V_CB_MODEL="FLUCTS"),
    dict(SOURCE_MODEL="L-INTEGRAL"),
    dict(SOURCE_MODEL="CHMF-SAMPLER"),
    dict(IONISE_ENTIRE_SPHERE=True),
    dict(SOURCE_MODEL="CHMF-SAMPLER", SAMPLE_METHOD="PARTITION"),
    dict(SOURCE_MODEL="DEXM-ESF", SAMPLE_METHOD="BINARY-SPLIT"),
    dict(PHOTON_CONS_TYPE="Z-PHOTONCONS"),
    dict(DIM=20),
)


@pytest.mark.parametrize(
    "over",
    [
        dict(USE_TS_FLUCT=True, USE_MINI_HALOS=True),
        dict(USE_TS_FLUCT=True, RECOMB_MODEL="HOMOGENEOUS", SOURCE_MODEL="DEXM-ESF"),
        dict(USE_MINI_HALOS=True),
        dict(SOURCE_MODEL="L-INTEGRAL"),
        dict(SOURCE_MODEL="CHMF-SAMPLER"),
        dict(SOURCE_MODEL="CHMF-SAMPLER", SAMPLE_METHOD="PARTITION"),
        dict(SOURCE_MODEL="DEXM-ESF", SAMPLE_METHOD="BINARY-SPLIT"),
        dict(PHOTON_CONS_TYPE="Z-PHOTONCONS"),
        dict(DIM=20),
        dict(V_CB_MODEL="FLUCTS"),
        dict(IONISE_ENTIRE_SPHERE=True),
        dict(cache=True),
        dict(mesh=True),
    ],
    ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()),
)
def test_options_outside_the_slice_raise(over, tmp_path):
    """Every option that once raised here runs on the CPU and gives finite
    boxes: the minihalo and v_cb options (item 11), L-INTEGRAL (item 12),
    IONISE_ENTIRE_SPHERE (item 6), the halo samplers CHMF-SAMPLER and
    DEXM-ESF with every progenitor method (item 13; the PARTITION and
    BINARY-SPLIT cases down a node ladder, so that progenitors are sampled),
    Z-PHOTONCONS (item 14), a non-integer DIM/HII_DIM (item 5), the output
    cache (item 16, which writes the run's boxes) and a device mesh (item
    17: the sharded coeval on a gloo mesh of one rank, whose boxes are the
    whole boxes)."""
    inp = t21.InputParameters(random_seed=1).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL").evolve_input_structs(
        **{k: v for k, v in over.items() if k not in ("cache", "mesh")})
    if "SAMPLE_METHOD" in over:
        inp = inp.with_logspaced_redshifts(8.0, 12.0)
    if over in RUN_ON_CPU or "cache" in over:
        cache = t21.OutputCache(tmp_path) if "cache" in over else None
        out = t21.run_coeval(inp, 8.0, cache=cache, device="cpu")
        if cache is not None:
            assert cache.exists(t21.InitialConditions, inp)
            assert all(cache.exists(c, inp, 8.0)
                       for c in ("PerturbedField", "IonizedBox", "BrightnessTemp"))
        ion = out.ionized_box
        assert np.isfinite(ion.neutral_fraction.numpy()).all()
        assert np.isfinite(out.brightness_temperature.brightness_temp.numpy()).all()
        if inp.astro_options.USE_MINI_HALOS:
            assert float(ion.log10_Mturnover_MINI_ave) > 5.0
        if over.get("USE_TS_FLUCT"):
            assert np.isfinite(out.spin_temp.spin_temperature.numpy()).all()
            if inp.astro_options.USE_MINI_HALOS:
                assert np.isfinite(out.spin_temp.J_21_LW.numpy()).all()
        if over.get("SOURCE_MODEL") in ("L-INTEGRAL", "CHMF-SAMPLER", "DEXM-ESF"):
            assert np.isfinite(out.halobox.n_ion.numpy()).all()
            assert float(out.halobox.n_ion.max()) > 0.0
        if over.get("SOURCE_MODEL") in ("CHMF-SAMPLER", "DEXM-ESF"):
            assert float(out.halobox.count.sum()) > 0.0
        vcb = out.initial_conditions.lowres_vcb
        assert (vcb is not None) == (over.get("V_CB_MODEL") == "FLUCTS")
        if vcb is not None:
            assert vcb.shape == (8, 8, 8)
            assert float(vcb.min()) >= 0.0 and float(vcb.max()) > 0.0
        if over.get("PHOTON_CONS_TYPE"):
            assert t21.setup_photon_cons(inp, device="cpu").adjusted_redshift(8.0) < 8.0
        assert tuple(out.density.shape) == (8, 8, 8)
        return
    from _torch_parallel import one_rank_mesh

    from py21cmfast_torch.parallel.driver import run_sharded_coeval

    assert over == dict(mesh=True)
    with one_rank_mesh(tmp_path) as mesh:
        (out,) = run_sharded_coeval(inp, [8.0], mesh=mesh)
    ref = t21.run_coeval(inp, 8.0, device="cpu")
    assert tuple(out.density.shape) == (8, 8, 8)
    assert np.isfinite(out.brightness_temp.numpy()).all()
    assert abs(float(out.neutral_fraction.mean()) - float(ref.neutral_fraction.mean())) < 1e-3


def test_cache_and_node_scroll_raise(tmp_path):
    """A cache that is not an OutputCache raises, with and without a node
    ladder, before anything is computed; an OutputCache runs with both
    (tests/test_torch_io.py resumes from it).  The node scroll itself runs
    (tests/test_torch_scroll.py, with Lagrangian source boxes
    tests/test_torch_fixed_halos.py), and a mesh that is not a
    parallel.mesh.Mesh handed to its Ts step or to the XraySourceBox
    raises."""
    from py21cmfast_torch.models import spintemp as tspin

    inp = t21.InputParameters(random_seed=1).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL")
    ladder = inp.with_logspaced_redshifts(8.0, 12.0)
    with pytest.raises(TypeError, match="OutputCache"):
        t21.run_coeval(inp, 8.0, cache=object(), device="cpu")
    with pytest.raises(TypeError, match="OutputCache"):
        t21.run_coeval(ladder, 8.0, cache=object(), device="cpu")
    for run in (inp, ladder):
        cache = t21.OutputCache(tmp_path / str(len(run.node_redshifts)))
        t21.run_coeval(run, 8.0, cache=cache, device="cpu")
        assert cache.exists(t21.BrightnessTemp, run, 8.0)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        tspin.compute_spin_temperature(8.0, inp, None, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        t21.compute_xray_source_field(8.0, inp, [], mesh=object(), device="cpu")


def test_lightcone_cache_raises(tmp_path, monkeypatch):
    """generate_lightcone refuses a cache that is not an OutputCache before
    it computes anything; with an OutputCache its first node is written
    before it is yielded."""
    inp = t21.InputParameters(random_seed=1).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL").with_logspaced_redshifts(8.0, 10.0)
    from py21cmfast_torch.models import ics

    computed, original = [], ics.compute_initial_conditions
    monkeypatch.setattr(ics, "compute_initial_conditions",
                        lambda *a, **kw: computed.append(1) or original(*a, **kw))
    gen = t21.generate_lightcone(inp, cache=object(), device="cpu")
    with pytest.raises(TypeError, match="OutputCache"):
        next(gen)
    assert not computed
    cache = t21.OutputCache(tmp_path)
    gen = t21.generate_lightcone(inp, cache=cache, device="cpu")
    z, _, _ = next(gen)
    gen.close()
    assert computed and z == inp.node_redshifts[0]
    assert t21.RunCache(cache, inp).last_complete_node() == 0


@pytest.mark.parametrize(
    "over",
    [dict(SOURCE_MODEL="CHMF-SAMPLER", SAMPLE_METHOD="PARTITION"),
     dict(SOURCE_MODEL="CHMF-SAMPLER", SAMPLE_METHOD="BINARY-SPLIT"),
     dict(PHOTON_CONS_TYPE="F-PHOTONCONS"),
     dict(DIM=20)],
    ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()),
)
def test_slice_options_run_through_the_lightcone(over):
    """The progenitor samplers, a fitted photon-conservation correction and
    a non-integer DIM/HII_DIM through run_lightcone (3 nodes, 8^3): a cone
    with every slice finite and the global xH recorded at every node."""
    inp = t21.InputParameters(random_seed=1).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL", ZPRIME_STEP_FACTOR=1.2,
        Z_HEAT_MAX=12.0).evolve_input_structs(**over).with_logspaced_redshifts(8.0, 12.0)
    lc = t21.run_lightcone(inp, device="cpu")
    assert len(inp.node_redshifts) >= 3
    for name, cone in lc.lightcones.items():
        assert cone.shape[:2] == (8, 8) and bool(torch.isfinite(cone).all()), name
    xh = lc.global_quantities["neutral_fraction"]
    assert len(xh) == len(inp.node_redshifts) and np.all((0.0 <= xh) & (xh <= 1.0))
