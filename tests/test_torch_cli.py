"""The port's command line (`21cmfast-torch`, `python -m py21cmfast_torch`)
against the JAX package's, on the CPU.

  host commands  `template avail`, `template show`, `template create`, `run
                 params` and `predict` print exactly what the JAX package's
                 CLI prints (and write the same TOML);
  computing      `run coeval --device cpu` prints the means that run_coeval
                 gives; `run ics` writes the cache and skips on a second
                 call; `run lightcone --out` writes its HDF5 file; `dev
                 feature` writes its three plots (the runs cut to 8^3);
  entry          `python -m py21cmfast_torch template avail` exits 0;
  optional deps  with h5py and matplotlib hidden the package imports, and
                 the commands that need them raise an ImportError naming
                 them before computing anything;
  management     the storage estimates equal the JAX package's.
"""

import _torch_threads  # noqa: F401
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

import py21cmfast_torch as t21
from py21cmfast_torch import cli as tcli
from py21cmfast_torch import management as tman
from py21cmfast_tpu import cli as jcli
from py21cmfast_tpu import management as jman

REPO = Path(__file__).resolve().parent.parent
SMALL = ["-p", "HII_DIM=8", "-p", "DIM=16", "-p", "BOX_LEN=16", "-p", "R_BUBBLE_MAX=4"]


def _printed(main, argv, capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["template", "avail"],
    ["template", "show", "--template", "latest", "-p", "F_STAR10=-1.2"],
    ["template", "show", "--template", "simple+size-small", "--seed", "9"],
    ["run", "params", "--template", "latest"],
    ["run", "params", "-p", "USE_TS_FLUCT=true", "-p", "HII_DIM=64"],
    ["predict", "--template", "latest-discrete"],
    ["predict", "-p", "HII_DIM=256", "-p", "DIM=768", "-p", "USE_TS_FLUCT=true"],
], ids=lambda a: " ".join(a[:2]) + (f" {a[3]}" if len(a) > 3 else ""))
def test_host_commands_print_what_the_jax_cli_prints(argv, capsys):
    ref = _printed(jcli.main, argv, capsys)
    got = _printed(tcli.main, argv, capsys)
    assert got == ref and got.strip()


def test_template_create_writes_the_jax_toml(tmp_path, capsys):
    argv = ["template", "create", "--template", "simple", "-p", "HII_DIM=40"]
    _printed(jcli.main, argv + [str(tmp_path / "ref.toml")], capsys)
    out = _printed(tcli.main, argv + [str(tmp_path / "got.toml")], capsys)
    assert out == f"wrote {tmp_path / 'got.toml'}\n"
    assert (tmp_path / "got.toml").read_text() == (tmp_path / "ref.toml").read_text()


def test_run_coeval_prints_the_means_of_run_coeval(capsys):
    argv = ["run", "coeval", "--device", "cpu", "--seed", "3", "-z", "9", "8",
            "-p", "HII_DIM=12", "-p", "DIM=24", "-p", "BOX_LEN=24", "-p", "SOURCE_MODEL=E-INTEGRAL"]
    out = _printed(tcli.main, argv, capsys).splitlines()
    inputs = t21.InputParameters(random_seed=3).evolve_input_structs(
        HII_DIM=12, DIM=24, BOX_LEN=24, SOURCE_MODEL="E-INTEGRAL")
    ref = t21.run_coeval(inputs, [9.0, 8.0], device="cpu")
    want = [f"z={cv.redshift:7.3f}  <xH>={float(np.mean(cv.neutral_fraction.numpy())):.4f}  "
            f"<Tb>={float(np.mean(cv.brightness_temp.numpy())):8.3f} mK" for cv in ref]
    assert out == want


def test_run_ics_and_lightcone_write_their_files(tmp_path, capsys):
    import h5py

    cache = tmp_path / "cache"
    argv = ["run", "ics", "--device", "cpu", "--cache-dir", str(cache)] + SMALL
    assert _printed(tcli.main, argv, capsys) == f"saved initial conditions to {cache}\n"
    assert _printed(tcli.main, argv, capsys) == (
        f"initial conditions already exist in {cache}; skipping computation "
        "(--regenerate to override)\n")
    inputs = t21.InputParameters(random_seed=42).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16, R_BUBBLE_MAX=4)
    assert t21.OutputCache(cache).exists(t21.InitialConditions, inputs)

    out = tmp_path / "lc.h5"
    lc = tcli.main(["run", "lightcone", "--device", "cpu", "--min-z", "9", "--max-z", "11",
                    "--out", str(out), "-p", "SOURCE_MODEL=E-INTEGRAL"] + SMALL)
    lines = capsys.readouterr().out.splitlines()
    bt = lc.brightness_temp
    assert lines == [f"lightcone: shape={tuple(bt.shape)}, Tb range [{bt.min().item():.2f}, "
                     f"{bt.max().item():.2f}] mK", f"wrote {out}"]
    with h5py.File(out, "r") as f:
        np.testing.assert_array_equal(f["brightness_temp"][...], bt.numpy())
        np.testing.assert_array_equal(f["node_redshifts"][...], lc.node_redshifts)
        np.testing.assert_array_equal(f["global/neutral_fraction"][...],
                                      lc.global_quantities["neutral_fraction"])


def test_dev_feature_plots(tmp_path, monkeypatch, capsys):
    """`dev feature` runs the default and the changed lightcone (both cut to
    8^3 here) and writes the three pr_feature_*.pdf files."""
    build = tcli._build_inputs
    monkeypatch.setattr(tcli, "_build_inputs", lambda args: build(args).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, R_BUBBLE_MAX=4.0))
    _printed(tcli.main, ["dev", "feature", "--device", "cpu", "--template", "simple",
                         "--param", "HII_EFF_FACTOR=25", "--min-z", "9", "--max-z", "11",
                         "--n-ps-chunks", "2", "--outdir", str(tmp_path)], capsys)
    out = sorted(p.name for p in tmp_path.iterdir())
    assert out == ["pr_feature_history.pdf", "pr_feature_lightcone_2d_brightness_temp.pdf",
                   "pr_feature_power_history.pdf"]


def test_python_m_entry_point():
    proc = subprocess.run([sys.executable, "-m", "py21cmfast_torch", "template", "avail"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[0].startswith("defaults")


def test_without_h5py_and_matplotlib(tmp_path):
    """The package imports with h5py and matplotlib hidden; `run coeval
    --cache-dir`, `run ics` and `run lightcone --out` raise the h5py
    ImportError and `dev feature` matplotlib's before anything is computed
    (the drivers are replaced by a tripwire)."""
    code = f"""
import sys
sys.modules["h5py"] = None
sys.modules["matplotlib"] = None
import py21cmfast_torch
from py21cmfast_torch import cli
from py21cmfast_torch.drivers import coeval, lightcone
from py21cmfast_torch.models import ics

def tripwire(*a, **k):
    raise SystemExit("computed")

coeval.run_coeval = lightcone.run_lightcone = ics.compute_initial_conditions = tripwire
for argv, dep in (
        (["run", "coeval", "--cache-dir", {str(tmp_path)!r}, "-z", "8", "--device", "cpu"], "h5py"),
        (["run", "ics", "--cache-dir", {str(tmp_path)!r}, "--device", "cpu"], "h5py"),
        (["run", "lightcone", "--out", {str(tmp_path / "lc.h5")!r}, "--device", "cpu"], "h5py"),
        (["dev", "feature", "--device", "cpu"], "matplotlib")):
    try:
        cli.main(argv)
    except ImportError as e:
        assert dep in str(e), (argv, e)
    else:
        raise AssertionError(argv)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


@pytest.mark.parametrize("over", [dict(), dict(USE_TS_FLUCT=True, PERTURB_ALGORITHM="ZELDOVICH"),
                                  dict(SOURCE_MODEL="L-INTEGRAL"), dict(SOURCE_MODEL="CHMF-SAMPLER")],
                         ids=["defaults", "ts", "L-INTEGRAL", "sampler"])
def test_management_matches_jax(over):
    from py21cmfast_tpu.inputs import InputParameters as JInputParameters

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tinp = t21.InputParameters(random_seed=1).evolve_input_structs(
            HII_DIM=64, DIM=192, **over).with_logspaced_redshifts(6.0)
        jinp = JInputParameters(random_seed=1).evolve_input_structs(
            HII_DIM=64, DIM=192, **over).with_logspaced_redshifts(6.0)
    assert tman.get_expected_outputs(tinp) == jman.get_expected_outputs(jinp)
    assert tman.get_expected_sizes(tinp) == jman.get_expected_sizes(jinp)
    for n in (None, 10):
        assert tman.get_total_storage_size(tinp, n) == jman.get_total_storage_size(jinp, n) > 0
