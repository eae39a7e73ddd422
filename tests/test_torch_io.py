"""The port's HDF5 files and output cache against the JAX package's, on the CPU.

  files      every output class written and read back by the port, every
             field equal; the files of each package read by the other with
             equal arrays and equal InputParameters;
  cache      one set of inputs gives one cache path in both packages;
             CacheConfig, RunCache's completeness and find_existing;
  resume     a 5-node USE_TS_FLUCT + INHOMOGENEOUS scroll at 8^3 run with a
             cache, its last two nodes deleted and run again: every field of
             every node equal to the uninterrupted run; the same chain
             written by the JAX package (from a hires density handed to
             both), its last two nodes deleted and resumed by the port: the
             recomputed nodes within the gates of tests/test_torch_scroll.py
             (global xH atol 5e-3, mean Tb rtol 5e-3 / atol 0.05, mean Ts and
             Tk within 1e-3 of the mean, every cell of Ts and Tk within 1e-4
             of its own value);
  lightcone  a lightcone interrupted after 2 nodes with a cache and a
             checkpoint, then resumed, equal to the uninterrupted one;
  device     every box the drivers read from the cache is asked for on the
             run's device.
One JAX chain in the file.
"""

import _torch_threads  # noqa: F401
import dataclasses
import shutil
import warnings

import numpy as np
import pytest
import torch
from test_torch_ics import numpy_grf, port_inputs

import py21cmfast_torch as t21
from py21cmfast_torch.drivers import coeval as tcoeval
from py21cmfast_torch.io import h5 as th5
from py21cmfast_torch.io.caching import CacheConfig, OutputCache, RunCache
from py21cmfast_torch.models import spintemp as tsp
from py21cmfast_tpu import outputs as jouts
from py21cmfast_tpu.drivers.coeval import generate_coeval as j_generate_coeval
from py21cmfast_tpu.inputs import InputParameters as JInputParameters
from py21cmfast_tpu.io import caching as jcaching
from py21cmfast_tpu.io import h5 as jh5
from py21cmfast_tpu.models import ics as jics

CHAIN = dict(HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL", USE_TS_FLUCT=True,
             RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=8.0, ZPRIME_STEP_FACTOR=1.3,
             Z_HEAT_MAX=20.0, N_STEP_TS=6)
Z_END = 8.0
FIELDS = {
    "perturbed_field": ("density", "velocity_z"),
    "ionized_box": ("neutral_fraction", "z_reion", "ionisation_rate_G12", "kinetic_temperature",
                    "cumulative_recombinations", "mean_free_path"),
    "spin_temp": ("spin_temperature", "kinetic_temp_neutral", "xray_ionised_fraction"),
    "brightness_temperature": ("brightness_temp", "tau_21"),
}


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def _chain_inputs(cls, seed=21):
    return _quiet(lambda: cls(random_seed=seed).evolve_input_structs(**CHAIN)
                  .with_logspaced_redshifts(Z_END))


@pytest.fixture(scope="module")
def tinp():
    return _chain_inputs(t21.InputParameters)


@pytest.fixture(scope="module")
def jinp():
    return _chain_inputs(JInputParameters)


# ---------------------------------------------------------------- the files


def _port_struct(name, rng):
    """A port struct of class `name` with every field filled."""
    cls = th5._OUTPUT_CLASSES[name]
    if name in th5._CATALOGS:
        n = 7
        t = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32))  # noqa: E731
        return cls(redshift=np.float32(9.5), halo_masses=t(n).abs() * 1e9, halo_coords=t(n, 3),
                   star_rng=t(n), sfr_rng=t(n), xray_rng=t(n), n_halos=n)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name == "redshift" or f.name.startswith(("mean_f_coll", "log10_")):
            kw[f.name] = np.float32(rng.uniform(5, 10))
        else:
            shape = ((3,) if f.name == "mean_log10_Mcrit_LW"
                     else (3, 4, 5, 6) if f.name.startswith("filtered_") else (4, 5, 6))
            kw[f.name] = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    return cls(**kw)


def _numpy_fields(struct):
    return {f.name: (v.detach().cpu().numpy() if isinstance(v := getattr(struct, f.name), torch.Tensor)
                     else None if v is None else np.asarray(v))
            for f in dataclasses.fields(struct)}


def _assert_same_fields(got: dict, ref: dict, ctx):
    assert sorted(got) == sorted(ref), ctx
    for k, r in ref.items():
        if r is None:
            assert got[k] is None, (ctx, k)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), r, err_msg=f"{ctx}.{k}")


@pytest.mark.parametrize("name", sorted(th5._OUTPUT_CLASSES))
def test_h5_round_trip_keeps_every_field(tmp_path, tinp, name):
    box = _port_struct(name, np.random.default_rng(3))
    path = t21.write_output_to_hdf5(box, tmp_path / "box.h5", inputs=tinp)
    got, inputs = th5.read_output_from_hdf5(path, device="cpu")
    assert type(got) is type(box)
    _assert_same_fields(_numpy_fields(got), _numpy_fields(box), name)
    for f in dataclasses.fields(box):
        v = getattr(got, f.name)
        assert (isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.device.type == "cpu"
                or isinstance(v, (np.float32, int))), (f.name, type(v))
    assert inputs.full_hash == tinp.full_hash
    assert type(t21.read_output_struct(path, type(box), device="cpu")) is type(box)
    with pytest.raises(ValueError, match="requested"):
        t21.read_output_struct(path, t21.TsBox if name != "TsBox" else t21.HaloBox, device="cpu")
    assert t21.read_inputs(path).full_hash == tinp.full_hash


@pytest.mark.parametrize("name", sorted(th5._OUTPUT_CLASSES))
def test_port_file_reads_in_jax(tmp_path, tinp, jinp, name):
    box = _port_struct(name, np.random.default_rng(4))
    path = th5.write_output_to_hdf5(box, tmp_path / "box.h5", inputs=tinp)
    got, inputs = jh5.read_output_from_hdf5(path)
    assert type(got).__name__ == name
    _assert_same_fields(_numpy_fields(got), _numpy_fields(box), name)
    assert inputs.full_hash == jinp.full_hash == tinp.full_hash
    assert jh5.read_inputs(path).full_hash == tinp.full_hash


@pytest.mark.parametrize("name", sorted(th5._OUTPUT_CLASSES))
def test_jax_file_reads_in_port(tmp_path, tinp, jinp, name):
    arrays = _numpy_fields(_port_struct(name, np.random.default_rng(5)))
    if name in th5._CATALOGS:
        # the JAX package's catalogs are padded beyond n_halos
        arrays = {k: (np.concatenate([v, np.zeros((3,) + v.shape[1:], v.dtype)]) if np.ndim(v) else v)
                  for k, v in arrays.items()}
        arrays["n_halos"] = np.int32(7)
    path = jh5.write_output_to_hdf5(getattr(jouts, name)(**arrays), tmp_path / "box.h5", inputs=jinp)
    got, inputs = th5.read_output_from_hdf5(path, device="cpu")
    assert type(got).__name__ == name
    if name in th5._CATALOGS:
        arrays = {k: (v[:7] if np.ndim(v) else v) for k, v in arrays.items()}
        arrays["n_halos"] = np.asarray(7)
    _assert_same_fields(_numpy_fields(got), arrays, name)
    assert inputs.full_hash == tinp.full_hash
    assert th5.read_inputs(path).full_hash == tinp.full_hash


def test_without_h5py_the_files_raise_naming_it(tmp_path, tinp, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    box = _port_struct("BrightnessTemp", np.random.default_rng(6))
    with pytest.raises(ImportError, match="h5py"):
        th5.write_output_to_hdf5(box, tmp_path / "box.h5", inputs=tinp)
    with pytest.raises(ImportError, match="h5py"):
        t21.run_coeval(tinp, Z_END, cache=OutputCache(tmp_path), device="cpu")


# ---------------------------------------------------------------- the cache


@pytest.mark.parametrize("name, z", [("InitialConditions", None), ("PerturbedField", 8.0),
                                     ("IonizedBox", 12.52), ("TsBox", 24.7049)])
def test_cache_path_is_the_same_in_both_packages(tmp_path, tinp, jinp, name, z):
    got = OutputCache(tmp_path)._path(name, tinp, z)
    ref = jcaching.OutputCache(tmp_path)._path(name, jinp, z)
    assert str(got) == str(ref)
    assert got.name == f"{name}.h5" and str(tinp.random_seed) in got.parts


def test_cache_config():
    c = CacheConfig()
    assert all(c.writes(n) for n in th5._OUTPUT_CLASSES)
    off = CacheConfig.off()
    assert not any(off.writes(n) for n in th5._OUTPUT_CLASSES)
    assert not CacheConfig(spin_temp=False).writes("XraySourceBox")
    assert CacheConfig(spin_temp=False).writes("IonizedBox")


@pytest.mark.parametrize("over", [dict(), dict(USE_TS_FLUCT=False), dict(SOURCE_MODEL="CHMF-SAMPLER")],
                         ids=["ts", "no-ts", "sampler"])
def test_run_cache_completeness_and_find_existing(tmp_path, tinp, jinp, over):
    tinp, jinp = (_quiet(i.evolve_input_structs, **over) for i in (tinp, jinp))
    cache = OutputCache(tmp_path)
    rc = RunCache(cache, tinp)
    assert rc.required_classes() == jcaching.RunCache(jcaching.OutputCache(tmp_path),
                                                      jinp).required_classes()
    assert rc.last_complete_node() == -1
    rng = np.random.default_rng(7)
    nodes = tinp.node_redshifts
    for z in nodes[:2]:
        for name in rc.required_classes():
            cache.write(_port_struct(name, rng), tinp, z)
    cache.write(_port_struct("InitialConditions", rng), tinp)
    cache.write(_port_struct("PerturbedField", rng), tinp, nodes[3])  # an incomplete node
    assert rc.last_complete_node() == 1
    assert rc.is_complete_at(nodes[1]) and not rc.is_complete_at(nodes[3])
    want = {("InitialConditions", None), ("PerturbedField", round(nodes[3], 5))}
    want |= {(n, round(z, 5)) for z in nodes[:2] for n in rc.required_classes()}
    assert set(cache.find_existing(tinp)) == want
    assert set(jcaching.OutputCache(tmp_path).find_existing(jinp)) == want
    loaded = rc.load_at(nodes[0], device="cpu")
    assert sorted(loaded) == sorted(rc.required_classes())
    assert cache.read("PerturbedField", tinp, nodes[2], device="cpu") is None


# ---------------------------------------------------------------- resume


def _node_fields(cv):
    out = {"redshift": cv.redshift}
    for struct, names in FIELDS.items():
        box = getattr(cv, struct)
        for n in names:
            v = getattr(box, n)
            out[f"{struct}.{n}"] = None if v is None else np.asarray(
                v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
    return out


def _delete_nodes(cache, inputs, zs):
    for z in zs:
        d = cache._path("PerturbedField", inputs, z).parent
        assert d.exists()
        shutil.rmtree(d)


@pytest.fixture
def counted(monkeypatch):
    """Counts generate_coeval's perturbs, and records for each Ts step's
    SFRD tables whether a prefetched build was waiting for them."""
    log = {"perturb": [], "prefetched": []}
    perturb_field = tcoeval.perturb.perturb_field
    tables_for = tsp._sfrd_tables_for

    def perturb(z, *a, **kw):
        log["perturb"].append(z)
        return perturb_field(z, *a, **kw)

    def tables(zp, inputs, *a, **kw):
        log["prefetched"].append((zp, (round(float(zp), 9), inputs.full_hash) in tsp._SFRD_PREFETCH["futs"]))
        return tables_for(zp, inputs, *a, **kw)

    monkeypatch.setattr(tcoeval.perturb, "perturb_field", perturb)
    monkeypatch.setattr(tsp, "_sfrd_tables_for", tables)
    return log


def test_resumed_scroll_equals_the_uninterrupted_run(tmp_path, tinp, counted):
    nodes = tinp.node_redshifts
    assert len(nodes) == 5
    cache = OutputCache(tmp_path)
    full = [_node_fields(cv) for cv in t21.generate_coeval(tinp, cache=cache, device="cpu")]
    assert RunCache(cache, tinp).last_complete_node() == 4
    assert cache.exists("InitialConditions", tinp)
    _delete_nodes(cache, tinp, nodes[3:])
    assert RunCache(cache, tinp).last_complete_node() == 2
    counted["perturb"].clear()
    counted["prefetched"].clear()
    resumed = [_node_fields(cv) for cv in t21.generate_coeval(tinp, cache=cache, device="cpu")]
    assert counted["perturb"] == list(nodes[3:])
    # no node before the first computed one prefetched its tables: they are
    # built as the Ts step asks; the next node's were prefetched
    assert counted["prefetched"] == [(nodes[3], False), (nodes[4], True)]
    assert [r["redshift"] for r in resumed] == list(nodes)
    for got, ref in zip(resumed, full):
        _assert_same_fields(got, ref, f"z={ref['redshift']}")
    # regenerate: everything recomputed, the cache rewritten
    counted["perturb"].clear()
    again = list(t21.generate_coeval(tinp, [Z_END], cache=cache, regenerate=True, device="cpu"))
    assert counted["perturb"] == list(nodes)
    _assert_same_fields(_node_fields(again[-1]), full[-1], "regenerate")


def test_port_resumes_the_jax_package_cache(tmp_path, tinp, jinp):
    """The JAX package writes the chain's cache (its ICs from a numpy
    density); its last two nodes are deleted and the port resumes from the
    rest, its ICs read from that cache too."""
    dens = numpy_grf(jinp, seed=5)
    j_ics = jics.compute_initial_conditions(jinp, initial_density=dens)
    jcache = jcaching.OutputCache(tmp_path)
    jcache.write(j_ics, jinp)
    ref = [_quiet(lambda cv=cv: {
        "redshift": cv.redshift, "xh": np.asarray(cv.neutral_fraction), "tb": np.asarray(cv.brightness_temp),
        "ts": np.asarray(cv.spin_temp.spin_temperature),
        "tk": np.asarray(cv.spin_temp.kinetic_temp_neutral)})
        for cv in j_generate_coeval(jinp, initial_conditions=j_ics, cache=jcache)]
    nodes = tinp.node_redshifts
    assert [r["redshift"] for r in ref] == list(nodes)
    cache = OutputCache(tmp_path)
    _delete_nodes(cache, tinp, nodes[3:])
    got = list(t21.generate_coeval(tinp, cache=cache, device="cpu"))
    np.testing.assert_array_equal(got[0].initial_conditions.lowres_density.numpy(),
                                  np.asarray(j_ics.lowres_density))
    for cv, r in zip(got, ref):
        xh, tb = cv.neutral_fraction.numpy(), cv.brightness_temp.numpy()
        ts, tk = cv.spin_temp.spin_temperature.numpy(), cv.spin_temp.kinetic_temp_neutral.numpy()
        if cv.redshift in nodes[:3]:
            for a, b in ((xh, r["xh"]), (tb, r["tb"]), (ts, r["ts"]), (tk, r["tk"])):
                np.testing.assert_array_equal(a, b)
            continue
        np.testing.assert_allclose(xh.mean(), r["xh"].mean(), atol=5e-3)
        np.testing.assert_allclose(tb.mean(), r["tb"].mean(), rtol=5e-3, atol=0.05)
        for a, b, name in ((ts, r["ts"], "Ts"), (tk, r["tk"], "Tk")):
            assert abs(a.mean() - b.mean()) <= 1e-3 * abs(b.mean()), (cv.redshift, name)
            assert np.all(np.abs(a - b) <= 1e-4 * np.abs(b)), (cv.redshift, name)


def test_lightcone_resumes_from_cache_and_checkpoint(tmp_path):
    inp = _quiet(lambda: t21.InputParameters(random_seed=22).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL", ZPRIME_STEP_FACTOR=1.4,
    ).with_logspaced_redshifts(8.0, 12.0))
    ckpt = tmp_path / "lc_ckpt.h5"
    cache = OutputCache(tmp_path / "cache")
    full = t21.run_lightcone(inp, apply_rsds=False, device="cpu")

    gen = t21.generate_lightcone(inp, apply_rsds=False, cache=cache, checkpoint_path=ckpt,
                                 device="cpu")
    for k, _ in enumerate(gen):
        if k >= 1:
            break
    gen.close()
    assert ckpt.exists()
    assert RunCache(cache, inp).last_complete_node() == 1

    resumed = t21.run_lightcone(inp, apply_rsds=False, cache=cache, checkpoint_path=ckpt,
                                device="cpu")
    assert RunCache(cache, inp).last_complete_node() == len(inp.node_redshifts) - 1
    for q, cone in full.lightcones.items():
        np.testing.assert_array_equal(resumed.lightcones[q].numpy(), cone.numpy(), err_msg=q)
    for q, vals in full.global_quantities.items():
        np.testing.assert_array_equal(resumed.global_quantities[q], vals, err_msg=q)


class _SpyCache(OutputCache):
    """An OutputCache that records the device each read is asked for."""

    def __init__(self, direc):
        super().__init__(direc)
        self.devices = []

    def read(self, cls, inputs, redshift=None, *, device="cuda"):
        self.devices.append((cls if isinstance(cls, str) else cls.__name__, device))
        return super().read(cls, inputs, redshift, device=device)


def test_every_cached_box_is_read_onto_the_run_device(tmp_path, tinp):
    spy = _SpyCache(tmp_path)
    list(t21.generate_coeval(tinp, [Z_END], cache=spy, device="cpu"))
    assert [c for c, _ in spy.devices] == ["InitialConditions"]
    spy.devices.clear()
    out = list(t21.generate_coeval(tinp, [Z_END], cache=spy, device=torch.device("cpu")))
    names = {c for c, _ in spy.devices}
    assert {"InitialConditions", "PerturbedField", "IonizedBox", "TsBox", "BrightnessTemp"} <= names
    assert all(torch.device(d) == torch.device("cpu") for _, d in spy.devices), spy.devices
    assert out[-1].brightness_temp.device.type == "cpu"


def test_cache_must_be_an_output_cache(tinp):
    with pytest.raises(TypeError, match="OutputCache"):
        t21.run_coeval(tinp, Z_END, cache=object(), device="cpu")
