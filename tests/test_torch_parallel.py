"""The port's multi-rank layer (py21cmfast_torch/parallel) against the JAX
package's sharded functions, on the CPU: the port on 2 and 4 gloo ranks
spawned by tests/_torch_parallel.py, the JAX package on `make_mesh(2)` and
`make_mesh(4)` of the virtual 8-device CPU mesh of tests/conftest.py, at
HII_DIM=16, DIM=32 (4 lowres rows a rank at p=4, whole strides of the
ratio 2).  Tolerances:

  the collectives                      exact (rank-stamped arrays)
  pfft.rfft3 / irfft3 / local_kmag     max-abs <= 1e-5 of the box's max,
                                       against JAX's pfft in shard_map and
                                       numpy's rfftn of the whole box
  build_sharded_lowres_ics (2LPT,      each field max-abs <= 1e-5 of its
  v_cb) from one white noise           max (float32 FFTs of two libraries);
                                       |v_cb|, the root of three squared
                                       components, 2e-5
  build_sharded_perturb                density and v_z max-abs <= 1e-4 of
                                       the std (float32 CIC sums in another
                                       order), the margin equal
  sharded_halo_grids, one catalog,     each grid max-abs <= 1e-5 of its max,
  with and without minihalos           the turnover means within 4 float32
                                       ulps of the exact mean of the JAX
                                       package's turnover grid (its own
                                       float32 mean of the sharded grid is
                                       2.4e-4 off here)
  the slab grid sampler core fed the   keep masks, counts and positions
  JAX package's draws                  identical, masses within 8e-6
  the progenitor partition and its     identical order
  gathered order
  each box mean taken over the ranks   at p=2, on fields whose slabs differ,
  (module 6 of the port)               the mesh value against the
                                       single-device port's: turnover means
                                       within 1e-6, grids max-abs <= 1e-5 of
                                       their max, xH share of flips <= 1e-3
  multihost.initialize                 one process, idempotent, (0, 1)
"""

import _torch_threads  # noqa: F401
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parallel import collect, result, start_ranks
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P
from test_torch_ics import port_inputs

import py21cmfast_torch as t21
from py21cmfast_torch.models import halos as th
from py21cmfast_tpu.inputs import InputParameters as JInputs
from py21cmfast_tpu.models import halos as jh
from py21cmfast_tpu.models import ics as jics
from py21cmfast_tpu.outputs import PerturbedHaloCatalog as JCatalog
from py21cmfast_tpu.parallel import halopaint as jhp
from py21cmfast_tpu.parallel import mesh as jmesh
from py21cmfast_tpu.parallel import perturb as jpert
from py21cmfast_tpu.parallel import pfft as jpfft
from py21cmfast_tpu.parallel import sampler as jsamp

REPO = Path(__file__).resolve().parent.parent
SIZE = dict(HII_DIM=16, DIM=32, BOX_LEN=32.0)
WORLDS = (2, 4)
Z_PERTURB = 9.0
Z_HALOS = 9.0
MASS_REL = 8e-6  # tests/test_torch_halos.py: 4 float32 ulps of ln M near 20


def _ics_inputs():
    return JInputs(random_seed=21).evolve_input_structs(
        **SIZE, SOURCE_MODEL="E-INTEGRAL", PERTURB_ALGORITHM="2LPT", USE_MINI_HALOS=True,
        V_CB_MODEL="FLUCTS", USE_TS_FLUCT=True, M_TURN=5.0)


def _halo_inputs(mini):
    over = dict(USE_MINI_HALOS=True, USE_TS_FLUCT=True, V_CB_MODEL="FLUCTS", M_TURN=5.0) if mini else {}
    return JInputs(random_seed=21).evolve_input_structs(
        HII_DIM=16, DIM=32, BOX_LEN=48.0, SOURCE_MODEL="CHMF-SAMPLER", SAMPLER_MIN_MASS=2e9, **over)


def _white(jinp):
    return np.random.default_rng(3).standard_normal(jinp.simulation_options.hires_shape).astype(
        np.float32)


def _synthetic_catalog(n=4000, box=48.0, seed=8):
    """Halos of 1e9.5-1e12 Msun anywhere in the box, some on the slab borders."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, size=(n, 3)).astype(np.float32)
    cell = box / 16
    pos[:64, 0] = (np.repeat(np.arange(0, 16, 2), 8) * cell + rng.uniform(-0.05, 0.05, 64)) % box
    return dict(redshift=np.float32(Z_HALOS),
                halo_masses=(10.0 ** rng.uniform(9.5, 12.0, n)).astype(np.float32),
                halo_coords=pos.astype(np.float32),
                star_rng=rng.standard_normal(n).astype(np.float32),
                sfr_rng=rng.standard_normal(n).astype(np.float32),
                xray_rng=rng.standard_normal(n).astype(np.float32))


def _prev_fields(seed=9):
    """Previous-box fields for the minihalo feedback: J_21_LW, Gamma12,
    z_reion (half the cells ionized) and |v_cb|."""
    rng = np.random.default_rng(seed)
    shape = (16, 16, 16)
    return dict(
        ts=dict(J_21_LW=rng.uniform(0.0, 2.0, shape).astype(np.float32)),
        ion=dict(ionisation_rate_G12=rng.uniform(0.0, 1.0, shape).astype(np.float32),
                 z_reion=np.where(rng.uniform(size=shape) > 0.5, 10.5, -1.0).astype(np.float32)),
        vcb=rng.uniform(5.0, 60.0, shape).astype(np.float32))


def _partition_catalog(seed=4):
    """Descendants spread over the box, at the slab borders, below 0 and
    at the box edge (48 Mpc, 16 cells)."""
    rng = np.random.default_rng(seed)
    n = 600
    x = rng.uniform(-1.0, 48.0, n)
    x[:40] = np.repeat(np.arange(0, 48, 6.0), 5)
    x[40:45] = 48.0
    pos = np.stack([x, rng.uniform(0, 48, n), rng.uniform(0, 48, n)], axis=1).astype(np.float32)
    return dict(redshift=np.float32(9.0), halo_masses=(10.0 ** rng.uniform(10, 12, n)).astype(
        np.float32), halo_coords=pos, star_rng=rng.standard_normal(n).astype(np.float32),
        sfr_rng=rng.standard_normal(n).astype(np.float32),
        xray_rng=rng.standard_normal(n).astype(np.float32))


def _box():
    return np.random.default_rng(0).standard_normal((16, 16, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every job of the port at each world size, one spawn a size."""
    ics_in = port_inputs(_ics_inputs())
    jobs = [
        ("collectives_job", ()),
        ("pfft_job", (_box(), (50.0, 50.0, 50.0))),
        ("ics_perturb_job", (ics_in, _white(_ics_inputs()), Z_PERTURB)),
        ("halopaint_job", (port_inputs(_halo_inputs(False)), Z_HALOS, _synthetic_catalog(), None)),
        ("halopaint_job", (port_inputs(_halo_inputs(True)), Z_HALOS, _synthetic_catalog(),
                           _prev_fields())),
        ("partition_job", (port_inputs(_halo_inputs(False)), _partition_catalog())),
    ]
    names = ["collectives", "pfft", "ics", "paint", "paint_mini", "partition"]
    runs = {p: start_ranks(p, jobs, tmp_path_factory.mktemp(f"ranks{p}")) for p in WORLDS}
    return {p: dict(zip(names, collect(run))) for p, run in runs.items()}


def _result(port, p, name):
    return result(port[p][name])


def _close(got, ref, name, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max()
    assert err <= rel * scale, f"{name}: max-abs {err:.3e} > {rel:.0e} x {scale:.3e}"


# ---------------------------------------------------------------------------
# the collectives and the slab FFT


@pytest.mark.parametrize("p", WORLDS)
def test_collectives(port, p):
    """all_to_all (tiled, both directions, complex), the ghost exchange
    (p=2: the left and right neighbour are one rank), the ragged gather and
    the reductions, on rank-stamped arrays."""
    c = _result(port, p, "collectives")
    xs = [np.arange(4 * p * 3 * p * 2, dtype=np.float32).reshape(4 * p, 3 * p, 2) + 1000 * r
          for r in range(p)]
    for r in range(p):
        np.testing.assert_array_equal(
            c["a"][r], np.concatenate([x[:, 3 * r:3 * r + 3] for x in xs], axis=0))
        np.testing.assert_array_equal(
            c["b"][r], np.concatenate([x[4 * r:4 * r + 4] for x in xs], axis=1))
        np.testing.assert_array_equal(c["c"][r].real, c["a"][r])
        np.testing.assert_array_equal(c["c"][r].imag, -c["a"][r])
        assert np.all(c["from_right"][r] == 10.0 * ((r + 1) % p) + 1)
        assert np.all(c["from_left"][r] == 10.0 * ((r - 1) % p) + 2)
    want_rows = np.concatenate([np.arange(r + 1) + 100 * r for r in range(p)])
    np.testing.assert_array_equal(c["rows"][:, 0], want_rows)
    assert c["sum"] == p * (p + 1) / 2 and c["max"] == [p - 1, 0.0]


def _jax_pfft(p, x, box_lens):
    m = jmesh.make_mesh(p)
    spec_x, spec_k = P(jmesh.GRID_AXIS, None, None), P(None, jmesh.GRID_AXIS, None)
    k = jax.jit(shard_map(jpfft.rfft3, mesh=m, in_specs=spec_x, out_specs=spec_k))(jnp.asarray(x))
    back = jax.jit(shard_map(lambda a: jpfft.irfft3(jpfft.rfft3(a), x.shape[2]), mesh=m,
                             in_specs=spec_x, out_specs=spec_x))(jnp.asarray(x))
    kmag = jax.jit(shard_map(lambda: jpfft.local_kmag(x.shape, box_lens, p), mesh=m, in_specs=(),
                             out_specs=spec_k))()
    return np.asarray(k), np.asarray(back), np.asarray(kmag)


@pytest.mark.parametrize("p", WORLDS)
def test_pfft_matches_jax_and_numpy(port, p):
    got = _result(port, p, "pfft")
    x = _box()
    k_j, back_j, kmag_j = _jax_pfft(p, x, (50.0, 50.0, 50.0))
    ref = np.fft.rfftn(x)
    for name, k in (("port", got["k"]), ("jax", k_j)):
        _close(k.real, ref.real, f"{name} rfft3 real")
        _close(k.imag, ref.imag, f"{name} rfft3 imag")
    _close(got["k"].real, k_j.real, "rfft3 port vs jax")
    _close(got["back"], x, "irfft3(rfft3(x))")
    _close(got["back"], back_j, "irfft3 port vs jax")
    _close(got["kmag"], kmag_j, "local_kmag")


# ---------------------------------------------------------------------------
# the sharded ICs and perturb


@pytest.fixture(scope="module")
def jax_ics():
    """JAX's build_sharded_lowres_ics and build_sharded_perturb at each p,
    from the white noise the port gets, with its driver's margin."""
    jinp = _ics_inputs()
    so, cosmo = jinp.simulation_options, jinp.cosmology
    ln_k, sqrtp = jics.power_amplitude_table(jinp)
    out = {}
    for p in WORLDS:
        m = jmesh.make_mesh(p)
        white = jax.device_put(jnp.asarray(_white(jinp)),
                               NamedSharding(m, P(jmesh.GRID_AXIS, None, None)))
        fn = jpert.build_sharded_lowres_ics(m, so.hires_shape, so.lowres_shape, so.box_lens,
                                            use_2lpt=True, with_vcb=True)
        f = [np.asarray(a) for a in fn(white, ln_k, sqrtp, *jics.vcb_ratio_table(jinp))]
        names = ["hires_density", "lowres_density", "vx", "vy", "vz", "vx_2LPT", "vy_2LPT",
                 "vz_2LPT", "lowres_vcb"]
        res = dict(zip(names, f))
        d_init = float(cosmo.dicke(so.INITIAL_REDSHIFT))
        D = float(cosmo.dicke(Z_PERTURB))
        max_disp = np.abs(res["vx"]).max() * (D - d_init) + np.abs(res["vx_2LPT"]).max() * abs(
            (-3.0 / 7.0) * (D**2 - d_init**2))
        margin = min(int(np.ceil(max_disp * 16 / 32.0)) + 3, 16 // p)
        pfn = jpert.build_sharded_perturb(m, so.hires_shape, so.lowres_shape, so.box_lens, margin,
                                          use_2lpt=True)
        args = [jax.device_put(jnp.asarray(res[k]), NamedSharding(m, P(jmesh.GRID_AXIS, None, None)))
                for k in names[:1] + names[2:8]]
        delta, v_z = pfn(*args, jnp.float32(d_init), jnp.float32(D - d_init),
                         jnp.float32((-3.0 / 7.0) * (D**2 - d_init**2)),
                         jnp.float32(16**3 / 32**3), jnp.float32(cosmo.ddicke_dt(Z_PERTURB) / D))
        res.update(density=np.asarray(delta), velocity_z=np.asarray(v_z), margin=margin)
        out[p] = res
    return out


ICS_FIELDS = ["hires_density", "lowres_density", "vx", "vy", "vz", "vx_2LPT", "vy_2LPT",
              "vz_2LPT", "lowres_vcb"]


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("name", ICS_FIELDS)
def test_sharded_ics_match_jax(port, jax_ics, p, name):
    got = _result(port, p, "ics")
    _close(got[name], jax_ics[p][name], f"{name} p={p}", 2e-5 if name == "lowres_vcb" else 1e-5)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("name", ["density", "velocity_z"])
def test_sharded_perturb_matches_jax(port, jax_ics, p, name):
    got = _result(port, p, "ics")
    assert got["margin"] == jax_ics[p]["margin"]
    ref = jax_ics[p][name]
    err = np.abs(got[name] - ref).max()
    assert err <= 1e-4 * ref.std(), f"{name} p={p}: max-abs {err:.3e} > 1e-4 x {ref.std():.3e}"


# ---------------------------------------------------------------------------
# halo painting, the slab sampler core and the partition


def _jax_prev(prev):
    from types import SimpleNamespace

    if prev is None:
        return dict(previous_spin_temp=None, previous_ionized_box=None, lowres_vcb=None)
    return dict(
        previous_spin_temp=SimpleNamespace(**{k: jnp.asarray(v) for k, v in prev["ts"].items()}),
        previous_ionized_box=SimpleNamespace(**{k: jnp.asarray(v) for k, v in prev["ion"].items()}),
        lowres_vcb=jnp.asarray(prev["vcb"]))


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("mini", [False, True], ids=["acg", "minihalos"])
def test_sharded_halo_grids_match_jax(port, p, mini):
    got = _result(port, p, "paint_mini" if mini else "paint")
    cat = _synthetic_catalog()
    pt = JCatalog(**{k: jnp.asarray(v) for k, v in cat.items()}, n_halos=jnp.int32(len(
        cat["halo_masses"])))
    ref = jhp.sharded_halo_grids(Z_HALOS, _halo_inputs(mini), pt, jmesh.make_mesh(p),
                                 **_jax_prev(_prev_fields() if mini else None))
    names = ["n_ion", "halo_sfr", "whalo_sfr", "halo_xray"] + (
        ["halo_sfr_mini", "halo_stars_mini"] if mini else [])
    for name in names:
        r = np.asarray(getattr(ref, name))
        assert r.max() > 0
        _close(got[name], r, f"{name} p={p}")
    if mini:
        from py21cmfast_tpu.models import halobox as jhb
        from py21cmfast_tpu.models import hmf as jhmf

        jinp, jp = _halo_inputs(True), _jax_prev(_prev_fields())
        grids = jhb._mcrit_grids(Z_HALOS, jinp, jhmf.set_scaling_constants(Z_HALOS, jinp),
                                 jp["previous_spin_temp"], jp["previous_ionized_box"],
                                 jp["lowres_vcb"])
        for key, grid in zip(("l10_a", "l10_m"), grids):
            exact = np.asarray(grid, np.float64).mean()
            assert abs(got[key] - exact) <= 4 * np.spacing(np.float32(exact)), (key, got[key], exact)
    else:
        assert got["l10_a"] == pytest.approx(float(ref.log10_Mcrit_ACG_ave), rel=1e-6)
        assert got["l10_m"] == pytest.approx(float(ref.log10_Mcrit_MCG_ave), rel=1e-6)


@pytest.mark.parametrize("p", WORLDS)
def test_progenitor_partition_order_matches_jax(port, p, monkeypatch):
    """The partition of a catalog into slabs (x < 0 to slab 0, the rest of
    the row to the last slab) and the gathered order, with the progenitor
    step replaced by the identity in both packages."""
    got = _result(port, p, "partition")
    cat = _partition_catalog()
    from py21cmfast_tpu.outputs import HaloCatalog as JHaloCatalog

    monkeypatch.setattr(jh, "_sample_progenitors", lambda z, inputs, sub, key: sub)
    prev = JHaloCatalog(**{k: jnp.asarray(v) for k, v in cat.items()},
                        n_halos=np.int32(len(cat["halo_masses"])))
    ref = jsamp.sample_progenitors_slabs(9.5, _halo_inputs(False), prev,
                                         devices=jax.devices()[:p])
    for name in ("halo_masses", "halo_coords", "star_rng"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("slab", [(0, 4), (4, 8), (12, 16)], ids=["first", "inner", "last"])
def test_slab_grid_sampler_core_matches_jax(slab):
    """sample_halo_grid on a slab (grid_shape=, origin_cells=): the port's
    chunk and collapsed-cell halos fed the JAX package's uniforms, Poisson
    counts and jitter, against its slab sample (global positions)."""
    jinp = _halo_inputs(False)
    tinp = port_inputs(jinp)
    delta = np.asarray(jics.compute_initial_conditions(
        jinp, initial_density=_grf(jinp)).lowres_density)
    x0, x1 = slab
    grid_shape = (x1 - x0, 16, 16)
    key = jax.random.fold_in(jax.random.PRNGKey(5), x0)
    ref_m, ref_p, total = jh.sample_halo_grid(
        9.0, jinp, jnp.asarray(delta[x0:x1]), key=key, grid_shape=grid_shape,
        origin_cells=(x0, 0, 0))
    total = int(total)
    h = th.grid_sampler_tables(9.0, tinp, delta[x0:x1], grid_shape=grid_shape,
                               origin_cells=(x0, 0, 0))
    n_cells, k_max = h["delta_z"].size, h["k_max"]
    assert n_cells * k_max < 2**22  # one chunk in both packages
    kc = jax.random.fold_in(key, 0)
    u = jax.random.uniform(kc, (n_cells, k_max), minval=1e-12, maxval=1.0)
    n_draw = jax.random.poisson(jax.random.fold_in(kc, 2), jnp.asarray(h["n_exp"], jnp.float32))
    jitter = jax.random.uniform(jax.random.fold_in(kc, 1), (n_cells, k_max, 3))
    m, pos = th._grid_chunk(tinp, h, torch.as_tensor(h["delta_z"].astype(np.float32)),
                            torch.as_tensor(h["inv_tab"].astype(np.float32)), 0,
                            torch.as_tensor(np.array(u)), torch.as_tensor(np.array(n_draw)),
                            torch.as_tensor(np.array(jitter)))
    cm, cp = th._collapsed_halos(tinp, h, "cpu")
    m, pos = torch.cat([m, cm]).numpy(), torch.cat([pos, cp]).numpy()
    assert len(m) == total > 100
    np.testing.assert_allclose(m, np.asarray(ref_m)[:total], rtol=MASS_REL, atol=0)
    np.testing.assert_allclose(pos, np.asarray(ref_p)[:total], rtol=0, atol=1e-6 * 3.0)
    cell = 48.0 / 16
    assert pos[:, 0].min() >= x0 * cell and pos[:, 0].max() < x1 * cell


def _grf(jinp):
    from test_torch_ics import numpy_grf

    return numpy_grf(jinp, seed=5)


# ---------------------------------------------------------------------------
# multihost


def test_multihost_initialize_single_process():
    """One process with no torchrun environment: initialize forms a world
    of one (gloo), a second call is a no-op, process_info is (0, 1), and a
    mesh of it is not sharded; run in a subprocess so that the test
    process never holds a process group."""
    code = (
        "import os\n"
        "for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT'):\n"
        "    os.environ.pop(k, None)\n"
        "from py21cmfast_torch.parallel import mesh, multihost\n"
        "from py21cmfast_torch.ops.gridops import GridOps\n"
        "assert multihost.process_info() == (0, 1) and not multihost.is_initialized()\n"
        "multihost.initialize(backend='gloo')\n"
        "multihost.initialize(backend='gloo')\n"
        "assert multihost.is_initialized() and multihost.process_info() == (0, 1)\n"
        "m = mesh.make_mesh(1, device='cpu')\n"
        "assert (m.rank, m.size, m.backend) == (0, 1, 'gloo') and not GridOps(m).sharded\n"
        "try:\n"
        "    mesh.make_mesh(2, device='cpu')\n"
        "except RuntimeError as e:\n"
        "    assert 'requested 2 ranks' in str(e)\n"
        "else:\n"
        "    raise AssertionError('a mesh larger than the world did not raise')\n"
        "multihost.shutdown()\n"
        "assert not multihost.is_initialized()\n"
        "print('MULTIHOST_OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(REPO), env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert "MULTIHOST_OK" in out.stdout, out.stderr[-2000:]


def test_nccl_needs_a_card():
    """Without a card the NCCL default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    code = (
        "from py21cmfast_torch.parallel import mesh\n"
        "try:\n"
        "    mesh.make_mesh()\n"
        "except RuntimeError as e:\n"
        "    assert 'CUDA' in str(e), e\n"
        "    print('RAISED')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(REPO))
    assert "RAISED" in out.stdout, out.stdout + out.stderr[-2000:]
