"""The port's discrete halos (DexM, the CHMF grid sampler, mass- and
number-limited progenitors, the perturbed halo catalog and the sampled
HaloBox) against the JAX package, at golden size (HII_DIM=24, DIM=72,
BOX_LEN=36, ZPRIME_STEP_FACTOR=1.25, Z_HEAT_MAX=25, R_BUBBLE_MAX=15, 5 nodes
from z=27.08 to 10.5), on the CPU.  One JAX chain: the "latest-discrete"
template's lightcone (CHMF-SAMPLER, USE_TS_FLUCT, INHOMOGENEOUS), both
packages from one shared numpy hires density, the port handed the JAX
package's catalog at every node; the unit tests take their inputs from it.

The random steps are held with the JAX package's own draws, rebuilt here from
the `fold_in` keys it uses and fed to the port's deterministic cores (or
handed to the port's sampler in place of its generator's).  Tolerances:

  _dexm_scan (16^3 / 32^3, JAX's      the halo grid and in_halo identical;
  strata), the lowres exclusion       the exclusion mask identical
  grid sampler core, _fix_mass_keep,  the keep masks, halo counts, order,
  the progenitor cores and the whole  positions and property draws
  progenitor step (MASS- and          identical; masses within 8e-6 of
  NUMBER-LIMITED, whole and in        their value (the inverse-CMF gather
  chunks of descendants)              gives ln M ~ 20, whose float32 ulp is
                                      1.9e-6 in M; torch's and XLA's float32
                                      log(u) differ by an ulp, which moves
                                      ln M by up to 3 of its ulps)
  perturb_halo_catalog                positions within 1e-5 Mpc
  halo_properties                     each property within 1e-6 of its value
  compute_halo_grid, with and         each grid max-abs <= 1e-5 of its max;
  without minihalos, with its         the turnover means within 4 float32
  sub-sampler grids                   ulps of the exact mean of the grid;
                                      the halo count grid exactly
  compute_fixed_halo_grid(m_max)      each grid max-abs <= 1e-5 of its max
  interp_halo_boxes                   each grid max-abs <= 1e-6 of its max
  the port's own sampler, from a      the grid count within 10% of the
  torch generator                     expected count over 4096 cells; the
                                      MASS-LIMITED progenitor mass within 3%
                                      of the expected (HALOMASS_CORRECTION x
                                      the collapsed) mass; the counts falling
                                      by mass octave
  the latest-discrete lightcone       per node global xH atol 5e-3 and the
                                      HaloBox grids 1e-5 of their max; the
                                      golden gates (tests/test_golden.py:
                                      32-45) on the cone, every cone at most
                                      1e-3 of the cells off by 1e-3 max, the
                                      global quantities 1e-3 of max|Tb|
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ics import GOLDEN, numpy_grf, port_inputs
from test_torch_lightcone import assert_cone_share
from test_torch_minihalos import _close, _gates, _numpy

import py21cmfast_torch as t21
from py21cmfast_torch import interop
from py21cmfast_torch.models import halobox as thb
from py21cmfast_torch.models import halos as th
from py21cmfast_torch.models import hmf as thmf
from py21cmfast_tpu import outputs as jout
from py21cmfast_tpu.drivers.lightcone import generate_lightcone as j_generate_lightcone
from py21cmfast_tpu.drivers.single_field import interp_halo_boxes as j_interp_halo_boxes
from py21cmfast_tpu.inputs import InputParameters as JInputs
from py21cmfast_tpu.models import halobox as jhb
from py21cmfast_tpu.models import halos as jh
from py21cmfast_tpu.models import hmf as jhmf
from py21cmfast_tpu.models import ics as jics

SIZE = {**{k: v for k, v in GOLDEN.items() if k != "SOURCE_MODEL"}, "R_BUBBLE_MAX": 15.0}
K_MAX = th.PROGENITOR_K_MAX
MASS_REL = 8e-6  # see the docstring: 4 float32 ulps of ln M near 20


def jax_inputs(**over):
    return JInputs.from_template("latest-discrete", random_seed=1234).evolve_input_structs(
        **SIZE, **over).with_logspaced_redshifts(10.5, 25.0)


def _jstruct(cls, d):
    return cls(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) and v.ndim else v)
                  for k, v in d.items() if k in cls.__dataclass_fields__})


def _jkey(seed, z):
    """The key determine_halo_catalog folds for a snapshot (halos.py:790-791)."""
    return jax.random.fold_in(jax.random.PRNGKey(seed), int(z * 100))


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def chain():
    """The latest-discrete lightcone in both packages from one density, the
    port handed the JAX package's catalog at every node; every node's boxes
    as numpy, and the JAX catalogs."""
    jinp = jax_inputs()
    tinp = port_inputs(jinp)
    mo = tinp.matter_options
    assert mo.SOURCE_MODEL == "CHMF-SAMPLER" and mo.SAMPLE_METHOD == "MASS-LIMITED"
    assert tinp.astro_options.USE_TS_FLUCT and len(tinp.node_redshifts) == 5
    dens = numpy_grf(jinp, seed=5)
    j_ics = jics.compute_initial_conditions(jinp, initial_density=dens)
    t_ics = t21.compute_initial_conditions(tinp, initial_density=dens, device="cpu")
    catalogs = {}

    def record(z, *a, **kw):
        cat = j_determine(z, *a, **kw)
        catalogs[round(float(z), 6)] = _numpy(cat)
        return cat

    def handed(z, inputs, ics, previous_catalog=None, generator=None, *, device):
        return interop.halo_catalog_from_numpy(catalogs[round(float(z), 6)], device)

    j_determine = jh.determine_halo_catalog
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jh, "determine_halo_catalog", record)
        mp.setattr(th, "determine_halo_catalog", handed)
        for name, gen in (
            ("jax", j_generate_lightcone(jinp, initial_conditions=j_ics)),
            ("port", t21.generate_lightcone(tinp, initial_conditions=t_ics, device="cpu")),
        ):
            nodes = []
            for z, cv, lc in gen:
                if z is not None:
                    nodes.append(dict(z=float(cv.redshift), pf=_numpy(cv.perturbed_field),
                                      ion=_numpy(cv.ionized_box), ts=_numpy(cv.spin_temp),
                                      hb=_numpy(cv.halobox)))
            runs[name] = dict(nodes=nodes, lc=lc)
    for n in runs["jax"]["nodes"]:
        n["cat"] = catalogs[round(n["z"], 6)]
    return dict(jinp=jinp, tinp=tinp, j_ics=_numpy(j_ics), t_ics=t_ics, **runs)


def _node(chain, i):
    return chain["jax"]["nodes"][i]


# ---------------------------------------------------------------------------
# DexM


def test_dexm_scan_matches_jax():
    """_dexm_scan at 16^3 / 32^3 (z=6, 63 centres) with the JAX package's
    stratum grid; then the lowres exclusion of the port's catalog step."""
    jinp = JInputs(random_seed=1234).evolve_input_structs(
        HII_DIM=16, DIM=32, BOX_LEN=32.0, SOURCE_MODEL="CHMF-SAMPLER")
    tinp = port_inputs(jinp)
    dens = numpy_grf(jinp, seed=5)
    j_ics = jics.compute_initial_conditions(jinp, initial_density=dens)
    t_ics = t21.compute_initial_conditions(tinp, initial_density=dens, device="cpu")
    so = jinp.simulation_options
    strata = jax.random.randint(jax.random.PRNGKey(jinp.random_seed ^ 0x0DE3), so.hires_shape,
                                0, th.DEXM_SAME_LEVEL_STRATA, dtype=jnp.uint8)
    ref_grid, ref_in = (np.asarray(a) for a in jh.dexm_halo_grid(6.0, jinp, j_ics))
    grid, in_halo = th.dexm_halo_grid(6.0, tinp, t_ics, stratum_grid=_t(strata), device="cpu")
    assert (ref_grid > 0).sum() > 50 and ref_in.sum() > (ref_grid > 0).sum()
    np.testing.assert_array_equal(grid.numpy(), ref_grid)
    np.testing.assert_array_equal(in_halo.numpy(), ref_in)
    masses, pos, excl = th._dexm_catalog(tinp, grid, in_halo)
    np.testing.assert_array_equal(masses, ref_grid[np.nonzero(ref_grid)])
    np.testing.assert_array_equal(
        excl, ref_in.reshape(16, 2, 16, 2, 16, 2).mean(axis=(1, 3, 5)) > 0.5)
    assert excl.any() and pos.shape == (len(masses), 3)


# ---------------------------------------------------------------------------
# the grid sampler and the progenitors, with the JAX package's draws


def _excl(chain):
    """The chain's lowest node: the JAX DexM exclusion mask."""
    jinp = chain["jinp"]
    j_ics = _jstruct(jout.InitialConditions, chain["j_ics"])
    _, in_halo = jh.dexm_halo_grid(10.5, jinp, j_ics)
    return np.asarray(in_halo).reshape(24, 3, 24, 3, 24, 3).mean(axis=(1, 3, 5)) > 0.5


def test_grid_sampler_core_matches_jax(chain):
    """sample_halo_grid at z=10.5 from the chain's JAX ICs: the port's chunk
    and collapsed-cell halos, fed the JAX package's uniforms, Poisson
    counts and jitter, against its compacted buffer."""
    jinp, tinp = chain["jinp"], chain["tinp"]
    delta = chain["j_ics"]["lowres_density"]
    excl = _excl(chain)
    key = _jkey(1234, 10.5)
    ref_m, ref_p, total = jh.sample_halo_grid(10.5, jinp, jnp.asarray(delta), exclude_mask=excl,
                                              key=key)
    total = int(total)
    h = th.grid_sampler_tables(10.5, tinp, delta, excl)
    n_cells, k_max = h["delta_z"].size, h["k_max"]
    assert n_cells * k_max < 2**22  # one chunk in both packages
    kc = jax.random.fold_in(key, 0)
    u = jax.random.uniform(kc, (n_cells, k_max), minval=1e-12, maxval=1.0)
    n_draw = jax.random.poisson(jax.random.fold_in(kc, 2), jnp.asarray(h["n_exp"], jnp.float32))
    jitter = jax.random.uniform(jax.random.fold_in(kc, 1), (n_cells, k_max, 3))
    m, p = th._grid_chunk(tinp, h, _t(h["delta_z"].astype(np.float32)),
                          _t(h["inv_tab"].astype(np.float32)), 0, _t(u), _t(n_draw), _t(jitter))
    cm, cp = th._collapsed_halos(tinp, h, "cpu")
    m, p = torch.cat([m, cm]).numpy(), torch.cat([p, cp]).numpy()
    assert len(m) == total > 50000
    np.testing.assert_allclose(m, np.asarray(ref_m)[:total], rtol=MASS_REL, atol=0)
    cell = jinp.simulation_options.box_len / 24
    np.testing.assert_allclose(p, np.asarray(ref_p)[:total], rtol=0, atol=1e-6 * cell)
    assert abs(total - h["n_expected"]) < 5 * np.sqrt(h["n_expected"])


def _fix_mass_inputs(seed=3, B=512):
    """Random (B, K) draws and targets: rows that cross their target, rows
    that never do (a target above the sum), all-zero rows and zero targets."""
    rng = np.random.default_rng(seed)
    m = np.exp(rng.uniform(np.log(1e8), np.log(1e11), (B, K_MAX))).astype(np.float32)
    tgt = (m.sum(axis=1) * rng.uniform(0.0, 0.6, B)).astype(np.float32)
    tgt[::7] = m[::7].sum(axis=1) * 2
    m[3::11] = 0.0
    tgt[5::13] = 0.0
    return m, tgt


def test_fix_mass_keep_matches_jax():
    m, tgt = _fix_mass_inputs()
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jh._fix_mass_keep(jnp.asarray(m), jnp.asarray(tgt), key))
    k1, k2 = jax.random.split(key)
    sel = jax.random.bernoulli(k1, 0.5, (m.shape[0],))
    u = jax.random.uniform(k2, m.shape)
    got = th._fix_mass_keep(_t(m), _t(tgt), _t(sel), _t(u)).numpy()
    np.testing.assert_array_equal(got, ref)
    total = (m * got).sum(axis=1)
    crossed = m.sum(axis=1) > tgt
    assert (~crossed).sum() > 50 and got[~crossed].all()  # never-crossing rows keep all
    assert not got[(tgt == 0) & crossed].any()  # a zero target keeps nothing
    assert 0 < got.sum() < got.size
    assert np.all(total[crossed] <= tgt[crossed] + m.max(axis=1)[crossed])


def _descendants(chain):
    """The chain's lowest-node catalog as the JAX package's core inputs."""
    cat = _node(chain, -1)["cat"]
    tinp = chain["tinp"]
    h = th.progenitor_tables(12.0, tinp, 10.5, float(cat["halo_masses"].max()))
    cond_t, m_tgt, n_exp, rare = th._descendant_conditions(tinp, h, _t(cat["halo_masses"]))
    return (h["inv_tab"].astype(np.float32), cond_t.float().numpy(), m_tgt.float().numpy(),
            n_exp.float().numpy())


@pytest.mark.parametrize("chunks", [1, 3], ids=["whole", "3-chunks"])
@pytest.mark.parametrize("method", ["MASS-LIMITED", "NUMBER-LIMITED"])
def test_progenitor_draws_match_jax(chain, method, chunks):
    """_progenitor_draws on the chain's 93k descendants with the JAX
    package's draws, whole and split into chunks of descendants."""
    inv, cond_t, m_tgt, n_exp = _descendants(chain)
    so = chain["tinp"].simulation_options
    n = len(cond_t)
    key = jax.random.PRNGKey(5)
    k13 = jax.random.fold_in(key, 13)
    u = jax.random.uniform(key, (n, K_MAX), minval=1e-12, maxval=1.0)
    number = method == "NUMBER-LIMITED"
    ref_m, ref_keep = (np.asarray(a) for a in jh._progenitor_draws(
        jnp.asarray(cond_t), jnp.asarray(m_tgt), u, u, jnp.asarray(inv),
        jnp.float32(so.MIN_LOGPROB), jnp.float32(so.SAMPLER_MIN_MASS),
        n_exp=jnp.asarray(n_exp), key=k13, number_limited=number))
    if number:
        draws = dict(n_draw=_t(jax.random.poisson(k13, jnp.asarray(n_exp))))
    else:
        k1, k2 = jax.random.split(jax.random.fold_in(k13, 5))
        draws = dict(sel=_t(jax.random.bernoulli(k1, 0.5, (n,))),
                     u_fix=_t(jax.random.uniform(k2, (n, K_MAX))))
    draws["u"] = _t(u)
    out = []
    for rows in np.array_split(np.arange(n), chunks):
        sl = slice(rows[0], rows[-1] + 1)
        out.append(th._progenitor_draws(
            _t(cond_t[sl]), _t(m_tgt[sl]), _t(inv), so.MIN_LOGPROB, so.SAMPLER_MIN_MASS,
            **{k: v[sl] for k, v in draws.items()}))
    m = torch.cat([o[0] for o in out]).numpy()
    keep = torch.cat([o[1] for o in out]).numpy()
    np.testing.assert_array_equal(keep, ref_keep)
    assert 0 < keep.sum() < keep.size
    np.testing.assert_allclose(m, ref_m, rtol=MASS_REL, atol=0)


def _jax_draws(monkeypatch, key, n, chunk_rows):
    """Hand the port's progenitor step the JAX package's draws for the
    snapshot key (halos.py:957-990; padded to 256 rows as there), in chunks
    of `chunk_rows` descendants.  Returns the list of the chunks' rates, one
    entry a chunk drawn."""
    pad = (-n) % 256
    k13 = jax.random.fold_in(key, 13)
    u = np.asarray(jax.random.uniform(key, (n + pad, K_MAX), minval=1e-12, maxval=1.0))
    k1, k2 = jax.random.split(jax.random.fold_in(k13, 5))
    sel = np.asarray(jax.random.bernoulli(k1, 0.5, (n + pad,)))
    u_fix = np.asarray(jax.random.uniform(k2, (n + pad, K_MAX)))
    n_exp_all = []
    start = [0]

    def rng(n_exp, k_max, number_limited, generator, dev):
        sl = slice(start[0], start[0] + n_exp.numel())
        start[0] = sl.stop
        n_exp_all.append(n_exp.numpy())
        out = dict(u=_t(u[sl]))
        if number_limited:
            # JAX draws every count from one key over the padded rows: the
            # chunks' rates are gathered first, so this port step runs whole
            assert sl == slice(0, n)
            rates = np.pad(n_exp.numpy(), (0, pad))
            out["n_draw"] = _t(np.asarray(jax.random.poisson(k13, jnp.asarray(rates)))[:n])
        else:
            out.update(sel=_t(sel[sl]), u_fix=_t(u_fix[sl]))
        return out

    def normals(m, generator, dev):
        ks = jax.random.split(jax.random.fold_in(key, 7), 3)
        return tuple(_t(jax.random.normal(k, (m,), jnp.float32)) for k in ks)

    monkeypatch.setattr(th, "_progenitor_rng", rng)
    monkeypatch.setattr(th, "_normals", normals)
    monkeypatch.setattr(th, "PROGENITOR_CHUNK_ROWS", chunk_rows)
    return n_exp_all


@pytest.mark.parametrize(
    "method, chunk_rows",
    [("MASS-LIMITED", 2**20), ("MASS-LIMITED", 20000), ("NUMBER-LIMITED", 2**20)],
    ids=["mass-limited", "mass-limited-chunks", "number-limited"])
def test_progenitor_step_matches_jax(chain, monkeypatch, method, chunk_rows):
    """determine_halo_catalog's progenitor step (z=10.5 -> 12) from the
    chain's lowest-node JAX catalog, with the JAX package's draws: the same
    catalog in the same order (the rare halos last), also when the
    descendants are drawn in chunks of 20000 rows (5 chunks here)."""
    jinp = chain["jinp"].evolve_input_structs(SAMPLE_METHOD=method)
    tinp = port_inputs(jinp)
    prev = _node(chain, -1)["cat"]
    key = _jkey(1234, 12.0)
    ref = _numpy(jh.determine_halo_catalog(12.0, jinp, None, _jstruct(jout.HaloCatalog, prev),
                                           key=key))
    n_desc = len(prev["halo_masses"])
    chunks = _jax_draws(monkeypatch, key, n_desc, chunk_rows)
    got = th.determine_halo_catalog(12.0, tinp, None, interop.halo_catalog_from_numpy(prev, "cpu"),
                                    generator=torch.Generator(), device="cpu")
    assert len(chunks) == -(-n_desc // chunk_rows)
    assert got.n_halos == ref["n_halos"] == len(ref["halo_masses"]) > 10000
    np.testing.assert_allclose(got.halo_masses.numpy(), ref["halo_masses"], rtol=MASS_REL)
    for name in ("halo_coords", "star_rng", "sfr_rng", "xray_rng"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), ref[name], err_msg=name)
    assert float(got.redshift) == float(ref["redshift"])


# ---------------------------------------------------------------------------
# the port's own sampler, statistically


def test_grid_sampler_counts_from_a_generator():
    """4096 cells of Lagrangian delta 0.5 (at z=8) with SAMPLER_MIN_MASS=1e9:
    the count within 10% of the expected one (as tests/test_components.py's
    number-limited test), the counts falling by mass octave."""
    inp = t21.InputParameters(random_seed=3).evolve_input_structs(
        HII_DIM=16, DIM=32, BOX_LEN=48.0, SOURCE_MODEL="CHMF-SAMPLER", SAMPLER_MIN_MASS=1e9)
    growth = float(inp.cosmology.dicke(8.0))
    delta = torch.full(inp.simulation_options.lowres_shape, 0.5 / growth)
    h = th.grid_sampler_tables(8.0, inp, delta)
    masses, pos = th.sample_halo_grid(8.0, inp, delta, generator=torch.Generator().manual_seed(2),
                                      device="cpu")
    assert np.isclose(len(masses), h["n_expected"], rtol=0.1) and h["n_expected"] > 1000
    octaves = np.histogram(masses.numpy(), bins=1e9 * 2.0 ** np.arange(5))[0]
    assert np.all(np.diff(octaves) < 0), octaves
    assert pos.shape == (len(masses), 3) and 0 <= float(pos.min()) and float(pos.max()) < 48.0


def test_mass_limited_progenitors_keep_the_expected_mass():
    """4000 descendants of 1e10 Msun at z=8 sampled back to z=8.3 from a torch
    generator: the progenitor mass above the summed targets
    (HALOMASS_CORRECTION x the expected collapsed mass) and within 3% of the
    expected collapsed mass itself (see the module docstring); positions
    and the property draws inherited."""
    inp = t21.InputParameters(random_seed=3).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="CHMF-SAMPLER")
    n = 4000
    rng = np.random.default_rng(0)
    prev = t21.HaloCatalog(
        redshift=np.float32(8.0), halo_masses=torch.full((n,), 1e10),
        halo_coords=torch.as_tensor(rng.uniform(0, 16, (n, 3)).astype(np.float32)),
        star_rng=torch.zeros(n), sfr_rng=torch.zeros(n), xray_rng=torch.zeros(n), n_halos=n)
    h = th.progenitor_tables(8.3, inp, 8.0, 1e10)
    _, m_tgt, _, rare = th._descendant_conditions(inp, h, prev.halo_masses)
    assert not rare.any()
    got = th.determine_halo_catalog(8.3, inp, None, prev, generator=torch.Generator().manual_seed(4),
                                    device="cpu")
    assert got.n_halos > n
    corr = inp.simulation_options.HALOMASS_CORRECTION
    ratio = float(got.halo_masses.double().sum()) / float(m_tgt.sum())
    assert ratio > 1.0 and abs(ratio * corr - 1) < 0.03, ratio
    assert float(got.halo_masses.max()) <= 1e10 and float(got.halo_masses.min()) >= 1e8
    assert set(map(tuple, got.halo_coords.numpy())) <= set(map(tuple, prev.halo_coords.numpy()))
    # AR(1) mixing from zero: sqrt(1 - CORR^2) times a fresh normal
    so = inp.simulation_options
    assert np.isclose(float(got.star_rng.std()), np.sqrt(1 - so.CORR_STAR**2), rtol=0.05)


# ---------------------------------------------------------------------------
# the perturbed catalog and the sampled HaloBox, from a JAX catalog


def test_perturb_halo_catalog_matches_jax(chain):
    node = _node(chain, -1)
    j_ics = _jstruct(jout.InitialConditions, chain["j_ics"])
    t_ics = interop.initial_conditions_from_numpy(chain["j_ics"], "cpu")
    ref = _numpy(jh.perturb_halo_catalog(node["z"], chain["jinp"], j_ics,
                                         _jstruct(jout.HaloCatalog, node["cat"])))
    got = t21.perturb_halo_catalog(node["z"], chain["tinp"], t_ics,
                                   interop.halo_catalog_from_numpy(node["cat"], "cpu"),
                                   device="cpu")
    assert isinstance(got, t21.PerturbedHaloCatalog) and got.n_halos == ref["n_halos"]
    moved = np.abs(ref["halo_coords"] - node["cat"]["halo_coords"]).max()
    assert moved > 0.1
    np.testing.assert_allclose(got.halo_coords.numpy(), ref["halo_coords"], rtol=0, atol=1e-5)
    assert float(got.halo_coords.min()) >= 0 and float(got.halo_coords.max()) < 36.0
    np.testing.assert_array_equal(got.halo_masses.numpy(), ref["halo_masses"])


def test_halo_properties_match_jax(chain):
    node = _node(chain, -1)
    ref = jhb.halo_properties(node["z"], chain["jinp"], _jstruct(jout.HaloCatalog, node["cat"]))
    got = thb.halo_properties(node["z"], chain["tinp"],
                              interop.halo_catalog_from_numpy(node["cat"], "cpu"), device="cpu")
    for name, g, r in zip(("stellar", "sfr", "n_ion", "wsfr", "xray38"), got, ref):
        r = np.asarray(r)
        assert r.min() > 0, name
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=0, err_msg=name)


HB_FIELDS = ("n_ion", "halo_sfr", "whalo_sfr", "halo_xray", "halo_stars", "halo_sfr_mini",
             "halo_stars_mini")


def _pt_catalogs(chain, i):
    node = _node(chain, i)
    j_ics = _jstruct(jout.InitialConditions, chain["j_ics"])
    pt = jh.perturb_halo_catalog(node["z"], chain["jinp"], j_ics,
                                 _jstruct(jout.HaloCatalog, node["cat"]))
    return pt, interop.perturbed_halo_catalog_from_numpy(_numpy(pt), "cpu")


@pytest.mark.parametrize("sub", [True, False], ids=["with-sub-sampler", "halos-only"])
@pytest.mark.parametrize("minihalos", [False, True], ids=["acg", "minihalos"])
def test_halo_grid_matches_jax(chain, minihalos, sub):
    """compute_halo_grid at node 3 (z=13.4) from the same perturbed JAX
    catalog, with the chain's JAX boxes of the node before for the feedback
    grids under minihalos, with and without the sub-sampler grids."""
    jinp = chain["jinp"].evolve_input_structs(USE_MINI_HALOS=True) if minihalos else chain["jinp"]
    tinp = port_inputs(jinp)
    node, prev = _node(chain, 3), _node(chain, 2)
    j_pt, t_pt = _pt_catalogs(chain, 3)
    j_ics = _jstruct(jout.InitialConditions, chain["j_ics"])
    t_ics = interop.initial_conditions_from_numpy(chain["j_ics"], "cpu")
    ref = _numpy(jhb.compute_halo_grid(
        node["z"], jinp, j_pt, previous_spin_temp=_jstruct(jout.TsBox, prev["ts"]),
        previous_ionized_box=_jstruct(jout.IonizedBox, prev["ion"]),
        lagrangian_delta=j_ics.lowres_density if sub else None, ics=j_ics))
    got = t21.compute_halo_grid(
        node["z"], tinp, t_pt, previous_spin_temp=interop.ts_box_from_numpy(prev["ts"], "cpu"),
        previous_ionized_box=interop.ionized_box_from_numpy(prev["ion"], "cpu"),
        lagrangian_delta=t_ics.lowres_density if sub else None, ics=t_ics, device="cpu")
    for name in HB_FIELDS:
        r, g = ref[name], getattr(got, name)
        assert (r is None) == (g is None) == (name.endswith("_mini") and not minihalos), name
        if r is not None:
            assert r.max() > 0, name
            _close(g.numpy(), r, 1e-5, name)
    _close(got.count.numpy(), ref["count"], 1e-5, "count")
    assert abs(float(got.count.double().sum()) - t_pt.n_halos) < 1e-4 * t_pt.n_halos
    if not minihalos:
        for name in ("log10_Mcrit_ACG_ave", "log10_Mcrit_MCG_ave"):
            assert float(getattr(got, name)) == float(ref[name]), name
        return
    # the feedback grids are the same in both packages; the port's float32
    # means are held to their exact means (XLA's float32 mean of 13824 cells
    # of ~8.7 is 1e-3 off it)
    grids = jhb._mcrit_grids(node["z"], jinp, jhmf.set_scaling_constants(node["z"], jinp),
                             _jstruct(jout.TsBox, prev["ts"]),
                             _jstruct(jout.IonizedBox, prev["ion"]), None)
    for name, grid in zip(("log10_Mcrit_ACG_ave", "log10_Mcrit_MCG_ave"), grids):
        g, exact = float(getattr(got, name)), np.asarray(grid, np.float64).mean()
        assert abs(g - exact) <= 4 * np.spacing(np.float32(exact)), (name, g, exact)


def test_fixed_halo_grid_below_the_sampler_matches_jax(chain):
    """compute_fixed_halo_grid up to m_max = SAMPLER_MIN_MASS, displaced;
    None where the range is empty."""
    node = _node(chain, 3)
    j_ics = _jstruct(jout.InitialConditions, chain["j_ics"])
    t_ics = interop.initial_conditions_from_numpy(chain["j_ics"], "cpu")
    m_max = chain["tinp"].simulation_options.SAMPLER_MIN_MASS
    ref = _numpy(jhb.compute_fixed_halo_grid(node["z"], chain["jinp"], j_ics.lowres_density,
                                             m_max=m_max, ics=j_ics))
    got = thb.compute_fixed_halo_grid(node["z"], chain["tinp"], t_ics.lowres_density, m_max=m_max,
                                      ics=t_ics, device="cpu")
    full = thb.compute_fixed_halo_grid(node["z"], chain["tinp"], t_ics.lowres_density, ics=t_ics,
                                       device="cpu")
    for name in HB_FIELDS[:5]:
        assert ref[name].max() > 0, name
        _close(getattr(got, name).numpy(), ref[name], 1e-5, name)
        assert float(getattr(got, name).sum()) < float(getattr(full, name).sum()), name
    m_min = thmf.minimum_source_mass(node["z"], chain["tinp"])
    assert thb.compute_fixed_halo_grid(node["z"], chain["tinp"], t_ics.lowres_density,
                                       m_max=m_min, device="cpu") is None


def test_interp_halo_boxes_matches_jax(chain):
    """Between the chain's HaloBoxes of nodes 3 and 4 (ascending z)."""
    boxes = [_node(chain, i)["hb"] for i in (4, 3)]
    z = 0.3 * boxes[0]["redshift"] + 0.7 * boxes[1]["redshift"]
    fields = ["halo_sfr", "halo_xray", "n_ion", "halo_sfr_mini"]
    ref = _numpy(j_interp_halo_boxes([_jstruct(jout.HaloBox, b) for b in boxes], fields, z))
    got = t21.interp_halo_boxes([interop.halobox_from_numpy(b, "cpu") for b in boxes], fields, z)
    assert float(got.redshift) == float(ref["redshift"]) == np.float32(z)
    for name in ("halo_sfr", "halo_xray", "n_ion", "whalo_sfr"):
        _close(getattr(got, name).numpy(), ref[name], 1e-6, name)
    assert got.halo_sfr_mini is None
    with pytest.raises(ValueError, match="ascending"):
        t21.interp_halo_boxes([interop.halobox_from_numpy(b, "cpu") for b in boxes[::-1]],
                              fields, z)


@pytest.mark.parametrize("n", [0, 1])
def test_empty_and_tiny_catalogs(n):
    """A catalog of 0 or 1 halos through the progenitor step, the perturbed
    catalog, the halo properties and the HaloBox (zero halo grids; the
    sub-sampler grids alone when the density is given)."""
    inp = t21.InputParameters(random_seed=1).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="CHMF-SAMPLER", USE_MINI_HALOS=True)
    ics = t21.compute_initial_conditions(inp, device="cpu")
    cat = t21.HaloCatalog(
        redshift=np.float32(9.0), halo_masses=torch.full((n,), 3e9), halo_coords=torch.full((n, 3), 7.5),
        star_rng=torch.zeros(n), sfr_rng=torch.zeros(n), xray_rng=torch.zeros(n), n_halos=n)
    prog = t21.determine_halo_catalog(9.5, inp, ics, cat, device="cpu")
    assert prog.n_halos == len(prog.halo_masses) and (prog.n_halos == 0) == (n == 0)
    assert prog.halo_coords.shape == (prog.n_halos, 3)
    pt = t21.perturb_halo_catalog(9.0, inp, ics, cat, device="cpu")
    assert pt.halo_coords.shape == (n, 3) and torch.isfinite(pt.halo_coords).all()
    props = thb.halo_properties(9.0, inp, cat, device="cpu")
    assert all(p.shape == (n,) for p in props)
    bare = t21.compute_halo_grid(9.0, inp, pt, device="cpu")
    assert abs(float(bare.count.sum()) - n) < 1e-5 and bare.halo_sfr_mini is not None
    assert (float(bare.halo_sfr.sum()) > 0) == (n > 0)
    full = t21.compute_halo_grid(9.0, inp, pt, lagrangian_delta=ics.lowres_density, ics=ics,
                                 device="cpu")
    assert float(full.halo_sfr.min()) >= 0 and float(full.halo_sfr.sum()) > float(bare.halo_sfr.sum())
    assert np.isfinite(float(full.log10_Mcrit_MCG_ave))


def test_interop_carries_catalogs(chain):
    node = _node(chain, 0)
    assert node["cat"]["n_halos"] == 0  # z=27: no halo above SAMPLER_MIN_MASS
    last = _node(chain, -1)["cat"]
    for conv, cls in ((interop.halo_catalog_from_numpy, t21.HaloCatalog),
                      (interop.perturbed_halo_catalog_from_numpy, t21.PerturbedHaloCatalog)):
        cat = conv(last, "cpu")
        assert type(cat) is cls and cat.n_halos == len(cat.halo_masses) == last["n_halos"]
        np.testing.assert_array_equal(cat.halo_coords.numpy(), last["halo_coords"])
        assert cat.star_rng.dtype == torch.float32
        back = cat.to_numpy()
        np.testing.assert_array_equal(back["halo_masses"], last["halo_masses"])
    padded = dict(last, halo_masses=np.pad(last["halo_masses"], (0, 9)))
    assert interop.halo_catalog_from_numpy(padded, "cpu").halo_masses.shape == (last["n_halos"],)
    assert interop.halo_catalog_from_numpy(node["cat"], "cpu").halo_coords.shape == (0, 3)


# ---------------------------------------------------------------------------
# the chain


def test_halo_grids_of_the_chain_match_jax(chain):
    """The HaloBox of every node of the chain, from the same catalogs (each
    package's own ICs from one density)."""
    for j, t in zip(chain["jax"]["nodes"], chain["port"]["nodes"]):
        for name in HB_FIELDS[:5]:
            _close(t["hb"][name], j["hb"][name], 1e-5, f"{name} z={j['z']}")
        if j["cat"]["n_halos"]:
            _close(t["hb"]["count"], j["hb"]["count"], 1e-5, f"count z={j['z']}")
    counts = [n["cat"]["n_halos"] for n in chain["jax"]["nodes"]]
    assert counts[0] == 0 and counts[-1] > 50000 and counts == sorted(counts)


def test_latest_discrete_lightcone_matches_jax(chain):
    """Per node the global xH; the golden gates on the cone (its first
    HII_DIM slices for the power); every cone's cells; the global quantities."""
    j_nodes, t_nodes = chain["jax"]["nodes"], chain["port"]["nodes"]
    assert [n["z"] for n in t_nodes] == [n["z"] for n in j_nodes]
    for j, t in zip(j_nodes, t_nodes):
        np.testing.assert_allclose(t["ion"]["neutral_fraction"].astype(np.float64).mean(),
                                   j["ion"]["neutral_fraction"].astype(np.float64).mean(),
                                   atol=5e-3, err_msg=f"xH z={j['z']}")
    j_lc, t_lc = chain["jax"]["lc"], chain["port"]["lc"]
    so = chain["jinp"].simulation_options
    bt, bt_ref = t_lc.brightness_temp.numpy(), np.asarray(j_lc.brightness_temp)
    t_gq, j_gq = t_lc.global_quantities, j_lc.global_quantities
    _gates(t_gq["neutral_fraction"], j_gq["neutral_fraction"], bt[:, :, : so.HII_DIM],
           bt_ref[:, :, : so.HII_DIM], so.box_lens, "latest-discrete lightcone")
    assert set(t_lc.lightcones) == set(j_lc.lightcones)
    for q, t in t_lc.lightcones.items():
        assert_cone_share(t.numpy(), j_lc.lightcones[q], q)
    np.testing.assert_allclose(t_gq["brightness_temp"], j_gq["brightness_temp"],
                               atol=1e-3 * np.abs(bt_ref).max())
    assert 0.0 < t_gq["neutral_fraction"][-1] < 0.95


def test_the_port_samples_its_own_chain():
    """Without catalogs handed in, run_coeval samples its own chain (DexM
    and the grid at the lowest node, progenitors above) from the default
    generators: the same seed gives the same catalogs and boxes."""
    inp = t21.InputParameters.from_template("latest-discrete", random_seed=2).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, R_BUBBLE_MAX=5.0, N_STEP_TS=6, ZPRIME_STEP_FACTOR=1.3,
    ).with_logspaced_redshifts(8.0, 12.0)
    seen = []
    orig = th.determine_halo_catalog

    def spy(z, *a, **kw):
        cat = orig(z, *a, **kw)
        seen.append((z, kw.get("previous_catalog") is not None, cat.n_halos))
        return cat

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(th, "determine_halo_catalog", spy)
        outs = [t21.run_coeval(inp, 8.0, device="cpu") for _ in range(2)]
    zs = sorted(inp.node_redshifts)
    assert [s[0] for s in seen[:3]] == zs and [s[1] for s in seen[:3]] == [False, True, True]
    assert seen[:3] == seen[3:] and seen[0][2] > seen[2][2] > 0
    assert torch.equal(outs[0].halobox.halo_sfr, outs[1].halobox.halo_sfr)
    assert abs(float(outs[0].halobox.count.double().sum()) - seen[0][2]) < 1e-3 * seen[0][2]
