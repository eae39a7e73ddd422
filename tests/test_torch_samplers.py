"""The port's PARTITION and BINARY-SPLIT progenitor samplers against the JAX
package, on the CPU, at golden size (the "latest-discrete" template, HMF
'ST', HII_DIM=24, DIM=72, BOX_LEN=36), from a catalog of 3000 descendants
of log-uniform mass in [1e8, 3e11] Msun at z=10.5 sampled back to z=12.

The random steps are held with the JAX package's own draws, rebuilt from
the `fold_in` keys it uses (halos.py:909-955) and handed to the port's
deterministic cores in place of its generator's.  Tolerances:

  _gaussian_tail, _st_taylor_dev      within 2e-6 of their value (XLA's
                                      float32 erfc/erfinv approximations,
                                      ops/special.py; torch's and XLA's
                                      float32 log and pow differ by an ulp)
  the partition core and the whole    the keep masks, counts, order,
  PARTITION step (whole and in 3      positions and property draws
  chunks, HMF 'ST' and 'PS')          identical; masses within 2e-4 of their
                                      value: the inverse-CDF draw amplifies
                                      the ulps of erfinv, log and exp, and
                                      one ulp of ln M ~ 20 is 1.9e-6 in M
  the binary-split core and the       the progenitor counts, keep masks,
  whole BINARY-SPLIT step (whole and  positions and property draws
  in 3 chunks)                        identical; each descendant's
                                      progenitor masses, sorted, 99% within
                                      2e-5 of their value and every one
                                      within 1e-2.  Where eta = beta - 1 -
                                      gamma1 mu nears 0, the step's
                                      (0.5^eta - q_res^eta)/eta cancels to
                                      ~1% in float32, in both packages: an
                                      ulp of XLA's and torch's log or pow
                                      moves the step by ~1%, the mass lost
                                      below resolution with it, and the
                                      step a branch finishes at, so a
                                      descendant's progenitors can come out
                                      in another order
  the port's own samplers, from a     the progenitor counts per mass octave
  torch generator                     within 0.75 (PARTITION) and 0.85
                                      (BINARY-SPLIT) of the conditional MF,
                                      as tests/test_sampler_methods.py
                                      holds the JAX package's
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sampler_methods import EDGES, _expected_prog_octaves
from test_torch_halos import SIZE, _jkey, _jstruct, _t
from test_torch_ics import port_inputs
from test_torch_minihalos import _numpy

import py21cmfast_torch as t21
from py21cmfast_torch import interop
from py21cmfast_torch.models import halos as th
from py21cmfast_torch.ops import special
from py21cmfast_tpu import outputs as jout
from py21cmfast_tpu.inputs import InputParameters as JInputs
from py21cmfast_tpu.models import halos as jh

N_DESC = 3000
C = th.BINARY_SPLIT_CAPACITY
PARTITION_REL = 2e-4
SPLIT_REL_99, SPLIT_REL_MAX = 2e-5, 1e-2


def jax_inputs(**over):
    return JInputs.from_template("latest-discrete", random_seed=1234).evolve_input_structs(
        **SIZE, **over)


@pytest.fixture(scope="module")
def descendants():
    """A catalog of N_DESC descendants at z=10.5, as numpy arrays."""
    rng = np.random.default_rng(1)
    n = N_DESC
    return dict(
        redshift=np.float32(10.5),
        halo_masses=np.exp(rng.uniform(np.log(1e8), np.log(3e11), n)).astype(np.float32),
        halo_coords=rng.uniform(0, 36, (n, 3)).astype(np.float32),
        star_rng=rng.standard_normal(n).astype(np.float32),
        sfr_rng=rng.standard_normal(n).astype(np.float32),
        xray_rng=rng.standard_normal(n).astype(np.float32),
        n_halos=np.int32(n),
    )


def _partition_draws(key, B, use_st):
    """The partition kernel's draws of step t for `rows` (+ a row offset),
    from the JAX package's keys over its B padded rows."""
    k13 = jax.random.fold_in(key, 13)

    def draw(t, rows, start=0):
        kt = jax.random.fold_in(k13, t)
        k1, k2 = jax.random.split(jax.random.fold_in(kt, 0))
        r = rows.numpy() + start
        out = dict(u=jax.random.uniform(k1, (B,), minval=1e-7, maxval=1.0),
                   u1=jax.random.uniform(k2, (4, B), minval=1e-12, maxval=1.0),
                   u2=jax.random.uniform(jax.random.fold_in(k2, 1), (4, B)))
        if use_st:
            out["u_acc"] = jax.random.uniform(jax.random.fold_in(kt, 1), (B,))
        return {k: _t(np.asarray(v)[..., r]) for k, v in out.items()}
    return draw


def _split_draws(key, B):
    """The binary split's draws of step t at (rows + a row offset, slots)."""
    k13 = jax.random.fold_in(key, 13)

    def draw(t, rows, slots, start=0):
        kt = jax.random.fold_in(k13, t)
        r, s = rows.numpy() + start, slots.numpy()
        return tuple(_t(np.asarray(jax.random.uniform(jax.random.fold_in(kt, i), (B, C)))[r, s])
                     for i in range(3))
    return draw


def test_gaussian_tail_matches_jax():
    """Both branches (the inverse CDF for nu_min <= 2, Devroye's tail above,
    with its first accepted try and its fallback) from the JAX draws."""
    key = jax.random.PRNGKey(4)
    nu = np.concatenate([np.linspace(0.0, 6.0, 4001), [2.0, 8.0, 30.0]]).astype(np.float32)
    ref = np.asarray(jh._gaussian_tail(key, jnp.asarray(nu)))
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, nu.shape, minval=1e-7, maxval=1.0)
    u1 = jax.random.uniform(k2, (4,) + nu.shape, minval=1e-12, maxval=1.0)
    u2 = jax.random.uniform(jax.random.fold_in(k2, 1), (4,) + nu.shape)
    got = th._gaussian_tail(_t(nu), _t(u), _t(u1), _t(u2)).numpy()
    assert (got > nu).all() or np.allclose(got[got <= nu], nu[got <= nu])
    np.testing.assert_allclose(got, ref, rtol=2e-6)
    # XLA's erfc and erfinv themselves, across their branches
    x = np.linspace(-0.999999, 0.999999, 20001).astype(np.float32)
    np.testing.assert_allclose(special.erfinv32(_t(x)).numpy(),
                               np.asarray(jax.scipy.special.erfinv(x)), rtol=1e-6, atol=1e-7)
    y = np.linspace(-3.0, 9.0, 20001).astype(np.float32)
    np.testing.assert_allclose(special.erfc32(_t(y)).numpy(),
                               np.asarray(jax.scipy.special.erfc(y)), rtol=1e-6)


def test_st_taylor_dev_matches_jax():
    rng = np.random.default_rng(2)
    sig = rng.uniform(0.5, 6.0, 4096).astype(np.float32)
    sig_cond = (sig * rng.uniform(0.1, 1.0, 4096)).astype(np.float32)
    sig_cond[:8] = sig[:8]  # the sigdiff guard
    growth = np.float32(0.08)
    ref = np.asarray(jh._st_taylor_dev(jnp.asarray(sig), jnp.asarray(sig_cond), growth))
    got = th._st_taylor_dev(_t(sig), _t(sig_cond), growth).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-6)


def _conditions(tinp, desc):
    """The port's progenitor tables and conditions of the descendants."""
    masses = _t(desc["halo_masses"])
    h = th.progenitor_tables(12.0, tinp, 10.5, float(masses.max()), inverse=False)
    return h, masses, th._descendant_conditions(tinp, h, masses)


@pytest.mark.parametrize("hmf_name", ["ST", "PS"])
def test_partition_kernel_matches_jax(descendants, hmf_name):
    """_partition_kernel on the descendants' conditions with the JAX draws."""
    jinp = jax_inputs(SAMPLE_METHOD="PARTITION", HMF=hmf_name)
    tinp = port_inputs(jinp)
    so = tinp.simulation_options
    h, masses, (_, m_tgt, _, _) = _conditions(tinp, descendants)
    m_min = so.SAMPLER_MIN_MASS
    ln_md = torch.log(torch.clamp(masses.double(), min=m_min)).float()
    delta_d = th._interp(ln_md.double(), _t(h["ln_mbins"]), _t(h["delta_bins"])).float()
    tables = th.partition_tables(th._get_sigma_table(tinp), m_min * 0.25,
                                 float(np.exp(h["ln_mbins"][-1])) * 1.05)
    sigma_min = float(th._get_sigma_table(tinp).sigma_of_lnm(np.log(m_min)))
    use_st = hmf_name == "ST"
    key = jax.random.PRNGKey(7)
    B = len(masses)
    ref_m, ref_keep = (np.asarray(a) for a in jh._partition_kernel(
        jax.random.fold_in(key, 13), jnp.asarray(delta_d.numpy()), jnp.asarray(ln_md.numpy()),
        jnp.asarray((m_tgt > 0).numpy()), *(jnp.asarray(a) for a in tables),
        jnp.float32(sigma_min), jnp.float32(m_min), jnp.float32(h["growth"]),
        jnp.float32(so.HALOMASS_CORRECTION), t_max=th.PROGENITOR_K_MAX, use_st=use_st))
    m, keep = th._partition_kernel(
        delta_d, ln_md, m_tgt > 0, tables, sigma_min, m_min, h["growth"], so.HALOMASS_CORRECTION,
        _partition_draws(key, B, use_st), t_max=th.PROGENITOR_K_MAX, use_st=use_st)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert 0 < ref_keep.sum() < ref_keep.size
    np.testing.assert_allclose(m.numpy(), ref_m, rtol=PARTITION_REL, atol=0)


def _assert_split_masses(got, ref, groups):
    """Masses sorted within each descendant's group of progenitors."""
    got, ref = (m[np.lexsort((m, groups))] for m in (got, ref))
    rel = np.abs(got - ref) / ref
    assert np.quantile(rel, 0.99) <= SPLIT_REL_99 and rel.max() <= SPLIT_REL_MAX, (
        np.quantile(rel, 0.99), rel.max())


def test_binary_split_kernel_matches_jax(descendants):
    """_binary_split_kernel on the descendants with the JAX draws: every
    progenitor row (count and masses) as the JAX lattice's."""
    jinp = jax_inputs(SAMPLE_METHOD="BINARY-SPLIT")
    tinp = port_inputs(jinp)
    so = tinp.simulation_options
    h, masses, _ = _conditions(tinp, descendants)
    m_min = so.SAMPLER_MIN_MASS
    sigma_table = th._get_sigma_table(tinp)
    ln_axis = np.linspace(np.log(m_min * 0.25), float(h["ln_mbins"][-1]) + 0.1, 512)
    tables = tuple(np.asarray(a, np.float32) for a in (
        ln_axis, sigma_table.sigma_of_lnm(ln_axis), sigma_table.dsigmasq_of_lnm(ln_axis)))
    B = len(masses)
    m_cond = torch.clamp(masses, min=float(np.float32(m_min)))
    d0 = np.float32(1.686 / h["growth_prev"])
    d1 = np.float32(1.686 / h["growth"])
    key = jax.random.PRNGKey(8)
    scalars = (np.float32(m_min), np.float32(so.PARKINSON_G0), np.float32(so.PARKINSON_y1),
               np.float32(so.PARKINSON_y2))
    ref_m, ref_ct = (np.asarray(a) for a in jh._binary_split_kernel(
        jax.random.fold_in(key, 13), jnp.asarray(m_cond.numpy()), jnp.full(B, d0), jnp.full(B, d1),
        *(jnp.asarray(a) for a in tables), *scalars, t_max=th.BINARY_SPLIT_T_MAX,
        capacity=C, cap_out=th.BINARY_SPLIT_CAP_OUT))
    rows, places, masses, out_ct, forced = th._binary_split_kernel(
        m_cond, torch.full((B,), float(d0)), torch.full((B,), float(d1)), tables,
        *(float(s) for s in scalars), _split_draws(key, B), t_max=th.BINARY_SPLIT_T_MAX,
        capacity=C, cap_out=th.BINARY_SPLIT_CAP_OUT)
    # the progenitors in the JAX package's (B, cap_out) rows, ordered as there
    keys = rows * th.BINARY_SPLIT_CAP_OUT + places
    assert torch.equal(keys, torch.sort(keys).values)
    out_m = torch.zeros((B, th.BINARY_SPLIT_CAP_OUT))
    out_m[rows, places] = masses
    np.testing.assert_array_equal(out_ct.numpy(), ref_ct)
    np.testing.assert_array_equal(out_m.numpy() > 0, ref_m > 0)
    assert 0 < forced <= ref_ct.sum() and ref_ct.max() <= th.BINARY_SPLIT_CAP_OUT
    rows = np.nonzero(ref_m > 0)[0]
    _assert_split_masses(out_m.numpy()[ref_m > 0], ref_m[ref_m > 0], rows)


def _hand_jax_draws(monkeypatch, key, n, chunk_rows):
    """Hand the port's progenitor step the JAX package's draws for the
    snapshot key (padded to 256 rows as there), in chunks of `chunk_rows`
    descendants.  Returns the list of the chunks' sizes, one entry a chunk
    drawn."""
    B = n + (-n) % 256
    chunks = []

    def partition_rng(m, use_st, generator, dev):
        start = sum(chunks)
        chunks.append(m)
        draw = _partition_draws(key, B, use_st)
        return lambda t, rows: draw(t, rows, start)

    def split_rng(m, generator, dev):
        start = sum(chunks)
        chunks.append(m)
        draw = _split_draws(key, B)
        return lambda t, rows, slots: draw(t, rows, slots, start)

    def normals(m, generator, dev):
        ks = jax.random.split(jax.random.fold_in(key, 7), 3)
        return tuple(_t(jax.random.normal(k, (m,), jnp.float32)) for k in ks)

    monkeypatch.setattr(th, "_partition_rng", partition_rng)
    monkeypatch.setattr(th, "_binary_split_rng", split_rng)
    monkeypatch.setattr(th, "_normals", normals)
    monkeypatch.setattr(th, "PROGENITOR_CHUNK_ROWS", chunk_rows)
    return chunks


@pytest.mark.parametrize(
    "method, chunk_rows",
    [("PARTITION", 2**20), ("PARTITION", 1000), ("BINARY-SPLIT", 2**20), ("BINARY-SPLIT", 1000)],
    ids=["partition", "partition-chunks", "binary-split", "binary-split-chunks"])
def test_progenitor_step_matches_jax(descendants, monkeypatch, method, chunk_rows):
    """determine_halo_catalog's progenitor step (z=10.5 -> 12) with the JAX
    package's draws: the same catalog in the same order, also when the
    descendants are drawn in chunks of 1000 rows (3 chunks here)."""
    jinp = jax_inputs(SAMPLE_METHOD=method)
    tinp = port_inputs(jinp)
    key = _jkey(1234, 12.0)
    ref = _numpy(jh.determine_halo_catalog(12.0, jinp, None,
                                           _jstruct(jout.HaloCatalog, descendants), key=key))
    chunks = _hand_jax_draws(monkeypatch, key, N_DESC, chunk_rows)
    got = th.determine_halo_catalog(12.0, tinp, None,
                                    interop.halo_catalog_from_numpy(descendants, "cpu"),
                                    generator=torch.Generator(), device="cpu")
    assert len(chunks) == -(-N_DESC // chunk_rows) and sum(chunks) == N_DESC
    assert got.n_halos == ref["n_halos"] == len(ref["halo_masses"]) > N_DESC
    if method == "PARTITION":
        np.testing.assert_allclose(got.halo_masses.numpy(), ref["halo_masses"], rtol=PARTITION_REL)
    else:
        # each descendant's progenitors share its position
        xyz = ref["halo_coords"]
        groups = np.cumsum(np.r_[True, (xyz[1:] != xyz[:-1]).any(axis=1)])
        _assert_split_masses(got.halo_masses.numpy(), ref["halo_masses"], groups)
    for name in ("halo_coords", "star_rng", "sfr_rng", "xray_rng"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), ref[name], err_msg=name)


@pytest.mark.parametrize("method", ["PARTITION", "BINARY-SPLIT"])
def test_progenitor_chunk_is_sized_by_bytes(monkeypatch, descendants, method):
    """Under the rows a chunk may hold, a chunk holds the descendants whose
    working set (PROGENITOR_ROW_BYTES each) fits PROGENITOR_CHUNK_BYTES."""
    jinp = jax_inputs(SAMPLE_METHOD=method)
    chunks = _hand_jax_draws(monkeypatch, _jkey(1234, 12.0), N_DESC, 2**23)
    monkeypatch.setattr(th, "PROGENITOR_CHUNK_BYTES", 1100 * th.PROGENITOR_ROW_BYTES[method])
    th.determine_halo_catalog(12.0, port_inputs(jinp), None,
                              interop.halo_catalog_from_numpy(descendants, "cpu"),
                              generator=torch.Generator(), device="cpu")
    assert chunks == [1100, 1100, 800]


@pytest.mark.parametrize("method", ["PARTITION", "BINARY-SPLIT"])
def test_progenitor_sampling_matches_cmf(method):
    """The port's own sampler from a torch generator: 2048 descendants of
    1e12 Msun at z=6 sampled back to z=6.3 (SAMPLER_MIN_MASS=1e9), the
    progenitor count per mass octave against the conditional MF with the
    tolerances of tests/test_sampler_methods.py, and (nearly) the
    descendant's mass in resolved progenitors."""
    jinp = JInputs(random_seed=9).evolve_input_structs(
        HII_DIM=8, DIM=24, BOX_LEN=16.0, SOURCE_MODEL="CHMF-SAMPLER", SAMPLER_MIN_MASS=1e9,
        SAMPLE_METHOD=method, ZPRIME_STEP_FACTOR=1.05)
    n, m_desc = 2048, 1e12
    prev = t21.HaloCatalog(
        redshift=np.float32(6.0), halo_masses=torch.full((n,), m_desc),
        halo_coords=torch.zeros((n, 3)), star_rng=torch.zeros(n), sfr_rng=torch.zeros(n),
        xray_rng=torch.zeros(n), n_halos=n)
    got = th.determine_halo_catalog(6.3, port_inputs(jinp), None, prev,
                                    generator=torch.Generator().manual_seed(11), device="cpu")
    m = got.halo_masses.numpy()
    assert len(m) > 500
    exp_counts, _ = _expected_prog_octaves(jinp, 6.3, 6.0, m_desc, EDGES)
    got_counts = np.histogram(m, bins=EDGES)[0] / n
    tol = {"PARTITION": 0.75, "BINARY-SPLIT": 0.85}[method]
    checked = [i for i, e in enumerate(exp_counts) if e * n >= 200]
    assert checked
    for i in checked:
        assert abs(got_counts[i] / exp_counts[i] - 1) < tol, (i, got_counts, exp_counts)
    assert m.sum() / n / m_desc > 0.5 and m.max() <= m_desc


@pytest.mark.parametrize("hmf_name, raises", [("PS", False), ("WATSON", True)])
def test_partition_requires_ps_or_st(hmf_name, raises):
    """PARTITION runs with HMF 'PS' and raises ValueError with another HMF,
    when it samples progenitors (JAX halos.py:933-934)."""
    inp = t21.InputParameters(random_seed=2).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="CHMF-SAMPLER", SAMPLE_METHOD="PARTITION",
        HMF=hmf_name)
    prev = t21.HaloCatalog(
        redshift=np.float32(8.0), halo_masses=torch.full((64,), 1e10), halo_coords=torch.zeros((64, 3)),
        star_rng=torch.zeros(64), sfr_rng=torch.zeros(64), xray_rng=torch.zeros(64), n_halos=64)
    if raises:
        with pytest.raises(ValueError, match="PARTITION sampling requires HMF='PS' or 'ST'"):
            th.determine_halo_catalog(8.3, inp, None, prev, device="cpu")
        return
    got = th.determine_halo_catalog(8.3, inp, None, prev, device="cpu")
    assert got.n_halos > 64 and float(got.halo_masses.max()) <= 1e10
