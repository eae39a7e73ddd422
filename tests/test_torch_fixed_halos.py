"""The port's fixed-grid source model (SOURCE_MODEL="L-INTEGRAL": HaloBox,
XraySourceBox, the Lagrangian Ts and ionization branches, the exp-MFP, shell
and multiple-scattering filters, IONISE_ENTIRE_SPHERE) against the JAX
package, at golden size (HII_DIM=24, DIM=72, BOX_LEN=36, ZPRIME_STEP_FACTOR=
1.25, Z_HEAT_MAX=25, R_BUBBLE_MAX=12, 5 nodes from z=27.08 to 10.5), on the
CPU.  One JAX chain: the "fixed-halos" template's lightcone (USE_EXP_FILTER,
CELL_RECOMB, USE_TS_FLUCT, INHOMOGENEOUS), both packages from one shared numpy
hires density; the unit tests take their inputs from its JAX nodes.
Tolerances:

  exp-MFP and shell windows, at the   the port within 1e-6 of the peak of the
  smallest and largest radius          float64 window everywhere, and per
                                       cell no further from the JAX package
                                       than the JAX package's float32 window is
                                       from the float64 one, plus 1e-6 of the
                                       peak (see below)
  multiple-scattering window           within 1e-6 of the peak
  _mcrit_grids                         max-abs <= 2e-6 (as _mcrit_kernel)
  compute_fixed_halo_grid, with and    each grid max-abs <= 1e-5 of its max;
  without minihalos, displaced or not  the turnover means within 4 float32
                                       ulps of the exact mean of the grid
  compute_xray_source_field, with and  each stack, shell by shell, max-abs <=
  without minihalos and multiple       1e-5 of that shell's max; the trimmed
  scattering                           history bit-identical to the whole one
  one Lagrangian Ts step               Ts, Tk, x_e, J_21_LW max-abs <= 1e-4 of
                                       the max (as tests/test_torch_minihalos)
  one Lagrangian ionization step       xH: at most 1e-3 of the cells off by
  (USE_EXP_FILTER, IONISE_ENTIRE_      1e-3; z_reion, N_rec: at most 1e-3 of
  SPHERE with and without it)          the cells off by 1e-4 of the max; G12:
                                       at most 1e-3 of the cells off by 2e-3
                                       of their value (it is set from the
                                       exp-MFP-filtered SFR)
  the fixed-halos lightcone            per node global xH atol 5e-3 and the
                                       HaloBox grids 1e-5 of their max; the
                                       golden gates (tests/test_golden.py:
                                       32-45) on the cone, every cone at most
                                       1e-3 of the cells off by 1e-3 max, the
                                       global quantities 1e-3 of max|Tb|

The exp-MFP and shell windows cancel terms up to (mfp/R)^3 ~ 1e5 times their
result at the smallest radii.  The JAX package evaluates them in float32 and
is off its own float64 formula by more than 1e-3 there (asserted below; CPU
transcendentals and FMA contraction decide the rounding, so no float32 order
of operations reproduces it); the port evaluates them in float64 and rounds
once.  At the largest radius both agree within 1e-6 of the peak at every
k > 0 (the k = 0 Taylor value, 6 r^3 (1 - e^-1/r) - ..., still cancels).
"""

import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ics import GOLDEN, numpy_grf, port_inputs
from test_torch_lightcone import assert_cone_share
from test_torch_minihalos import _close, _gates, _numpy

import py21cmfast_torch as t21
from py21cmfast_torch import interop
from py21cmfast_torch.drivers.coeval import _slim_history_box
from py21cmfast_torch.models import halobox as thb
from py21cmfast_torch.models import hmf as thmf
from py21cmfast_torch.models import ics as tics
from py21cmfast_torch.models import ionization as tion
from py21cmfast_torch.models import spintemp as tsp
from py21cmfast_torch.models import xray_source as txs
from py21cmfast_torch.ops import filters as tfilt
from py21cmfast_torch.ops import grids as tgrids
from py21cmfast_tpu import outputs as jout
from py21cmfast_tpu.drivers.lightcone import generate_lightcone as j_generate_lightcone
from py21cmfast_tpu.inputs import InputParameters as JInputs
from py21cmfast_tpu.models import halobox as jhb
from py21cmfast_tpu.models import hmf as jhmf
from py21cmfast_tpu.models import ics as jics
from py21cmfast_tpu.models import ionization as jion
from py21cmfast_tpu.models import spintemp as jsp
from py21cmfast_tpu.models import xray_source as jxs
from py21cmfast_tpu.ops import filters as jfilt
from py21cmfast_tpu.ops import grids as jgrids

SIZE = {**{k: v for k, v in GOLDEN.items() if k != "SOURCE_MODEL"}, "R_BUBBLE_MAX": 12.0}
NODE = 3  # z = 13.375: the unit tests' node (Ts has started, xH < 1)
MFP = 25.483241248322766  # / h: the ionizing photons' mean free path (Mpc)


def jax_inputs(**over):
    return JInputs.from_template("fixed-halos", random_seed=1234).evolve_input_structs(
        **SIZE, **over).with_logspaced_redshifts(10.5, 25.0)


def _jstruct(cls, d):
    return cls(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) and v.ndim else v)
                  for k, v in d.items() if k in cls.__dataclass_fields__})


@pytest.fixture(scope="module")
def chain():
    """The fixed-halos lightcone in both packages from one density, with
    every node's boxes as numpy and the JAX package's XraySourceBoxes."""
    jinp = jax_inputs()
    tinp = port_inputs(jinp)
    mo, ao = tinp.matter_options, tinp.astro_options
    assert mo.SOURCE_MODEL == "L-INTEGRAL" and ao.USE_EXP_FILTER and ao.CELL_RECOMB
    assert ao.USE_TS_FLUCT and ao.RECOMB_MODEL == "INHOMOGENEOUS" and len(tinp.node_redshifts) == 5
    dens = numpy_grf(jinp, seed=5)
    j_ics = jics.compute_initial_conditions(jinp, initial_density=dens)
    t_ics = tics.compute_initial_conditions(tinp, initial_density=dens, device="cpu")
    sources = {}

    def record(z, *a, **kw):
        sources[round(float(z), 6)] = _numpy(orig(z, *a, **kw))
        return jout.XraySourceBox(**{k: (None if v is None else jnp.asarray(v))
                                     for k, v in sources[round(float(z), 6)].items()})

    orig = jxs.compute_xray_source_field
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jxs, "compute_xray_source_field", record)
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
        n["source"] = sources.get(round(n["z"], 6))
    return dict(jinp=jinp, tinp=tinp, j_ics=_numpy(j_ics), t_ics=t_ics, **runs)


# ---------------------------------------------------------------------------
# the filter bank


def _exp_mfp_f64(k, R, mfp):
    """filtering.c:80-104 in float64 from float32 k, R, mfp."""
    k, R, mfp = np.asarray(k, np.float64), float(np.float32(R)), float(np.float32(mfp))
    kr, ratio, e = k * R, mfp / R, np.exp(-R / mfp)
    krs = np.where(kr < 1e-4, 1.0, kr)
    f = (krs**2 * ratio**2 + 2 * ratio + 1) * ratio * np.cos(krs)
    f = f + (krs**2 * (ratio**2 - ratio**3) + ratio + 1) * np.sin(krs) / krs
    f = (f * e - 2 * ratio**2) * (-3) * ratio / (krs**2 * ratio**2 + 1) ** 2
    ts0 = 6 * ratio**3 - e * (6 * ratio**3 + 6 * ratio**2 + 3 * ratio)
    taylor = ts0 + (e * (2 * ratio**2 + 0.5 * ratio) - 2 * ts0 * ratio**2) * kr**2
    return np.where(kr < 1e-4, taylor, f)


def _shell_f64(k, r_in, r_out):
    """filtering.c:106-117 in float64 from float32 k and radii."""
    k = np.asarray(k, np.float64)
    r_in, r_out = float(np.float32(r_in)), float(np.float32(r_out))
    ki, ko = k * r_in, k * r_out
    kos, kis = np.where(ko < 1e-4, 1.0, ko), np.where(ko < 1e-4, 0.5, ki)
    num = np.sin(kos) - np.cos(kos) * kos - np.sin(kis) + np.cos(kis) * kis
    w = 3.0 / (kos**3 - kis**3) * num
    x = r_in / r_out
    return np.where(ko < 1e-4, 1.0 - ko**2 / 10.0 * (x**5 - 1.0) / (x**3 - 1.0), w)


def _radii(chain):
    """The ionization ladder's radii at z=10.5 and the Ts shells (inner,
    outer) at the unit-test node."""
    tinp = chain["tinp"]
    ladder = tion.setup_radii(tinp, thmf.minimum_source_mass(10.5, tinp, xray=False))
    shells = tsp.setup_z_edges(chain["jax"]["nodes"][NODE]["z"], tinp)
    return ladder.R, shells


@pytest.mark.parametrize("end", ["smallest", "largest"])
@pytest.mark.parametrize("window", ["exp-mfp", "shell"])
def test_windows_match_jax(chain, window, end):
    """The exp-MFP window at the ionization ladder's smallest and largest
    radius, the shell window at the first filtered and the last Ts shell."""
    so = chain["tinp"].simulation_options
    kmag_j = jgrids.kmag_grid(so.lowres_shape, so.box_lens)
    kmag = tgrids.kmag_grid(so.lowres_shape, so.box_lens, "cpu")
    np.testing.assert_array_equal(kmag.numpy(), np.asarray(kmag_j))
    radii, shells = _radii(chain)
    mfp = MFP / chain["tinp"].cosmology.hlittle
    if window == "exp-mfp":
        R = radii.min() if end == "smallest" else radii.max()
        ref = np.asarray(jfilt.w_exp_mfp(kmag_j, jnp.float32(R), jnp.float32(mfp)))
        got = tfilt.filter_weights(kmag, tfilt.EXP_MFP, R, mfp).numpy()
        exact = _exp_mfp_f64(kmag.numpy(), R, mfp)
    else:
        i = 1 if end == "smallest" else len(shells.R) - 1
        r_in, r_out = shells.R_inner[i], shells.R[i]
        assert r_in > 0
        ref = np.asarray(jfilt.w_shell(kmag_j, jnp.float32(r_in), jnp.float32(r_out)))
        got = tfilt.filter_weights(kmag, tfilt.SHELL, r_in, r_out).numpy()
        exact = _shell_f64(kmag.numpy(), r_in, r_out)
    assert got.dtype == np.float32
    peak = np.abs(exact).max()
    assert np.abs(got - exact).max() <= 1e-6 * peak
    assert (np.abs(got - ref) <= np.abs(ref - exact) + 1e-6 * peak).all()
    if end == "largest":
        # away from the Taylor branch at k = 0 the float32 window is good
        assert np.abs(got - ref)[kmag.numpy() > 0].max() <= 1e-6 * peak
    elif window == "exp-mfp":
        # why the bound is per cell: the float32 window is far off here
        assert np.abs(ref - exact).max() > 1e-3 * peak


@pytest.mark.parametrize("end", ["smallest", "largest"])
def test_multiple_scattering_window_matches_jax(chain, end):
    """The host-tabulated 2F3 window (the same float64 code in both
    packages) and its jnp.interp on the |k| grid, at x_HI = 0.9."""
    tinp, jinp = chain["tinp"], chain["jinp"]
    so = tinp.simulation_options
    z = chain["jax"]["nodes"][NODE]["z"]
    _, shells = _radii(chain)
    i = 1 if end == "smallest" else len(shells.R) - 1
    r_star = txs.lya_diffusion_scale(z, tinp, 0.9)
    assert r_star == jxs.lya_diffusion_scale(z, jinp, 0.9) and r_star > 0
    k_max = float(np.sqrt(3.0) * np.pi * so.HII_DIM / so.box_len)
    tables = [m.ms_filter_table(k_max, float(shells.R_inner[i]), float(shells.R[i]), r_star)
              for m in (jfilt, tfilt)]
    np.testing.assert_array_equal(tables[0][1], tables[1][1])
    k_tab, w_tab = tables[1]
    kmag = tgrids.kmag_grid(so.lowres_shape, so.box_lens, "cpu")
    ref = np.asarray(jfilt.w_multiple_scattering(jnp.asarray(kmag.numpy()), k_tab, w_tab))
    got = tfilt.w_multiple_scattering(tfilt.ms_interp_grid(kmag, k_tab), w_tab).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert np.abs(ref - 1.0).max() > 0.1  # the window does filter


# ---------------------------------------------------------------------------
# HaloBox and XraySourceBox


@pytest.fixture(scope="module")
def mini(chain):
    """L-INTEGRAL with minihalos and multiple scattering: both packages'
    feedback grids and the JAX package's HaloBoxes at nodes 0..NODE, from the
    chain's JAX ICs and the chain's JAX boxes of the node before."""
    jinp = jax_inputs(USE_MINI_HALOS=True, LYA_MULTIPLE_SCATTERING=True)
    tinp = port_inputs(jinp)
    j_ics = _jstruct(jout.InitialConditions, chain["j_ics"])
    nodes = chain["jax"]["nodes"]
    boxes, grids = [], []
    for k in range(NODE + 1):
        z = nodes[k]["z"]
        prev = nodes[k - 1] if k else None
        prev_ts = _jstruct(jout.TsBox, prev["ts"]) if prev else None
        prev_ion = _jstruct(jout.IonizedBox, prev["ion"]) if prev else None
        mt = jhb._mcrit_grids(z, jinp, jhmf.set_scaling_constants(z, jinp), prev_ts, prev_ion, None)
        boxes.append(_numpy(jhb.compute_fixed_halo_grid(
            z, jinp, j_ics.lowres_density, mt_a_grid=mt[0], mt_m_grid=mt[1], ics=j_ics)))
        t_mt = thb._mcrit_grids(
            z, tinp, thmf.set_scaling_constants(z, tinp),
            interop.ts_box_from_numpy(prev["ts"], "cpu") if prev else None,
            interop.ionized_box_from_numpy(prev["ion"], "cpu") if prev else None, None, "cpu")
        grids.append(dict(z=z, jax=[np.asarray(m) for m in mt], port=[m.numpy() for m in t_mt]))
    return dict(jinp=jinp, tinp=tinp, boxes=boxes, grids=grids)


def test_mcrit_grids_match_jax(mini):
    """The feedback turnover grids from the same previous boxes."""
    for g in mini["grids"]:
        for got, ref in zip(g["port"], g["jax"]):
            assert np.isfinite(ref).all() and ref.min() > 5.0
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6, err_msg=f"z={g['z']}")


HB_FIELDS = ("n_ion", "halo_sfr", "whalo_sfr", "halo_xray", "halo_stars", "halo_sfr_mini",
             "halo_stars_mini")


@pytest.mark.parametrize("displaced", [True, False], ids=["displaced", "lagrangian"])
@pytest.mark.parametrize("minihalos", [False, True], ids=["acg", "minihalos"])
def test_fixed_halo_grid_matches_jax(chain, mini, minihalos, displaced):
    """compute_fixed_halo_grid at the unit-test node from the chain's JAX
    ICs, with the same feedback grids under minihalos."""
    node = chain["jax"]["nodes"][NODE]
    jinp, tinp = (mini["jinp"], mini["tinp"]) if minihalos else (chain["jinp"], chain["tinp"])
    j_ics = _jstruct(jout.InitialConditions, chain["j_ics"])
    t_ics = interop.initial_conditions_from_numpy(chain["j_ics"], "cpu")
    mt = mini["grids"][NODE]["jax"] if minihalos else (None, None)
    j_mt = [None if m is None else jnp.asarray(m) for m in mt]
    t_mt = [None if m is None else torch.as_tensor(m) for m in mt]
    ref = jhb.compute_fixed_halo_grid(
        node["z"], jinp, j_ics.lowres_density, mt_a_grid=j_mt[0], mt_m_grid=j_mt[1],
        ics=j_ics if displaced else None)
    got = thb.compute_fixed_halo_grid(
        node["z"], tinp, t_ics.lowres_density, mt_a_grid=t_mt[0], mt_m_grid=t_mt[1],
        ics=t_ics if displaced else None, device="cpu")
    for name in HB_FIELDS:
        r, g = getattr(ref, name), getattr(got, name)
        assert (r is None) == (g is None) == (name.endswith("_mini") and not minihalos), name
        if r is not None:
            assert np.asarray(r).max() > 0, name
            _close(g.numpy(), np.asarray(r), 1e-5, name)
    if displaced:
        # each displaced grid owns its storage (generate_coeval's history
        # keeps two of them a node, not the whole scatter stack)
        ptrs = {getattr(got, n).untyped_storage().data_ptr() for n in HB_FIELDS
                if getattr(got, n) is not None}
        assert len(ptrs) == sum(getattr(got, n) is not None for n in HB_FIELDS)
    for name, grid in zip(("log10_Mcrit_ACG_ave", "log10_Mcrit_MCG_ave"), mt):
        g = float(getattr(got, name))
        if grid is None:
            assert g == float(getattr(ref, name))
        else:
            exact = np.asarray(grid, np.float64).mean()
            assert abs(g - exact) <= 4 * np.spacing(np.float32(exact)), (name, g, exact)


def test_fixed_halo_grid_of_the_chain_matches_jax(chain):
    """The HaloBox of every node of the chain (each package's own ICs)."""
    for j, t in zip(chain["jax"]["nodes"], chain["port"]["nodes"]):
        for name in HB_FIELDS[:5]:
            _close(t["hb"][name], j["hb"][name], 1e-5, f"{name} z={j['z']}")
        assert t["hb"]["log10_Mcrit_ACG_ave"] == j["hb"]["log10_Mcrit_ACG_ave"]


def _source_inputs(chain, mini, minihalos, ms):
    """Inputs and the (z, HaloBox) history at the unit-test node."""
    if minihalos:
        jinp, boxes = mini["jinp"], mini["boxes"]
        if not ms:
            jinp = jinp.evolve_input_structs(LYA_MULTIPLE_SCATTERING=False)
    else:
        jinp = chain["jinp"].evolve_input_structs(LYA_MULTIPLE_SCATTERING=ms)
        boxes = [n["hb"] for n in chain["jax"]["nodes"][: NODE + 1]]
    zs = [n["z"] for n in chain["jax"]["nodes"][: NODE + 1]]
    return jinp, port_inputs(jinp), list(zip(zs, boxes))


SOURCE_FIELDS = ("filtered_sfr", "filtered_xray", "filtered_sfr_mini", "filtered_sfr_lw",
                 "filtered_sfr_mini_lw")


@pytest.mark.parametrize("ms", [False, True], ids=["annulus", "multiple-scattering"])
@pytest.mark.parametrize("minihalos", [False, True], ids=["acg", "minihalos"])
def test_xray_source_field_matches_jax(chain, mini, minihalos, ms):
    """compute_xray_source_field from the same JAX HaloBoxes (nodes 0..NODE)
    and the chain's JAX IonizedBox of the node before; the port's history
    trimmed as generate_coeval keeps it gives the same stacks bit for bit."""
    jinp, tinp, history = _source_inputs(chain, mini, minihalos, ms)
    z = history[-1][0]
    prev_ion = chain["jax"]["nodes"][NODE - 1]["ion"]
    ref = _numpy(jxs.compute_xray_source_field(
        z, jinp, [(zz, _jstruct(jout.HaloBox, hb)) for zz, hb in history],
        previous_ionized_box=_jstruct(jout.IonizedBox, prev_ion)))
    boxes = [(zz, interop.halobox_from_numpy(hb, "cpu")) for zz, hb in history]
    t_prev = interop.ionized_box_from_numpy(prev_ion, "cpu")
    got = txs.compute_xray_source_field(z, tinp, boxes, previous_ionized_box=t_prev, device="cpu")
    trimmed = txs.compute_xray_source_field(
        z, tinp, [(zz, _slim_history_box(hb)) for zz, hb in boxes], previous_ionized_box=t_prev,
        device="cpu")
    for name in SOURCE_FIELDS:
        r, g = ref[name], getattr(got, name)
        assert (r is None) == (g is None), name
        if r is None:
            continue
        assert g.shape == r.shape and r.max() > 0, name
        assert torch.equal(getattr(trimmed, name), g), name
        for i, (gs, rs) in enumerate(zip(g.numpy(), r)):
            scale = np.abs(rs).max()
            assert np.abs(gs - rs).max() <= 1e-5 * scale, f"{name} shell {i}"
    assert (ref["filtered_sfr_lw"] is not None) == (ms and minihalos)
    if minihalos:
        np.testing.assert_array_equal(got.mean_log10_Mcrit_LW.numpy(), ref["mean_log10_Mcrit_LW"])
        assert torch.equal(trimmed.mean_log10_Mcrit_LW, got.mean_log10_Mcrit_LW)


def test_xray_source_field_beyond_the_oldest_node(chain):
    """At node 1 the outer shells reach past Z_HEAT_MAX: they carry no
    sources.  The port from the chain's JAX HaloBoxes against the chain's
    own JAX XraySourceBox of that node."""
    nodes = chain["jax"]["nodes"][:2]
    ref = nodes[1]["source"]
    got = txs.compute_xray_source_field(
        nodes[1]["z"], chain["tinp"], [(n["z"], interop.halobox_from_numpy(n["hb"], "cpu"))
                                       for n in nodes],
        previous_ionized_box=interop.ionized_box_from_numpy(nodes[0]["ion"], "cpu"), device="cpu")
    dead = ~np.any(ref["filtered_sfr"].reshape(len(ref["filtered_sfr"]), -1) > 0, axis=1)
    assert dead.any() and not dead[0]
    for name in ("filtered_sfr", "filtered_xray"):
        g = getattr(got, name).numpy()
        assert not g[dead].any(), name
        for i in np.flatnonzero(~dead):
            assert np.abs(g[i] - ref[name][i]).max() <= 1e-5 * np.abs(ref[name][i]).max(), name


# ---------------------------------------------------------------------------
# one Lagrangian Ts and ionization step


TS_FIELDS = ("spin_temperature", "kinetic_temp_neutral", "xray_ionised_fraction", "J_21_LW")


@pytest.mark.parametrize("minihalos", [False, True], ids=["fixed-halos", "minihalos+ms"])
def test_lagrangian_ts_step_matches_jax(chain, mini, minihalos):
    """One Ts step from the chain's JAX TsBox and IonizedBox of the node
    before and a JAX XraySourceBox (the chain's own, or the minihalo and
    multiple-scattering one, with its LW shells) carried by interop."""
    node, prev = chain["jax"]["nodes"][NODE], chain["jax"]["nodes"][NODE - 1]
    if minihalos:
        jinp, tinp, history = _source_inputs(chain, mini, True, True)
        source = _numpy(jxs.compute_xray_source_field(
            node["z"], jinp, [(zz, _jstruct(jout.HaloBox, hb)) for zz, hb in history],
            previous_ionized_box=_jstruct(jout.IonizedBox, prev["ion"])))
        ref, _ = jsp.compute_spin_temperature(
            node["z"], jinp, _jstruct(jout.PerturbedField, node["pf"]),
            prev_state=_jstruct(jout.TsBox, prev["ts"]), prev_redshift=prev["z"],
            source_box=_jstruct(jout.XraySourceBox, source),
            previous_ionized_box=_jstruct(jout.IonizedBox, prev["ion"]))
        ref = _numpy(ref)
        assert source["filtered_sfr_lw"] is not None
    else:
        tinp, source, ref = chain["tinp"], node["source"], node["ts"]
    got, _ = tsp.compute_spin_temperature(
        node["z"], tinp, interop.perturbed_field_from_numpy(node["pf"], "cpu"),
        prev_state=interop.ts_box_from_numpy(prev["ts"], "cpu"), prev_redshift=prev["z"],
        source_box=interop.xray_source_box_from_numpy(source, "cpu"),
        previous_ionized_box=interop.ionized_box_from_numpy(prev["ion"], "cpu"), device="cpu")
    for name in TS_FIELDS:
        assert (ref[name] is None) == (getattr(got, name) is None) == (name == "J_21_LW"
                                                                     and not minihalos)
        if ref[name] is not None:
            _close(getattr(got, name).numpy(), ref[name], 1e-4, f"{name} z={node['z']}")
    if minihalos:
        assert ref["J_21_LW"].max() > 0


ION_CASES = {
    "exp-filter": dict(),
    "exp-filter+sphere": dict(IONISE_ENTIRE_SPHERE=True),
    "tophat+sphere": dict(IONISE_ENTIRE_SPHERE=True, USE_EXP_FILTER=False),
}


@pytest.mark.parametrize("case", ION_CASES)
def test_lagrangian_ionization_step_matches_jax(chain, case):
    """One ionization step at the last node from the chain's JAX boxes: its
    HaloBox, TsBox and PerturbedField and the IonizedBox of the node before."""
    node, prev = chain["jax"]["nodes"][-1], chain["jax"]["nodes"][-2]
    if ION_CASES[case]:
        jinp = chain["jinp"].evolve_input_structs(**ION_CASES[case])
        ref = _numpy(jion.compute_ionization_field(
            node["z"], jinp, _jstruct(jout.PerturbedField, node["pf"]),
            previous_ionized_box=_jstruct(jout.IonizedBox, prev["ion"]),
            spin_temp=_jstruct(jout.TsBox, node["ts"]), halobox=_jstruct(jout.HaloBox, node["hb"]),
            prev_redshift=prev["z"]))
        tinp = port_inputs(jinp)
    else:
        tinp, ref = chain["tinp"], node["ion"]
    got = tion.compute_ionization_field(
        node["z"], tinp, interop.perturbed_field_from_numpy(node["pf"], "cpu"),
        previous_ionized_box=interop.ionized_box_from_numpy(prev["ion"], "cpu"),
        spin_temp=interop.ts_box_from_numpy(node["ts"], "cpu"), prev_redshift=prev["z"],
        halobox=interop.halobox_from_numpy(node["hb"], "cpu"), device="cpu")
    xh, xh_ref = got.neutral_fraction.numpy(), ref["neutral_fraction"]
    assert np.mean(np.abs(xh - xh_ref) > 1e-3) <= 1e-3
    assert 0.0 < xh_ref.mean() < 1.0 and (xh_ref == 0).any()
    for name in ("z_reion", "cumulative_recombinations"):
        assert_cone_share(getattr(got, name).numpy(), ref[name], name, share=1e-3, rel=1e-4)
    # Gamma12 is set at a cell's first crossing from the source-filtered SFR,
    # whose exp-MFP window differs by the JAX package's float32 error
    g12, g12_ref = got.ionisation_rate_G12.numpy(), ref["ionisation_rate_G12"]
    assert np.mean(np.abs(g12 - g12_ref) > 2e-3 * np.abs(g12_ref)) <= 1e-3
    assert float(got.mean_f_coll) == float(ref["mean_f_coll"])


def test_ionise_entire_sphere_ionizes_more(chain):
    """IONISE_ENTIRE_SPHERE paints whole spheres: fewer neutral cells than
    the centre-only criterion from the same state."""
    node, prev = chain["jax"]["nodes"][-1], chain["jax"]["nodes"][-2]
    out = []
    for sphere in (False, True):
        tinp = port_inputs(chain["jinp"].evolve_input_structs(IONISE_ENTIRE_SPHERE=sphere))
        out.append(tion.compute_ionization_field(
            node["z"], tinp, interop.perturbed_field_from_numpy(node["pf"], "cpu"),
            previous_ionized_box=interop.ionized_box_from_numpy(prev["ion"], "cpu"),
            spin_temp=interop.ts_box_from_numpy(node["ts"], "cpu"), prev_redshift=prev["z"],
            halobox=interop.halobox_from_numpy(node["hb"], "cpu"), device="cpu").global_xH)
    assert out[1] < out[0]


# ---------------------------------------------------------------------------
# the chain


def test_fixed_halos_lightcone_matches_jax(chain):
    """Per node the global xH; the golden gates on the cone (its first
    HII_DIM slices for the power); every cone's cells; the global quantities."""
    j_nodes, t_nodes = chain["jax"]["nodes"], chain["port"]["nodes"]
    assert [n["z"] for n in t_nodes] == [n["z"] for n in j_nodes]
    for j, t in zip(j_nodes, t_nodes):
        np.testing.assert_allclose(t["ion"]["neutral_fraction"].astype(np.float64).mean(),
                                   j["ion"]["neutral_fraction"].astype(np.float64).mean(),
                                   atol=5e-3, err_msg=f"xH z={j['z']}")
    assert sum(n["source"] is not None for n in j_nodes) == 4  # Ts starts below Z_HEAT_MAX
    j_lc, t_lc = chain["jax"]["lc"], chain["port"]["lc"]
    so = chain["jinp"].simulation_options
    bt, bt_ref = t_lc.brightness_temp.numpy(), np.asarray(j_lc.brightness_temp)
    t_gq, j_gq = t_lc.global_quantities, j_lc.global_quantities
    _gates(t_gq["neutral_fraction"], j_gq["neutral_fraction"], bt[:, :, : so.HII_DIM],
           bt_ref[:, :, : so.HII_DIM], so.box_lens, "fixed-halos lightcone")
    assert set(t_lc.lightcones) == set(j_lc.lightcones)
    for q, t in t_lc.lightcones.items():
        assert_cone_share(t.numpy(), j_lc.lightcones[q], q)
    np.testing.assert_allclose(t_gq["brightness_temp"], j_gq["brightness_temp"],
                               atol=1e-3 * np.abs(bt_ref).max())
    assert 0.0 < t_gq["neutral_fraction"][-1] < 0.95


def test_interop_carries_halobox_and_source_box(chain):
    node = chain["jax"]["nodes"][NODE]
    hb = interop.halobox_from_numpy(node["hb"], "cpu")
    sb = interop.xray_source_box_from_numpy(node["source"], "cpu")
    for got, ref in ((hb.halo_sfr, node["hb"]["halo_sfr"]), (hb.n_ion, node["hb"]["n_ion"]),
                     (sb.filtered_sfr, node["source"]["filtered_sfr"]),
                     (sb.filtered_xray, node["source"]["filtered_xray"])):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert sb.filtered_sfr.ndim == 4 and sb.filtered_sfr_mini is None
    assert isinstance(hb.log10_Mcrit_ACG_ave, np.float32)


@pytest.mark.filterwarnings("ignore:R_BUBBLE_MAX")
@pytest.mark.parametrize("name", ["simple", "const-zeta", "latest", "park19", "fixed-halos"])
def test_templates_run(name):
    """The templates without minihalos (tests/test_torch_minihalos.py runs
    the minihalo ones) run by name through run_lightcone on the CPU (8³,
    3 nodes) with finite boxes and cones."""
    inp = t21.InputParameters.from_template(name, random_seed=1).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, R_BUBBLE_MAX=5.0, N_STEP_TS=6, ZPRIME_STEP_FACTOR=1.3,
    ).with_logspaced_redshifts(8.0, 12.0)
    lc = t21.run_lightcone(inp, device="cpu")
    assert all(np.isfinite(t.numpy()).all() for t in lc.lightcones.values())
    xh = lc.global_quantities["neutral_fraction"]
    assert np.isfinite(xh).all() and xh[-1] < xh[0]
    if inp.matter_options.SOURCE_MODEL == "L-INTEGRAL":
        out = t21.run_coeval(inp, 8.0, device="cpu")
        assert out.halobox is not None and float(out.halobox.halo_sfr.min()) >= 0.0
        assert np.isfinite(out.spin_temp.spin_temperature.numpy()).all()
