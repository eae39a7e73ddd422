"""The port's non-finite sweep and `Lightconer.get_field` against the JAX
package, on the CPU.

The sweep is lag-1 in both packages: the scroll starts node i's count of
NaN/Inf cells (`begin_validate_snapshot`) and checks it at node i+1
(`check_nonfinite(pending)`), and checks the last node's after the loop.  A
NaN put into Tb at node k is therefore raised after node k's Coeval has been
yielded.  Both packages run one golden-size Ts chain (HII_DIM=24, DIM=72,
BOX_LEN=36, USE_TS_FLUCT and inhomogeneous recombinations, 4 nodes from
z=20 to z=10.5) from one numpy hires density, and must yield the same number
of coevals and raise the same message; a 0-d device field is skipped by
both; `validate_outputs=False` turns the sweep off in both.

`get_field(coeval, quantity, device=False)` returns host numpy unless asked
for the device tensor; both forms hold the same values, every cell within
1e-4 of the field's maximum of the JAX package's (the chain's float32
rounding); a field the configuration does not fill is None in both.
"""

import dataclasses

import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ics import jax_inputs, numpy_grf, port_inputs

import py21cmfast_torch as t21
import py21cmfast_tpu as j21
from py21cmfast_torch import exceptions as texc
from py21cmfast_torch.drivers import coeval as tcoeval
from py21cmfast_torch.lightconers import RectilinearLightconer as TLightconer
from py21cmfast_tpu import exceptions as jexc
from py21cmfast_tpu.drivers import coeval as jcoeval
from py21cmfast_tpu.lightconers import RectilinearLightconer as JLightconer
from py21cmfast_tpu.models import ics as jics

REDSHIFT = 10.5
N_NODES = 4
# every quantity py21cmfast_tpu/lightconers.py:74-94 names
QUANTITIES = ("brightness_temp", "tau_21", "density", "velocity_z", "velocity_x", "velocity_y",
              "neutral_fraction", "z_reion", "ionisation_rate_G12", "cumulative_recombinations",
              "spin_temperature", "kinetic_temp_neutral", "xray_ionised_fraction", "J_21_LW")


@pytest.fixture(scope="module")
def chain():
    jinp = jax_inputs(USE_TS_FLUCT=True, RECOMB_MODEL="INHOMOGENEOUS",
                      R_BUBBLE_MAX=20.0).with_logspaced_redshifts(REDSHIFT, 20.0)
    tinp = port_inputs(jinp)
    assert len(tinp.node_redshifts) == N_NODES
    dens = numpy_grf(jinp, seed=5)
    return dict(
        jinp=jinp, tinp=tinp,
        jics=jics.compute_initial_conditions(jinp, initial_density=dens),
        tics=t21.compute_initial_conditions(tinp, initial_density=dens, device="cpu"),
    )


@pytest.fixture(scope="module")
def zero_d_run(chain):
    """Both chains with a 0-d NaN device field at node 1: (JAX's coevals and
    error, the port's coevals and error)."""
    with pytest.MonkeyPatch.context() as mp:
        return _both(chain, mp, 1, nan_tb=False)


def _with_nan(module, monkeypatch, node, nan_tb):
    """Patch `module`'s brightness_temperature so that the node-th call puts
    a NaN into one Tb cell (`nan_tb`) or a 0-d NaN device array into the
    box's redshift field (`not nan_tb`)."""
    real = module.brightness_temperature
    calls = []

    def patched(*a, **kw):
        tb = real(*a, **kw)
        calls.append(None)
        if len(calls) - 1 != node:
            return tb
        if isinstance(tb.brightness_temp, torch.Tensor):
            if nan_tb:
                box = tb.brightness_temp.clone()
                box[1, 2, 3] = float("nan")
                return dataclasses.replace(tb, brightness_temp=box)
            return dataclasses.replace(tb, redshift=torch.tensor(float("nan")))
        if nan_tb:
            return dataclasses.replace(tb, brightness_temp=tb.brightness_temp.at[1, 2, 3].set(
                jnp.nan))
        return dataclasses.replace(tb, redshift=jnp.asarray(jnp.nan, jnp.float32))

    monkeypatch.setattr(module, "brightness_temperature", patched)


def _drain(gen):
    """The coevals a generator yields before it raises, and what it raised."""
    out = []
    try:
        for cv in gen:
            out.append(cv)
    except (jexc.InfinityOrNaNError, texc.InfinityOrNaNError) as err:
        return out, err
    return out, None


def _both(chain, monkeypatch, node=None, nan_tb=True):
    if node is not None:
        _with_nan(jcoeval, monkeypatch, node, nan_tb)
        _with_nan(tcoeval, monkeypatch, node, nan_tb)
    j = _drain(jcoeval.generate_coeval(chain["jinp"], (), chain["jics"]))
    t = _drain(t21.generate_coeval(chain["tinp"], (), chain["tics"], device="cpu"))
    return j, t


@pytest.mark.parametrize("node", [1, N_NODES - 1], ids=["inside-the-chain", "last-node"])
def test_nan_is_raised_one_node_late_as_in_jax(chain, monkeypatch, node):
    (j_out, j_err), (t_out, t_err) = _both(chain, monkeypatch, node)
    # node k's coeval comes out, the error follows at node k+1 (or after the
    # loop for the last node)
    assert len(t_out) == len(j_out) == node + 1
    assert isinstance(j_err, jexc.InfinityOrNaNError)
    assert isinstance(t_err, texc.InfinityOrNaNError)
    z = chain["tinp"].node_redshifts[node]
    msg = f"BrightnessTemp.brightness_temp has 1 non-finite values (z={z:.3f})"
    assert str(t_err) == str(j_err) == msg
    assert float(t_out[-1].brightness_temp.isnan().sum()) == 1.0


def test_nan_in_a_0d_device_field_raises_in_neither(zero_d_run):
    (j_out, j_err), (t_out, t_err) = zero_d_run
    assert j_err is None and t_err is None
    assert len(j_out) == len(t_out) == N_NODES
    assert t_out[1].brightness_temperature.redshift.isnan()
    assert bool(jnp.isnan(j_out[1].brightness_temperature.redshift))


def test_validate_outputs_off_turns_the_sweep_off_in_both(chain, monkeypatch):
    monkeypatch.setitem(j21.config, "validate_outputs", False)
    monkeypatch.setitem(t21.config, "validate_outputs", False)
    (j_out, j_err), (t_out, t_err) = _both(chain, monkeypatch, 1)
    assert j_err is None and t_err is None
    assert len(j_out) == len(t_out) == N_NODES
    assert texc.begin_validate_snapshot(9.0, t_out[1].brightness_temperature) is None
    assert jexc.begin_validate_snapshot(9.0, j_out[1].brightness_temperature) is None


def test_the_handles_match_jax():
    """`validate_snapshot` = `check_nonfinite(begin_validate_snapshot(...))`;
    host fields are counted at once, device fields on the check; None checks
    nothing."""
    tb = t21.BrightnessTemp(redshift=np.float32(9.0), brightness_temp=torch.zeros(4, 4, 4),
                            tau_21=torch.full((4, 4, 4), float("inf")))
    pending = texc.begin_validate_snapshot(9.0, tb, None)
    with pytest.raises(texc.InfinityOrNaNError,
                       match=r"^BrightnessTemp\.tau_21 has 64 non-finite values \(z=9\.000\)$"):
        texc.check_nonfinite(pending)
    with pytest.raises(texc.InfinityOrNaNError, match="tau_21 has 64"):
        texc.validate_snapshot(9.0, tb)
    assert texc.check_nonfinite(None) is None
    host_nan = dataclasses.replace(tb, redshift=np.float32(np.nan), tau_21=None)
    with pytest.raises(texc.InfinityOrNaNError,
                       match=r"^BrightnessTemp\.redshift has 1 non-finite values \(z=9\.000\)$"):
        texc.validate_snapshot(9.0, host_nan)


def test_get_field_host_by_default_device_on_request(zero_d_run):
    """At the last node, which both chains computed without a NaN."""
    jcv, tcv = zero_d_run[0][0][-1], zero_d_run[1][0][-1]
    assert jcv.redshift == tcv.redshift == REDSHIFT
    jl, tl = JLightconer([0.0]), TLightconer([0.0])
    seen = 0
    for q in QUANTITIES:
        ref = jl.get_field(jcv, q)
        host = tl.get_field(tcv, q)
        dev = tl.get_field(tcv, q, device=True)
        if dev is None:
            # the configuration does not fill it: None in both packages
            assert host is None and ref.dtype == object and ref.item() is None, q
            assert jl.get_field(jcv, q, device=True) is None, q
            continue
        assert isinstance(host, np.ndarray) and isinstance(ref, np.ndarray), q
        assert isinstance(dev, torch.Tensor) and dev.device == torch.device("cpu"), q
        np.testing.assert_array_equal(host, dev.numpy(), err_msg=q)
        assert host.shape == ref.shape and host.dtype == ref.dtype, q
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert np.abs(host.astype(np.float64) - ref).max() <= 1e-4 * scale, q
        seen += 1
    # velocity_x, velocity_y and J_21_LW are not filled without minihalos
    assert seen == len(QUANTITIES) - 3
    with pytest.raises(ValueError, match="unknown lightcone quantity"):
        tl.get_field(tcv, "nonsense")
