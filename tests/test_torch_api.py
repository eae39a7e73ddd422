"""The port's public API against the JAX package's, on the CPU.

  __all__     every name of py21cmfast_tpu.__all__ is in the port's, and
              every name the port exports resolves;
  wrapper     the `wrapper` shim resolves its five submodules to the port's
              own modules;
  exceptions  validate_box and validate_snapshot behave as the JAX
              package's (tests/test_exceptions.py), on tensors;
  logging     configure_logging returns the `py21cmfast_torch` logger.
"""

import _torch_threads  # noqa: F401
import dataclasses
import logging

import numpy as np
import pytest
import torch

import py21cmfast_torch as t21
import py21cmfast_tpu as p21
from py21cmfast_torch._cfg import config
from py21cmfast_torch.exceptions import InfinityOrNaNError, validate_box, validate_snapshot
from py21cmfast_torch.outputs import PerturbedField


def test_all_covers_the_jax_package_and_resolves():
    missing = sorted(set(p21.__all__) - set(t21.__all__))
    assert not missing, missing
    unresolved = [n for n in t21.__all__ if not hasattr(t21, n)]
    assert not unresolved, unresolved
    assert {"interop", "InfinityOrNaNError", "ParameterError"} <= set(t21.__all__)


@pytest.mark.parametrize("name, module", [
    ("inputs", "py21cmfast_torch.inputs"),
    ("outputs", "py21cmfast_torch.outputs"),
    ("cfuncs", "py21cmfast_torch.cfuncs"),
    ("photoncons", "py21cmfast_torch.models.photoncons"),
    ("classy_interface", "py21cmfast_torch.cosmology.classy_interface"),
])
def test_wrapper_shim_resolves_to_the_port(name, module):
    import importlib
    import sys

    shim = importlib.import_module(f"py21cmfast_torch.wrapper.{name}")
    assert shim is sys.modules[module]
    assert getattr(t21.wrapper, name) is shim
    from py21cmfast_torch.wrapper.inputs import CosmoParams

    assert CosmoParams is t21.CosmoParams


def _pf_with(value):
    density = torch.full((4, 4, 4), value, dtype=torch.float32)
    vel = torch.zeros((4, 4, 4), dtype=torch.float32)
    return PerturbedField(redshift=np.float32(9.0), density=density, velocity_x=vel,
                          velocity_y=vel, velocity_z=vel)


def test_validate_box_passes_finite():
    pf = _pf_with(0.5)
    assert validate_box(pf) is pf


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_validate_box_raises_on_nonfinite(value):
    with pytest.raises(InfinityOrNaNError, match=r"PerturbedField\.density has 64 non-finite"):
        validate_box(_pf_with(value))
    # restricted to other fields, and with a context
    validate_box(_pf_with(value), fields=("velocity_z",))
    with pytest.raises(InfinityOrNaNError, match=r"\(node 3\)"):
        validate_box(_pf_with(value), context="node 3")


def test_validate_box_reads_host_scalars_too():
    pf = dataclasses.replace(_pf_with(0.5), redshift=np.float32(np.nan))
    with pytest.raises(InfinityOrNaNError, match="redshift"):
        validate_box(pf)


def test_validate_snapshot_respects_config_flag():
    bad = _pf_with(np.nan)
    with pytest.raises(InfinityOrNaNError, match=r"z=9\.000"):
        validate_snapshot(9.0, bad, None)
    config["validate_outputs"] = False
    try:
        validate_snapshot(9.0, bad, None)  # must not raise when disabled
    finally:
        config["validate_outputs"] = True


def test_configure_logging_returns_the_port_logger():
    logger = t21.configure_logging(logging.WARNING)
    assert logger.name == "py21cmfast_torch"
    assert logger.level == logging.WARNING and len(logger.handlers) == 1
    assert t21.configure_logging() is logger and len(logger.handlers) == 1
    assert logger.level == logging.INFO
