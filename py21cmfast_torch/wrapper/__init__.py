"""Compatibility shim for the reference's `py21cmfast.wrapper` package layout,
as py21cmfast_tpu/wrapper provides it.

The reference keeps its input/output structs and low-level function wrappers
under `py21cmfast.wrapper.*` (wrapper/inputs.py, wrapper/outputs.py,
wrapper/cfuncs.py, wrapper/photoncons.py, wrapper/classy_interface.py).
This package has no C wrapper layer — those modules live at the top level —
but downstream code importing through the `wrapper` path keeps working:

    from py21cmfast_torch.wrapper.inputs import CosmoParams
    from py21cmfast_torch.wrapper import cfuncs
"""

import sys as _sys

from .. import cfuncs, inputs, outputs
from ..cosmology import classy_interface
from ..models import photoncons

_sys.modules[__name__ + ".inputs"] = inputs
_sys.modules[__name__ + ".outputs"] = outputs
_sys.modules[__name__ + ".cfuncs"] = cfuncs
_sys.modules[__name__ + ".photoncons"] = photoncons
_sys.modules[__name__ + ".classy_interface"] = classy_interface

__all__ = ["inputs", "outputs", "cfuncs", "photoncons", "classy_interface"]
