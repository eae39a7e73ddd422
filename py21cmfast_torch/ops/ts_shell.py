"""The spin temperature's per-shell cell chain on the card: the wrappers of
csrc/ts_shell.cu, the shell constants they take by value and the choice of
path.

For each shell of the Eulerian Ts shell scan (models/spintemp.py
`_ts_shell_scan`) the k-space window and the inverse FFT stay in PyTorch;
`ts_shell_reduce` then writes the block partial sums of the filtered field's
fcoll, and `ts_shell_accumulate` adds the shell's SFR and X-ray terms into
the radiative accumulators in place.  Each shell's scalars, Chebyshev
coefficients and 14-point frequency tables go to both kernels as one C struct
passed by value (`ShellConsts`), the step's own constants as another
(`StepConsts`); only the gather path's stacked SFRD tables live on the card.
The plain version is the torch code of `_ts_shell_scan`, which every other
case runs (`takes_kernels`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

__all__ = ["ShellConsts", "ShellPack", "StepConsts", "takes_kernels", "ts_shell_accumulate",
           "ts_shell_reduce"]

N_CHEB = 17  # CHEBY_DEG + 1
N_XE = 14  # heating.X_INT_XHII
N_DELTA = 400  # spintemp.N_DELTA_SFRD
MODE_CHEBY, MODE_GATHER, MODE_CONST = 0, 1, 2

_f = ctypes.c_float


class ShellConsts(ctypes.Structure):
    """One shell's constants, float32, field for field csrc/ts_shell.cu's
    TsShellConsts (71 floats, no padding)."""

    _fields_ = [
        ("R", _f), ("growth", _f), ("zfac", _f), ("xr_fac", _f), ("d_lo", _f), ("d_hi", _f),
        ("cap", _f), ("mean_sfrd", _f),
        ("p_star", _f), ("p_cont", _f), ("p_inj", _f),
        ("cheb", _f * N_CHEB), ("cheb_edge", _f),
        ("tbl_heat", _f * N_XE), ("tbl_ion", _f * N_XE), ("tbl_lya", _f * N_XE),
    ]


class StepConsts(ctypes.Structure):
    """The Ts step's constants, the same for every shell: the aliasing floor
    1/D(z_pf), f_star10 and the 14 x_e knots, float32, field for field
    csrc/ts_shell.cu's TsStepConsts (16 floats)."""

    _fields_ = [("inv_growth_pf", _f), ("fstar10", _f), ("xhii", _f * N_XE)]


@dataclasses.dataclass(frozen=True)
class ShellPack:
    """A Ts step's shells in the kernels' form: `consts` (a ctypes array of
    ShellConsts, one a shell), whether each shell is filtered, and the
    stacked (n_shell, N_DELTA) SFRD and fcoll tables on the card where the
    table mode reads them (else None)."""

    consts: ctypes.Array
    do_filter: tuple
    sfrd: torch.Tensor | None = None
    fc: torch.Tensor | None = None

    def __len__(self):
        return len(self.consts)


def takes_kernels(on_cuda: bool, eulerian: bool, minihalos: bool, sharded: bool) -> bool:
    """Whether the shell scan runs the kernels: single-device Eulerian
    sources without minihalos on CUDA tensors.  Everything else (CPU
    tensors, minihalos, L-INTEGRAL sources, slab-sharded grids) runs the
    torch code."""
    return on_cuda and eulerian and not minihalos and not sharded


def mode(use_cheby: bool, const_model: bool) -> int:
    """The kernels' table mode of the host tables' flags."""
    if const_model:
        return MODE_CONST
    return MODE_CHEBY if use_cheby else MODE_GATHER


def _check(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernels take CUDA tensors")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the kernels load float4)")


def _table_row(table, i, m, which):
    """The pointer to row i of a stacked (n_shell, N_DELTA) table, or None
    under the Chebyshev fit."""
    if m == MODE_CHEBY:
        return None
    if table is None:
        raise ValueError(f"mode {m} needs the stacked {which} tables")
    if table.dtype != torch.float32 or not table.is_contiguous() or table.shape[-1] != N_DELTA:
        raise ValueError(f"the {which} tables must be contiguous float32 rows of {N_DELTA}")
    return table[i].data_ptr()


def _consts_ref(step, consts, i):
    """The host addresses of `step` and `consts[i]`; the C function copies
    the structs and hands them to the kernel by value."""
    if not isinstance(step, StepConsts):
        raise TypeError("step must be a StepConsts")
    if not isinstance(consts, ctypes.Array) or consts._type_ is not ShellConsts:
        raise TypeError("consts must be a ctypes array of ShellConsts")
    if not 0 <= i < len(consts):
        raise IndexError(f"shell {i} of {len(consts)}")
    return (ctypes.addressof(step), ctypes.sizeof(StepConsts),
            ctypes.addressof(consts) + i * ctypes.sizeof(ShellConsts), ctypes.sizeof(ShellConsts))


def partials_buffer(delta0) -> torch.Tensor:
    """The scratch the reduce writes and the accumulate reads, for grids
    like `delta0` (allocated once a Ts step)."""
    _check("grid", delta0, delta0.shape)
    from .._kernels import load

    fn = load("ts_shell", "ts_shell_partials", [ctypes.c_longlong])
    return torch.empty(fn(delta0.numel()), dtype=torch.float64, device=delta0.device)


def ts_shell_reduce(delta0, step, consts, i, m, table, partials):
    """Launch the reduce of shell `i` (`step`, `consts[i]`, table mode `m`)
    over the filtered field `delta0` into `partials`.  `table` is the
    stacked SFRD table (gather) or fcoll table (CONST-ION-EFF), None under
    the Chebyshev fit.  Counted in `ts_shell_reduce.launches`."""
    _check("delta0", delta0, delta0.shape)
    row = _table_row(table, i, m, "fcoll" if m == MODE_CONST else "SFRD")
    refs = _consts_ref(step, consts, i)
    if partials.dtype != torch.float64 or partials.device != delta0.device:
        raise ValueError("partials must be float64 on delta0's device")
    from .._kernels import load

    fn = load("ts_shell", "ts_shell_reduce", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(delta0.device):
        err = fn(delta0.data_ptr(), row, partials.data_ptr(), delta0.numel(), m, *refs,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ts_shell_reduce kernel launch failed: cudaError {err}")
    ts_shell_reduce.launches += 1


def ts_shell_accumulate(delta0, prev_xe, accs, step, consts, i, m, table, partials, *,
                        use_xray_heat, use_lya_heat):
    """Launch the accumulate of shell `i` after its reduce: adds the shell's
    terms into `accs` (dxheat with X-ray heating, dxion, dxlya, dstarlya,
    dlya_cont and dlya_inj with Lya heating) in place.  `table` is the
    stacked SFRD table (gather, CONST-ION-EFF), None under the Chebyshev
    fit.  Counted in `ts_shell_accumulate.launches`."""
    _check("delta0", delta0, delta0.shape)
    _check("prev_xe", prev_xe, delta0.shape)
    names = ["dxion", "dxlya", "dstarlya"] + (["dxheat"] if use_xray_heat else []) \
        + (["dlya_cont", "dlya_inj"] if use_lya_heat else [])
    for n in names:
        _check(n, accs[n], delta0.shape)
    row = _table_row(table, i, m, "SFRD")
    refs = _consts_ref(step, consts, i)

    def ptr(n):
        return accs[n].data_ptr() if n in names else None

    from .._kernels import load

    fn = load("ts_shell", "ts_shell_accumulate", [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(delta0.device):
        err = fn(delta0.data_ptr(), prev_xe.data_ptr(), ptr("dxheat"), ptr("dxion"),
                 ptr("dxlya"), ptr("dstarlya"), ptr("dlya_cont"), ptr("dlya_inj"), row,
                 partials.data_ptr(), delta0.numel(), m, int(use_xray_heat),
                 int(use_lya_heat), *refs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ts_shell_accumulate kernel launch failed: cudaError {err}")
    ts_shell_accumulate.launches += 1


ts_shell_reduce.launches = 0
ts_shell_accumulate.launches = 0
