"""The spin temperature's fused shell kernels (py21cmfast_torch/ops/ts_shell.py,
csrc/ts_shell.cu) and the shell scan's choice of path.

On the CPU: the by-value shell constants of `packed_shells` against
`shells_from_tables`, bit for bit, over real `ts_host_tables` ladders (the
package's default box, 40 shells); the path choice; the wrapper's checks,
which raise before any library is loaded.  This file imports no JAX, so the
`cuda`-marked tests run on the card with

    python -m pytest tests/test_torch_ts_shell.py -m cuda --noconftest -q -p no:cacheprovider

They hold the kernels to the plain torch path on the same card at 64^3 and
256^3 over the same ladders: each accumulator within a relative L2 of 1e-5
(the kernels round every operation as the plain path does, but divide by a
host scalar where PyTorch multiplies by its reciprocal, and sum the shell's
mean in another order: double partials against PyTorch's float tree), two
runs bit-identical, two launches a shell and `ts.kernel_shells` equal to
the shells.
"""

import ctypes

import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

import py21cmfast_torch as p21
from py21cmfast_torch import _kernels, tracing
from py21cmfast_torch.models import heating
from py21cmfast_torch.models import spintemp as tsp
from py21cmfast_torch.ops import ts_shell

Z, PF_Z, PREV_Z, XE_AVE = 25.0, 25.0, 25.5, 2e-4
BOX_LEN = 384.0
CASES = {
    "latest-chebyshev": ("latest", {}, False),
    "latest-gather": ("latest", {}, True),
    "const-zeta": ("const-zeta", {}, False),
    "no-lya-heating": ("latest", dict(USE_LYA_HEATING=False), False),
}
SCALARS = {  # ShellConsts field: shells_from_tables key
    "R": "R", "growth": "growth", "zfac": "zfac", "xr_fac": "xr_fac", "d_lo": "d_lo",
    "d_hi": "d_hi", "cap": "cap", "mean_sfrd": "mean_sfrd", "p_star": "p_star",
    "p_cont": "p_cont", "p_inj": "p_inj", "cheb_edge": "cheb_edge",
}


def _bits(values):
    return np.asarray(values, np.float32).view(np.uint32)


@pytest.fixture(scope="module", params=list(CASES))
def host(request):
    """A case's host tables at z=25 in the package's default box."""
    template, over, gather = CASES[request.param]
    inputs = p21.InputParameters.from_template(template, random_seed=5).evolve_input_structs(
        **over)
    with pytest.MonkeyPatch.context() as mp:
        if gather:
            fit = tsp._fit_log_cheby
            mp.setattr(tsp, "_fit_log_cheby", lambda t, c: (*fit(t, c)[:2], False))
        h = tsp.ts_host_tables(Z, inputs, PF_Z, PREV_Z, XE_AVE)
    return request.param, inputs, h


@pytest.mark.parametrize("struct, floats", [(ts_shell.ShellConsts, 71), (ts_shell.StepConsts, 16)])
def test_the_structs_are_packed_floats(struct, floats):
    """csrc/ts_shell.cu's static_asserts hold the C side to the same sizes."""
    assert ctypes.sizeof(struct) == floats * 4
    offsets = [getattr(struct, name).offset for name, _ in struct._fields_]
    assert offsets == sorted(offsets) and offsets[0] == 0


def test_the_step_constants_are_the_scans_float32_arguments(host):
    """The step's struct, as `_ts_shell_scan_kernels` makes it from the
    scan's arguments, holds them and the x_e knots as float32, bit for bit."""
    _, _, h = host
    inv_growth_pf = float(np.float32(h["consts"]["inv_growth_pf"]))
    fstar10 = float(np.float32(h["fstar10"]))
    step = ts_shell.StepConsts(inv_growth_pf, fstar10, tuple(heating.X_INT_XHII))
    assert _bits(step.inv_growth_pf) == _bits(inv_growth_pf)
    assert _bits(step.fstar10) == _bits(fstar10)
    assert (_bits(list(step.xhii)) == _bits(np.asarray(heating.X_INT_XHII, np.float32))).all()


def test_packed_shells_equal_shells_from_tables(host):
    """Every field of every shell's by-value struct is the float32 that
    `shells_from_tables` hands the torch path, bit for bit, and the stacked
    gather tables are its per-shell tensors."""
    case, _, h = host
    pack = tsp.packed_shells(h, "cpu")
    shells = tsp.shells_from_tables(h, "cpu")
    assert len(pack) == len(shells) == 40
    assert h["use_cheby"] == (case not in ("latest-gather", "const-zeta"))
    assert h["const_model"] == (case == "const-zeta")
    for i, (c, sh) in enumerate(zip(pack.consts, shells)):
        for field, key in SCALARS.items():
            assert _bits(getattr(c, field)) == _bits(sh[key]), (case, i, field)
        assert (_bits(list(c.cheb)) == _bits(sh["cheb"])).all(), (case, i)
        for name in ("tbl_heat", "tbl_ion", "tbl_lya"):
            assert (_bits(list(getattr(c, name))) == _bits(sh[name].numpy())).all(), (case, i, name)
        assert c.R == sh["R"] and pack.do_filter[i] == sh["do_filter"]
        if sh["table"] is None:
            assert pack.sfrd is None
        else:
            assert torch.equal(pack.sfrd[i], sh["table"])
        if sh["table_fc"] is None:
            assert pack.fc is None
        else:
            assert torch.equal(pack.fc[i], sh["table_fc"])
    if case == "no-lya-heating":
        assert all(c.p_cont == 0.0 and c.p_inj == 0.0 for c in pack.consts)


def test_packed_shells_upload_the_tables_once(host):
    """No upload under the Chebyshev fit, one (n_shell, 400) upload under the
    gather, one (2, n_shell, 400) under CONST-ION-EFF."""
    case, _, h = host
    before = tracing.totals()["counters"].get("h2d.uploads", {})
    pack = tsp.packed_shells(h, "cpu")
    after = tracing.totals()["counters"].get("h2d.uploads", {})
    uploads = sum(after.values()) - sum(before.values())
    assert uploads == (0 if h["use_cheby"] else 1)
    if pack.sfrd is not None:
        assert tuple(pack.sfrd.shape) == (40, tsp.N_DELTA_SFRD) and pack.sfrd.is_contiguous()


# (on CUDA, Eulerian sources, minihalos, slab-sharded) -> kernels
PATHS = {
    "cuda-eulerian-acg": ((True, True, False, False), True),
    "cpu": ((False, True, False, False), False),
    "minihalos": ((True, True, True, False), False),
    "lagrangian": ((True, False, False, False), False),
    "sharded": ((True, True, False, True), False),
}


@pytest.mark.parametrize("case", list(PATHS))
def test_the_path_choice(case):
    observed, want = PATHS[case]
    assert ts_shell.takes_kernels(*observed) is want


def _grids(n, seed=0, device="cpu"):
    """A lognormal density (z = 25 amplitudes) and an x_e spanning the
    knots, float32 on `device`."""
    rng = np.random.default_rng(seed)
    g = rng.normal(0.0, 0.4, (n, n, n))
    dens = np.exp(g - 0.08) - 1.0
    xe = 10.0 ** rng.uniform(-4.0, -0.5, (n, n, n))
    return (torch.as_tensor(dens, dtype=torch.float32, device=device),
            torch.as_tensor(xe, dtype=torch.float32, device=device))


def _scan(inputs, h, dens, xe, shells, n, **extra):
    return tsp._ts_shell_scan(
        dens, xe, shells, float(np.float32(h["consts"]["inv_growth_pf"])),
        float(np.float32(h["fstar10"])), shape=(n, n, n), box_lens=(BOX_LEN,) * 3,
        heat_filter=inputs.astro_options.heat_filter_int,
        use_xray_heat=True, use_lya_heat=h["use_lya_heat"], use_cheby=h["use_cheby"],
        const_model=h["const_model"], **extra)


def _no_library(monkeypatch):
    monkeypatch.setattr(_kernels, "load", lambda *a, **k: pytest.fail("a library was loaded"))


def test_the_cpu_scan_runs_the_torch_code_and_books_no_kernel_shell(monkeypatch, host):
    """The list of `shells_from_tables` takes the torch code: no library,
    `ts.kernel_shells` 0; the packed shells take the kernels, which refuse
    CPU tensors, Lagrangian sources and minihalos before any load."""
    _, inputs, h = host
    dens, xe = _grids(8)
    _no_library(monkeypatch)
    before = sum(tracing.totals()["counters"].get("ts.kernel_shells", {}).values())
    accs = _scan(inputs, h, dens, xe, tsp.shells_from_tables(h, "cpu"), 8)
    assert sum(tracing.totals()["counters"].get("ts.kernel_shells", {}).values()) == before
    assert len(accs) == len(tsp._accumulator_names(True, h["use_lya_heat"]))
    assert all(bool(torch.isfinite(a).all()) for a in accs)
    pack = tsp.packed_shells(h, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        _scan(inputs, h, dens, xe, pack, 8)
    for extra in (dict(source={"sfr": dens, "xray": dens}), dict(mcrit_box=dens)):
        with pytest.raises(ValueError, match="single-device Eulerian"):
            _scan(inputs, h, dens, xe, pack, 8, **extra)


BAD_GRIDS = {
    "cpu": (lambda: torch.zeros(4, 4, 4), ValueError),
    "float64": (lambda: torch.zeros(4, 4, 4, dtype=torch.float64), TypeError),
    "non-contiguous": (lambda: torch.zeros(4, 4, 8)[:, :, ::2], ValueError),
}


@pytest.mark.parametrize("case", list(BAD_GRIDS))
def test_the_wrappers_raise_before_loading_a_library(monkeypatch, case):
    _no_library(monkeypatch)
    make, error = BAD_GRIDS[case]
    delta0, xe = make(), torch.zeros(4, 4, 4)
    accs = {n: torch.zeros(4, 4, 4) for n in tsp._accumulator_names(True, True)}
    step, consts = ts_shell.StepConsts(), (ts_shell.ShellConsts * 2)()
    partials = torch.zeros(1, dtype=torch.float64)
    with pytest.raises(error):
        ts_shell.ts_shell_reduce(delta0, step, consts, 0, ts_shell.MODE_CHEBY, None, partials)
    with pytest.raises(error):
        ts_shell.ts_shell_accumulate(delta0, xe, accs, step, consts, 0, ts_shell.MODE_CHEBY,
                                     None, partials, use_xray_heat=True, use_lya_heat=True)
    with pytest.raises(error):
        ts_shell.partials_buffer(delta0)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel_l2(got, ref):
    got, ref = got.double(), ref.double()
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 256])
def test_kernels_match_the_plain_path(cuda_device, host, n):
    case, inputs, h = host
    dens, xe = _grids(n, seed=n, device=cuda_device)
    pack = tsp.packed_shells(h, cuda_device)
    counts0 = (ts_shell.ts_shell_reduce.launches, ts_shell.ts_shell_accumulate.launches,
               sum(tracing.totals()["counters"].get("ts.kernel_shells", {}).values()))
    got = _scan(inputs, h, dens, xe, pack, n)
    again = _scan(inputs, h, dens, xe, pack, n)
    torch.cuda.synchronize()
    counts = (ts_shell.ts_shell_reduce.launches, ts_shell.ts_shell_accumulate.launches,
              sum(tracing.totals()["counters"]["ts.kernel_shells"].values()))
    assert [b - a for a, b in zip(counts0, counts)] == [2 * len(pack)] * 3
    ref = _scan(inputs, h, dens, xe, tsp.shells_from_tables(h, cuda_device), n)
    names = tsp._accumulator_names(True, h["use_lya_heat"])
    assert len(got) == len(ref) == len(names)
    for name, g, a, r in zip(names, got, again, ref):
        assert torch.equal(g, a), f"{case} {n}^3 {name}: two runs differ"
        assert bool(torch.isfinite(g).all()), name
        if float(r.abs().max()) == 0.0:
            assert float(g.abs().max()) == 0.0, name
            continue
        err = _rel_l2(g, r)
        assert err <= 1e-5, f"{case} {n}^3 {name}: relative L2 {err:.3e}"
