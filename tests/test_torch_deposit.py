"""The port's swept CIC deposit (py21cmfast_torch/ops/deposit.py) against the
JAX package's factored, staged and per-particle deposits.

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel itself
is held against that plain version by the `cuda`-marked test below and by
chip_smoke.py on the card.  Tolerance: max-abs 2e-4 on the accumulated mass,
as tests/test_components.py::test_factored_deposit_matches_scatter states it
(float32 sums of up to 8 R^3 terms in another order).
"""

import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py21cmfast_torch.ops import deposit as tdep
from py21cmfast_tpu.ops import cic as jcic
from py21cmfast_tpu.ops.deposit import factored_cic_deposit
from py21cmfast_tpu.ops.sep_deposit import staged_factored_deposit

ATOL = 2e-4
D_INIT = 0.5
D2C = 8 / 48.0  # lowres cells per Mpc of the test_components cases


def _case(R, nl=8, seed=0):
    rng = np.random.default_rng(seed + R)
    nh = nl * R
    hires = rng.normal(0, 0.1, (nh, nh, nh)).astype(np.float32)
    psi = [rng.normal(0, 1.0, (nl, nl, nl)).astype(np.float32) for _ in range(3)]
    return hires, psi


def _port(hires, d_cells, ratio):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (hires, *d_cells)]
    return tdep.cic_deposit_swept(*t, D_INIT, ratio).numpy()


def _jax_scatter(hires, d_cells, ratio):
    """cic.cic_scatter_flat over all DIM^3 particles at the resample-index map."""
    nl = d_cells[0].shape
    nh = hires.shape
    ii = [np.arange(n) for n in nh]
    maps = [((i * (l / h) + 0.5).astype(int)) % l for i, l, h in zip(ii, nl, nh)]
    I, J, K = np.meshgrid(*ii, indexing="ij")
    MI, MJ, MK = maps[0][I], maps[1][J], maps[2][K]
    pos = [grid / ratio + d[MI, MJ, MK] for grid, d in zip((I, J, K), d_cells)]
    acc = jcic.cic_scatter_flat(
        jnp.zeros(int(np.prod(nl)), jnp.float32),
        *(jnp.asarray(p.ravel(), jnp.float32) for p in pos),
        jnp.asarray((1.0 + hires * D_INIT).ravel()), tuple(nl),
    )
    return np.asarray(acc).reshape(nl)


@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_plain_deposit_matches_jax_deposits(R):
    """Small (fac 0.4) and out-of-support (fac 3.0, |d| > S = 1) displacements:
    the port equals the staged deposit (the JAX package's CPU path), the
    per-particle scatter and, for R <= 2 (its compile grows as R^3), the
    single-graph factored deposit."""
    hires, psi = _case(R)
    nl = psi[0].shape[0]
    kw = dict(ratio=R, support=1, cap=512, lo_shape=(nl, nl, nl))
    for fac in (0.4, 3.0):
        d_cells = [p * np.float32(fac * D2C) for p in psi]
        got = _port(hires, d_cells, R)
        jargs = (
            jnp.asarray(hires), tuple(jnp.asarray(p) for p in psi), None,
            jnp.float32(D_INIT), jnp.float32(fac), jnp.float32(0.0), (D2C,) * 3,
        )
        refs = {"staged": staged_factored_deposit(*jargs, **kw),
                "scatter": _jax_scatter(hires, d_cells, R)}
        if R <= 2:
            refs["factored"] = factored_cic_deposit(*jargs, **kw)
        for name, ref in refs.items():
            np.testing.assert_allclose(
                got, np.asarray(ref), rtol=0, atol=ATOL, err_msg=f"{name} R={R} fac={fac}"
            )


@pytest.mark.parametrize("R", [2, 3])
def test_plain_deposit_noncubic_matches_scatter(R):
    """Three different lowres extents (NON_CUBIC boxes), large displacements
    with negative positions and wrap on every axis."""
    rng = np.random.default_rng(11 + R)
    nl = (4, 6, 10)
    hires = rng.normal(0, 0.2, tuple(R * n for n in nl)).astype(np.float32)
    d_cells = [rng.normal(0, 2.0, nl).astype(np.float32) for _ in range(3)]
    got = _port(hires, d_cells, R)
    np.testing.assert_allclose(got, _jax_scatter(hires, d_cells, R), rtol=0, atol=ATOL)
    # mass is conserved exactly up to float32 summation
    assert np.isclose(got.astype(np.float64).sum(), (1.0 + hires.astype(np.float64) * D_INIT).sum(), rtol=1e-6)


def test_plain_deposit_ratio_one_on_hires_grid_matches_scatter():
    """R = 1, the PERTURB_ON_HIGH_RES shape: the out grid is the hires grid
    itself, every particle sits at its own cell plus its own displacement."""
    rng = np.random.default_rng(17)
    nh = (12, 10, 14)
    hires = rng.normal(0, 0.2, nh).astype(np.float32)
    d_cells = [rng.normal(0, 1.5, nh).astype(np.float32) for _ in range(3)]
    got = _port(hires, d_cells, 1)
    assert got.shape == nh
    np.testing.assert_allclose(got, _jax_scatter(hires, d_cells, 1), rtol=0, atol=ATOL)
    pos = [g + d for g, d in zip(np.meshgrid(*(np.arange(n, dtype=np.float32) for n in nh), indexing="ij"), d_cells)]
    direct = jcic.cic_scatter_flat(
        jnp.zeros(int(np.prod(nh)), jnp.float32), *(jnp.asarray(p.ravel()) for p in pos),
        jnp.asarray((1.0 + hires * D_INIT).ravel()), nh)
    np.testing.assert_allclose(got, np.asarray(direct).reshape(nh), rtol=0, atol=ATOL)


@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_plain_deposit_in_x_slabs_matches_the_whole_grid(R):
    """The plain version taken in hires x-slabs (as chip_smoke.py runs it at
    1024^3 -> 256^3, where the whole grid does not fit the card) against the
    whole grid at once, slabs that do not divide the rows included: the same
    per-particle arithmetic, the float32 sums of a cell in another order, so
    within 1e-5 of the cell's mass (of the mean mass where the cell holds
    less, as chip_smoke.check_deposit), and the same total mass."""
    hires, psi = _case(R, nl=8)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (hires, *(p * 3.0 for p in psi))]
    whole = tdep.cic_deposit_swept_plain(*t, D_INIT, R)
    for rows in (1, 3, 8 * R - 1, 8 * R):
        slabs = tdep.cic_deposit_swept_plain(*t, D_INIT, R, x_rows=rows)
        rel = (slabs - whole).abs() / torch.clamp_min(whole, whole.mean().item())
        assert rel.max().item() <= 1e-5, (rows, rel.max().item())
        np.testing.assert_allclose(slabs.double().sum().item(), whole.double().sum().item(),
                                   rtol=1e-6)
    np.testing.assert_array_equal(
        tdep.cic_deposit_swept_plain(*t, D_INIT, R, x_rows=8 * R).numpy(), whole.numpy())


def test_cpu_call_does_not_count_a_launch():
    hires, psi = _case(2, nl=4)
    tdep.cic_deposit_swept.launches = 0
    _port(hires, psi, 2)
    assert tdep.cic_deposit_swept.launches == 0


@pytest.mark.parametrize(
    "bad",
    ["hires_shape", "lo_shape", "dtype", "contiguity", "ratio"],
)
def test_wrapper_rejects_malformed_input(bad):
    hires = torch.zeros(8, 8, 8)
    d = [torch.zeros(4, 4, 4) for _ in range(3)]
    ratio = 2
    if bad == "hires_shape":
        hires = torch.zeros(8, 8, 6)
    elif bad == "lo_shape":
        d[1] = torch.zeros(4, 4, 3)
    elif bad == "dtype":
        d[2] = d[2].double()
    elif bad == "contiguity":
        hires = torch.zeros(8, 8, 8).transpose(0, 2)
    elif bad == "ratio":
        ratio = 0
    with pytest.raises((ValueError, TypeError)):
        tdep.cic_deposit_swept(hires, *d, D_INIT, ratio)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# (lowres shape, ratio, mean and sigma of the displacement in cells, sigma of
# the hires density, taken positive): extents
# below the kernel's shared tile and off its brick's multiples, R = 1, even
# and odd R, a ratio without a compiled-in loop, zero displacement, negative
# positions, and displacements that send most deposits past the tile
CUDA_CASES = [
    *(((16, 16, 24), R, 0.0, 2.0, 0.3) for R in (1, 2, 3, 4, 5)),
    ((4, 6, 10), 2, 0.0, 2.0, 0.3),
    ((4, 6, 10), 3, 0.0, 2.0, 0.3),
    ((24, 24, 24), 3, 0.0, 0.6, 0.3),
    ((20, 17, 33), 2, 0.0, 0.0, 0.3),
    ((20, 17, 33), 3, -7.5, 1.0, 0.3),
    ((40, 24, 36), 1, 0.0, 6.0, 0.3),
    ((40, 24, 36), 2, 0.0, 6.0, 0.3),
    ((40, 24, 36), 3, 0.0, 6.0, 0.3),
    ((40, 24, 36), 3, 0.0, 12.0, 0.3),
    # heavy masses: cells of the fixed-point tile wrap, heavy channels go global
    ((20, 17, 33), 1, 0.0, 0.6, 180.0),
    ((20, 17, 33), 3, 0.0, 0.6, 180.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("nl, R, mu, sigma, amp", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, nl, R, mu, sigma, amp):
    rng = np.random.default_rng(R)
    hires = torch.from_numpy(np.abs(rng.normal(0, amp, tuple(R * n for n in nl))).astype(np.float32))
    d = [torch.from_numpy(rng.normal(mu, sigma, nl).astype(np.float32)) for _ in range(3)]
    plain = tdep.cic_deposit_swept_plain(hires, *d, D_INIT, R)
    before = tdep.cic_deposit_swept.launches
    got = tdep.cic_deposit_swept(*(t.to(cuda_device) for t in (hires, *d)), D_INIT, R)
    torch.cuda.synchronize()
    assert tdep.cic_deposit_swept.launches == before + 1
    # float32 atomics in a run-dependent order: 1e-5 of the cell's mass, or
    # of the mean mass where the cell holds less (chip_smoke.check_deposit)
    rel = (got.cpu() - plain).abs() / torch.clamp_min(plain, plain.mean().item())
    assert rel.max().item() <= 1e-5
    total = (1.0 + hires.double() * D_INIT).sum().item()
    assert abs(got.double().sum().item() - total) <= 1e-6 * total


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: here the
    device check is reached with a meta tensor, which is neither."""
    hires = torch.zeros(8, 8, 8, device="meta")
    d = [torch.zeros(4, 4, 4, device="meta") for _ in range(3)]
    monkeypatch.setattr(tdep, "cic_deposit_swept_plain", lambda *a: pytest.fail("plain version called"))
    with pytest.raises(ValueError, match="unsupported device"):
        tdep.cic_deposit_swept(hires, *d, D_INIT, 2)
