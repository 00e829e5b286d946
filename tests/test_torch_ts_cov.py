"""The Thompson-chunk covariance kernel's plain version and wrapper against
``turbojax.pallas_kernels.fused_ts_cov``.

The TPU kernel body runs in the Pallas interpreter on the CPU, as
``tests/test_pallas.py`` runs kernel 1's: float32, atol 3e-5·outputscale
(the first rung of the TS ladder, ``acq._TS_EPS_RUNGS[0]``, which the ladder
adds to the diagonal anyway). In float64 the plain version is held to
k − vᵀv + jitter·I composed from the JAX package's functions, rtol 1e-12.
The diagonal is held to its exact value (see ``_exact_diagonal``).
Inputs are numpy-seeded and realistic: v = L⁻¹K(X, zs) from a fitted-size
training set, so vᵀv cancels most of k(zs, zs). The test of the CUDA kernel
itself is marked ``cuda`` and skips without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from turbojax import pallas_kernels as PK
from turbojax_torch import cuda_kernels as CK
from turbojax_torch import gp as TG
from turbojax_torch import kernels as TK
from turbojax_torch import linalg as TL
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

KERNEL_NAMES = ["rbf", "matern12", "matern32", "matern52"]
M, N = 256, 384
TS_ATOL = 3e-5  # × outputscale


def _problem(rng, d, name, outputscale=1.3, dtype=torch.float64):
    """Centered candidates zs (M, d) and v = L⁻¹K(X, zs) (N, M) in float64."""
    ell = np.sqrt(d / 6.0)
    x = rng.rand(N, d) / ell
    xs = rng.rand(M, d) / ell
    c = 0.5 * (x.mean(0) + xs.mean(0))
    zx, zs = torch.as_tensor(x - c), torch.as_tensor(xs - c)
    s = torch.tensor(outputscale, dtype=torch.float64)
    k_xx = CK.kernel_matrix_reference(zx, zx, s, torch.tensor(1e-2, dtype=torch.float64), name, True)
    k_xs = CK.kernel_matrix_reference(zx, zs, s, 0.0, name, False)
    v = torch.linalg.solve_triangular(torch.linalg.cholesky(k_xx), k_xs, upper=False)
    return zs.to(dtype), v.to(dtype)


def _pallas_interpret(zs, v, outputscale, jitter, kernel_name):
    """The TPU kernel body run by the Pallas interpreter on the CPU."""
    m, d = zs.shape
    n = v.shape[0]
    tile = PK._TILE
    scal = jnp.asarray([[outputscale, jitter]], jnp.float32)
    z = jnp.asarray(zs, jnp.float32)
    vv = jnp.asarray(v, jnp.float32)
    return pl.pallas_call(
        PK._ts_cov_body(kernel_name),
        out_shape=jax.ShapeDtypeStruct((m, m), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(m // tile, m // tile),
            in_specs=[
                pl.BlockSpec((tile, d), lambda i, j: (i, 0)),
                pl.BlockSpec((tile, d), lambda i, j: (j, 0)),
                pl.BlockSpec((n, tile), lambda i, j: (0, i)),
                pl.BlockSpec((n, tile), lambda i, j: (0, j)),
                pl.BlockSpec((1, 2), lambda i, j: (0, 0)),
            ],
            out_specs=pl.BlockSpec((tile, tile), lambda i, j: (i, j)),
        ),
        interpret=True,
    )(z, z, vv, vv, scal)


OFF = ~np.eye(M, dtype=bool)


def _exact_diagonal(zs, v, outputscale, jitter, name):
    """k(0)·s − Σv² + jitter in float64: the diagonal with d² = 0 exactly.
    The JAX package's expansion leaves d² ≈ eps·‖z‖² there, which
    Matérn-1/2 turns into an error of √(eps)·‖z‖ (about 1e-3 in f32, 1e-7
    in f64), so the diagonal is held to this value instead."""
    k0 = TK.from_sqdist(name, torch.zeros((), dtype=torch.float64), torch.tensor(outputscale, dtype=torch.float64))
    return (k0 - (v.double() ** 2).sum(dim=0) + jitter).numpy()


@pytest.mark.parametrize("d", [10, 60])
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_reference_matches_pallas_body_f32(name, d, rng):
    zs, v = _problem(rng, d, name, dtype=torch.float32)
    ref = np.asarray(_pallas_interpret(zs.numpy(), v.numpy(), 1.3, 1e-6, name))
    out = CK.ts_cov(zs, v, 1.3, 1e-6, name)
    assert out.dtype == torch.float32 and out.shape == (M, M)
    np.testing.assert_allclose(out.numpy()[OFF], ref[OFF], rtol=0, atol=TS_ATOL * 1.3)
    np.testing.assert_allclose(np.diag(out.numpy()), _exact_diagonal(zs, v, 1.3, 1e-6, name), rtol=0, atol=TS_ATOL * 1.3)
    # the cancellation is real: vᵀv removes most of k(zs, zs)
    k = CK.kernel_matrix_reference(zs, zs, 1.3, 0.0, name, False)
    assert float((k - out).abs().max()) > 0.1


@pytest.mark.parametrize("jitter", [0.0, 1e-6])
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_reference_matches_jax_composition_f64(name, jitter, rng):
    zs, v = _problem(rng, 60, name)
    zj, vj = jnp.asarray(zs.numpy()), jnp.asarray(v.numpy())
    ref = (PK._jnp_reference_kernel(zj, zj, jnp.asarray(1.3), jnp.asarray(0.0), name, False)
           - vj.T @ vj + jitter * jnp.eye(M))
    out = CK.ts_cov(zs, v, 1.3, jitter, name)
    np.testing.assert_allclose(out.numpy()[OFF], np.asarray(ref)[OFF], rtol=1e-12, atol=1e-12 * 1.3)
    np.testing.assert_allclose(np.diag(out.numpy()), _exact_diagonal(zs, v, 1.3, jitter, name), rtol=1e-12, atol=1e-12 * 1.3)
    np.testing.assert_array_equal(out.numpy(), CK.ts_cov_reference(zs, v, 1.3, jitter, name).numpy())


def test_batched_matches_per_chunk_and_diagonal_is_exact(rng):
    chunks = [_problem(rng, 10, "matern12") for _ in range(3)]
    zs = torch.stack([c[0] for c in chunks])
    v = torch.stack([c[1] for c in chunks])
    s = torch.tensor([1.0, 2.0, 0.5], dtype=torch.float64)
    jit = torch.tensor([0.0, 1e-6, 1e-3], dtype=torch.float64)
    CK.TS_COV_LAUNCHES = 0
    out = CK.ts_cov(zs, v, s, jit, "matern12")
    assert out.shape == (3, M, M) and CK.TS_COV_LAUNCHES == 0  # CPU tensors: the plain version
    for b in range(3):
        np.testing.assert_array_equal(out[b].numpy(), CK.ts_cov(zs[b], v[b], s[b], jit[b], "matern12").numpy())
    # k(z, z) on the diagonal is k at d² = 0 exactly (no eps·‖z‖²)
    k = CK.ts_cov(zs[0], torch.zeros(0, M, dtype=torch.float64), 1.7, 0.0, "matern12")
    assert np.all(np.diag(k.numpy()) == _exact_diagonal(zs[0], torch.zeros(1, 1), 1.7, 0.0, "matern12"))


@pytest.mark.parametrize(
    "zs_shape, v_shape, name",
    [((8, 3), (5, 7), "matern52"), ((8, 3), (5, 8), "cosine"), ((2, 8, 3), (5, 8), "rbf"),
     ((2, 8, 3), (3, 5, 8), "rbf")],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(zs_shape, v_shape, name):
    with pytest.raises(ValueError):
        CK.ts_cov(torch.zeros(zs_shape), torch.zeros(v_shape), 1.0, 0.0, name)


def test_posterior_cov_goes_through_ts_cov_and_equals_the_plain_lane(rng):
    """gp.posterior_cov: the wrapper route (use_kernel=None) and the plain
    route (use_kernel=False) agree bit for bit on the CPU, and the
    covariance equals k(xs, xs) − vᵀv built by hand from the state."""
    d, n_max, n = 5, 40, 30
    x = np.zeros((n_max, d))
    x[:n] = rng.rand(n, d)
    y = np.zeros(n_max)
    y[:n] = np.sin(4 * x[:n, 0]) + x[:n, 1]
    xs = torch.as_tensor(rng.rand(64, d))
    mask = TL.row_mask(n_max, n)
    out = {}
    for use_kernel in (None, False):
        cfg = GPConfig(kernel="matern52", fit_optimizer="grid", use_kernel=use_kernel)
        state = TG.fit_gp(torch.as_tensor(x), torch.as_tensor(y), mask, cfg)
        out[use_kernel] = TG.posterior_cov(state, xs, cfg, standardized=True)
    np.testing.assert_array_equal(out[None][1].numpy(), out[False][1].numpy())
    k_cross = TL.mask_cross_matrix(TG._kernel_matrix(state.params, state.x_buf, xs, cfg, False), mask)
    v = TL.solve_lower(state.chol, k_cross)
    by_hand = TG._kernel_matrix(state.params, xs, xs, cfg, False) - v.mT @ v
    np.testing.assert_allclose(out[None][1].numpy(), by_hand.numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_kernel_matches_plain_version(dtype, rng):
    if not CK.available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    CK.TS_COV_LAUNCHES = 0
    for name in KERNEL_NAMES:
        zs, v = _problem(rng, 60, name)
        for m, n in ((M, N), (200, 131), (1, 1)):
            z = zs[:m].to(dt).cuda()
            vv = v[:n, :m].to(dt).cuda()
            got = CK.ts_cov(z, vv, 1.3, 1e-6, name)
            ref = CK.ts_cov_reference(z, vv, 1.3, 1e-6, name)
            atol = TS_ATOL * 1.3 if dt == torch.float32 else 1e-12 * 1.3
            torch.testing.assert_close(got, ref, rtol=0, atol=atol)
    assert CK.TS_COV_LAUNCHES == 12
