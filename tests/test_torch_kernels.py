"""The port's kernels and its CUDA kernel wrapper against ``turbojax``.

Same numpy-seeded inputs through both packages, float64 under the
conftest's x64 setting unless a test is about float32. Tolerances:
deterministic f64 functions rtol 1e-9 / atol 1e-12; the f32 Pallas-body
comparison uses the Pallas tests' rtol 2e-5 / atol 2e-6. On the CPU the
wrapper computes the plain version; the test of the CUDA kernel itself is
marked ``cuda`` and skips without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from turbojax import kernels as JK
from turbojax import pallas_kernels as PK
from turbojax_torch import cuda_kernels as CK
from turbojax_torch import gp as TG
from turbojax_torch import kernels as TK
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

KERNEL_NAMES = ["rbf", "matern12", "matern32", "matern52"]
F64 = dict(rtol=1e-9, atol=1e-12)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernels_match_jax(name, rng):
    x1, x2 = rng.rand(17, 6), rng.rand(11, 6)
    ls, s = rng.uniform(0.3, 1.5, 6), 1.7
    ref = JK.get_kernel(name)({"lengthscale": jnp.asarray(ls), "outputscale": jnp.asarray(s)},
                              jnp.asarray(x1), jnp.asarray(x2))
    out = TK.get_kernel(name)({"lengthscale": _t(ls), "outputscale": _t(s)}, _t(x1), _t(x2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F64)


def test_pairwise_sqdist_and_diag_match_jax(rng):
    x1, x2 = rng.rand(9, 4) + 3.0, rng.rand(7, 4) + 3.0
    np.testing.assert_allclose(
        TK.pairwise_sqdist(_t(x1), _t(x2)).numpy(),
        np.asarray(JK.pairwise_sqdist(jnp.asarray(x1), jnp.asarray(x2))), **F64)
    x = _t(x1)
    same = TK.pairwise_sqdist(x, x)
    np.testing.assert_allclose(same.numpy(), np.asarray(JK.pairwise_sqdist(jnp.asarray(x1), jnp.asarray(x1))), **F64)
    assert np.all(np.diag(same.numpy()) == 0.0)  # K(X, X)'s diagonal is exact
    params = {"lengthscale": _t(np.ones(4)), "outputscale": _t(2.5)}
    np.testing.assert_array_equal(
        TK.kernel_diag(params, x).numpy(),
        np.asarray(JK.kernel_diag({"outputscale": jnp.asarray(2.5)}, jnp.asarray(x1))))


@pytest.mark.parametrize("add_noise", [False, True])
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_reference_matches_jnp_reference_kernel(name, add_noise, rng):
    z1, z2 = rng.randn(12, 5), rng.randn(12, 5)
    ref = PK._jnp_reference_kernel(jnp.asarray(z1), jnp.asarray(z2), jnp.asarray(1.3),
                                   jnp.asarray(0.05), name, add_noise)
    out = CK.kernel_matrix_reference(_t(z1), _t(z2), _t(1.3), _t(0.05), name, add_noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F64)


def _pallas_interpret(z1, z2, outputscale, noise, kernel_name, add_noise):
    """The TPU kernel body run by the Pallas interpreter on the CPU."""
    n, d = z1.shape
    m = z2.shape[0]
    scal = jnp.asarray([[outputscale, noise]], jnp.float32)
    return pl.pallas_call(
        PK._kernel_body(kernel_name, add_noise),
        out_shape=jax.ShapeDtypeStruct((n, m), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(n // PK._TILE, m // PK._TILE),
            in_specs=[
                pl.BlockSpec((PK._TILE, d), lambda i, j: (i, 0)),
                pl.BlockSpec((PK._TILE, d), lambda i, j: (j, 0)),
                pl.BlockSpec((1, 2), lambda i, j: (0, 0)),
            ],
            out_specs=pl.BlockSpec((PK._TILE, PK._TILE), lambda i, j: (i, j)),
        ),
        interpret=True,
    )(jnp.asarray(z1, jnp.float32), jnp.asarray(z2, jnp.float32), scal)


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_reference_matches_pallas_body(name, rng):
    z1 = (rng.rand(256, 10) - 0.5) * 3
    z2 = (rng.rand(128, 10) - 0.5) * 3
    ref = np.asarray(_pallas_interpret(z1, z2, 1.7, 0.0, name, False))
    out = CK.kernel_matrix(_t(z1, torch.float32), _t(z2, torch.float32), 1.7, 0.0, name, False)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-6)


def test_reference_matches_pallas_body_noise_diagonal(rng):
    z = (rng.rand(128, 4) - 0.5) * 2
    ref = np.asarray(_pallas_interpret(z, z, 1.0, 0.25, "matern52", True))
    zt = _t(z, torch.float32)
    out = CK.kernel_matrix(zt, zt, 1.0, 0.25, "matern52", True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-6)


def test_f32_clustered_inputs_match_f64(rng):
    """A trust region of side 0.5**7 at a small lengthscale: the centering
    in gp._kernel_matrix keeps the f32 expansion within f32 tolerance of the
    f64 result, where the uncentered expansion loses the signal."""
    c0 = rng.rand(1, 10)
    x1 = c0 + 0.5**7 * (rng.rand(64, 10) - 0.5)
    x2 = c0 + 0.5**7 * (rng.rand(48, 10) - 0.5)
    config = GPConfig(kernel="matern52")

    # f64 from the same f32-rounded inputs: what is compared is the arithmetic
    x1_32, x2_32 = x1.astype(np.float32), x2.astype(np.float32)

    def build(dtype):
        params = {"lengthscale": torch.full((10,), 0.01, dtype=dtype), "outputscale": torch.tensor(1.0, dtype=dtype),
                  "noise": torch.tensor(1e-4, dtype=dtype)}
        return TG._kernel_matrix(params, _t(x1_32, dtype), _t(x2_32, dtype), config, add_noise=False)

    k32, k64 = build(torch.float32).double(), build(torch.float64)
    np.testing.assert_allclose(k32.numpy(), k64.numpy(), rtol=2e-5, atol=2e-6)
    z1, z2 = _t(x1 / 0.01, torch.float32), _t(x2 / 0.01, torch.float32)
    naive = (z1 * z1).sum(-1)[:, None] + (z2 * z2).sum(-1)[None, :] - 2 * z1 @ z2.T
    exact = TK.pairwise_sqdist(_t(x1 / 0.01), _t(x2 / 0.01))
    assert float((naive.double() - exact).abs().max()) > 1e-2  # what centering prevents


@pytest.mark.parametrize("name", ["rbf", "matern52"])
def test_autograd_wrapper_gradcheck(name):
    g = torch.Generator().manual_seed(0)
    z1 = torch.randn(5, 3, generator=g, dtype=torch.float64, requires_grad=True)
    z2 = torch.randn(4, 3, generator=g, dtype=torch.float64, requires_grad=True)
    s = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    nz = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, c, e: CK.KernelMatrix.apply(a, b, c, e, name, True), (z1, z2, s, nz))
    # K(Z, Z): one input passed twice, one gradient
    assert torch.autograd.gradcheck(lambda a, c: CK.KernelMatrix.apply(a, a, c, nz, name, False), (z1, s))


def test_cpu_tensors_never_launch_the_kernel(rng):
    CK.LAUNCHES = 0
    z = _t(rng.rand(3, 20, 4))
    out = CK.kernel_matrix(z, z, _t(np.ones(3)), _t(np.full(3, 0.1)), "matern52", True)
    assert out.shape == (3, 20, 20)
    np.testing.assert_allclose(out[1].diagonal().numpy(), 1.1, rtol=1e-12)
    assert CK.LAUNCHES == 0


@pytest.mark.parametrize(
    "shapes, name, error",
    [(((4, 3), (5, 2)), "matern52", ValueError), (((4, 3), (5, 3)), "cosine", ValueError),
     (((2, 4, 3), (5, 3)), "rbf", ValueError)],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(shapes, name, error):
    a, b = (torch.zeros(s, dtype=torch.float64) for s in shapes)
    with pytest.raises(error):
        CK.kernel_matrix(a, b, 1.0, 0.0, name, False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not CK.available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    tol = dict(rtol=2e-5, atol=2e-6) if dt == torch.float32 else dict(rtol=1e-12, atol=0.0)
    CK.LAUNCHES = 0
    # ragged cross matrices; K(Z, Z) at ragged sizes of the symmetric schedule,
    # d past the 64 features staged at once; config 5's 64-row grid batch at
    # the 512 rung
    shapes = ((2, 1, 1, 10), (2, 130, 257, 10), (2, 300, 300, 10), (2, 63, 63, 60), (2, 65, 65, 60),
              (1, 999, 999, 70), (64, 512, 512, 60))
    for name in KERNEL_NAMES:
        for batch, n, m, d in shapes:
            z1 = torch.randn(batch, n, d, generator=g, device="cuda", dtype=dt) / 3
            z2 = z1 if n == m else torch.randn(batch, m, d, generator=g, device="cuda", dtype=dt) / 3
            s = torch.linspace(1.0, 2.0, batch, device="cuda", dtype=dt)
            nz = torch.linspace(0.1, 0.01, batch, device="cuda", dtype=dt)
            got = CK.kernel_matrix(z1, z2, s, nz, name, True)
            torch.testing.assert_close(got, CK.kernel_matrix_reference(z1, z2, s, nz, name, True), **tol)
            assert torch.equal(got, CK.kernel_matrix(z1, z2, s, nz, name, True))  # run to run
            if z2 is z1:
                assert torch.equal(got, got.mT)
                if dt == torch.float32:  # d² = 0 exactly, and k(0) rounds to 1
                    assert torch.equal(got.diagonal(dim1=-2, dim2=-1), (s + nz)[:, None].expand(batch, n))
    assert CK.LAUNCHES == 2 * len(KERNEL_NAMES) * len(shapes)
