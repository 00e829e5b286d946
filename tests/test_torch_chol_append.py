"""The incremental Cholesky of the port against ``turbojax.linalg`` in
float64: ``chol_append`` and ``chol_append_batch`` row for row at atol
1e-12 (inactive rows stay the identity's, row n is [b, pivot, 0...]),
against a full refactorization at 1e-10, the pivot's floor, and
``dense_chol_solve`` with and without jitter. The buffer handed in must
stay as it was: a carry may still alias it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbojax import linalg as JL
from turbojax_torch import linalg as TL

torch.set_num_threads(1)

N_MAX, D = 24, 3
ATOL = 1e-12


def _kernel(x1, x2):
    return 1.3 * np.exp(-0.5 * ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1) / 0.4**2)


def _problem(seed, n):
    rng = np.random.RandomState(seed)
    x = np.zeros((N_MAX, D))
    x[:n] = rng.rand(n, D)
    k = _kernel(x, x) + 1e-2 * np.eye(N_MAX)
    mask = np.arange(N_MAX) < n
    k_masked = np.where(mask[:, None] & mask[None, :], k, np.eye(N_MAX))
    return rng, x, np.linalg.cholesky(k_masked)


@pytest.mark.parametrize("n", [0, 1, 7, N_MAX - 1])
def test_chol_append_matches_jax_and_a_refactorization(n):
    rng, x, l_buf = _problem(n, n)
    x_new = rng.rand(D)
    x[n] = x_new
    k_vec = _kernel(x, x_new[None])[:, 0]
    k_vec[n:] = rng.randn(N_MAX - n)  # entries at index >= n are ignored
    k_nn = 1.3 + 1e-2
    before = l_buf.copy()
    l_t = torch.as_tensor(l_buf)
    got = TL.chol_append(l_t, n, torch.as_tensor(k_vec), torch.tensor(k_nn, dtype=torch.float64))
    ref = np.asarray(JL.chol_append(jnp.asarray(l_buf), jnp.asarray(n), jnp.asarray(k_vec), jnp.asarray(k_nn)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(l_t.numpy(), before)  # the input factor is untouched
    mask = np.arange(N_MAX) < n + 1
    k_full = _kernel(x, x) + 1e-2 * np.eye(N_MAX)
    full = np.linalg.cholesky(np.where(mask[:, None] & mask[None, :], k_full, np.eye(N_MAX)))
    np.testing.assert_allclose(got.numpy(), full, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.numpy()[n + 1:], np.eye(N_MAX)[n + 1:])  # inactive rows
    assert np.all(got.numpy()[n, n + 1:] == 0.0)


@pytest.mark.parametrize("n,q", [(0, 3), (5, 1), (9, 4), (N_MAX - 4, 4)])
def test_chol_append_batch_matches_jax_and_a_refactorization(n, q):
    rng, x, l_buf = _problem(10 + n, n)
    x_new = rng.rand(q, D)
    x[n:n + q] = x_new  # the block is built against the buffer after the write
    k_block = _kernel(x_new, x)
    k_diag = np.full(q, 1.3 + 1e-2)
    got = TL.chol_append_batch(torch.as_tensor(l_buf), n, torch.as_tensor(k_block), torch.as_tensor(k_diag), q)
    ref = np.asarray(JL.chol_append_batch(jnp.asarray(l_buf), jnp.asarray(n), jnp.asarray(k_block),
                                          jnp.asarray(k_diag), q))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    mask = np.arange(N_MAX) < n + q
    k_full = _kernel(x, x) + 1e-2 * np.eye(N_MAX)
    full = np.linalg.cholesky(np.where(mask[:, None] & mask[None, :], k_full, np.eye(N_MAX)))
    np.testing.assert_allclose(got.numpy(), full, rtol=0, atol=1e-10)


def test_chol_append_floors_the_pivot_and_guards_the_capacity():
    rng, x, l_buf = _problem(3, 6)
    k_vec = _kernel(x, x[2][None])[:, 0]  # a duplicate of row 2 with no noise: the Schur complement is negative
    k_nn = torch.tensor(1.3 - 0.5, dtype=torch.float64)
    got = TL.chol_append(torch.as_tensor(l_buf), 6, torch.as_tensor(k_vec), k_nn, floor=1e-10)
    ref = np.asarray(JL.chol_append(jnp.asarray(l_buf), jnp.asarray(6), jnp.asarray(k_vec), jnp.asarray(float(k_nn))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    assert float(got[6, 6]) == pytest.approx(1e-5, rel=1e-12)  # sqrt(floor)
    with pytest.raises(ValueError):
        TL.chol_append(torch.as_tensor(l_buf), N_MAX, torch.as_tensor(k_vec), k_nn)
    with pytest.raises(ValueError):
        TL.chol_append_batch(torch.as_tensor(l_buf), N_MAX - 1, torch.zeros(2, N_MAX, dtype=torch.float64),
                             torch.ones(2, dtype=torch.float64), 2)


@pytest.mark.parametrize("jitter", [0.0, 1e-6])
def test_dense_chol_solve_matches_jax(jitter, rng):
    x = rng.rand(15, D)
    k = _kernel(x, x) + 1e-3 * np.eye(15)
    y = rng.randn(15)
    l_t, a_t = TL.dense_chol_solve(torch.as_tensor(k), torch.as_tensor(y), jitter)
    # under its jit the JAX function cannot take a jitter (it branches on the traced value): call its body then
    ref_fn = JL.dense_chol_solve.__wrapped__ if jitter else JL.dense_chol_solve
    l_j, a_j = ref_fn(jnp.asarray(k), jnp.asarray(y), *((jitter,) if jitter else ()))
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(k @ a_t.numpy(), y, rtol=1e-6, atol=1e-3 if jitter else 1e-9)  # the jittered system is (K + jitter) a = y


def test_dense_chol_solve_failed_factor_is_nan():
    k = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)  # indefinite
    l_t, a_t = TL.dense_chol_solve(k, torch.ones(2, dtype=torch.float64))
    assert bool(torch.isnan(l_t).any()) and bool(torch.isnan(a_t).all())
