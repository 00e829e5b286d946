"""The port's masked linear algebra against ``turbojax.linalg`` (f64), and
its Cholesky failure semantics: ``torch.linalg.cholesky_ex`` returns a
partial finite factor where ``jnp.linalg.cholesky`` returns NaN, so every
ladder keys on ``info`` and a failed factor is NaN. Tolerance rtol 1e-9 /
atol 1e-12 (deterministic f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbojax import gp as JG
from turbojax import linalg as JL
from turbojax.config import GPConfig as JGPConfig
from turbojax_torch import gp as TG
from turbojax_torch import linalg as TL
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-12)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _spd(rng, n):
    a = rng.randn(n, n)
    return a @ a.T + n * np.eye(n)


def test_masked_equals_dense_and_matches_jax(rng):
    n_max, n = 20, 12
    k = _spd(rng, n_max)
    mask_np = np.arange(n_max) < n
    b = np.where(mask_np, rng.randn(n_max), 0.0)
    mask = TL.row_mask(n_max, n)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(JL.row_mask(n_max, n)))

    km = TL.mask_kernel_matrix(_t(k), mask)
    np.testing.assert_array_equal(km.numpy(), np.asarray(JL.mask_kernel_matrix(jnp.asarray(k), jnp.asarray(mask_np))))
    chol = TL.cholesky_jittered(km, 1e-6)
    np.testing.assert_allclose(chol.numpy(), np.asarray(JL.cholesky_jittered(jnp.asarray(km.numpy()), 1e-6)), **F64)
    np.testing.assert_allclose(chol[n:, n:].numpy(), np.eye(n_max - n) * chol[n, n].item(), **F64)

    chol0 = TL.safe_cholesky(km, (0.0,))
    dense = np.linalg.cholesky(k[:n, :n])
    np.testing.assert_allclose(chol0[:n, :n].numpy(), dense, **F64)
    x = TL.cho_solve(chol0, _t(b))
    np.testing.assert_allclose(x[:n].numpy(), np.linalg.solve(k[:n, :n], b[:n]), **F64)
    assert np.all(x[n:].numpy() == 0.0)
    np.testing.assert_allclose(x.numpy(), np.asarray(JL.cho_solve(jnp.asarray(chol0.numpy()), jnp.asarray(b))), **F64)
    logdet = TL.masked_logdet_from_chol(chol0, mask)
    np.testing.assert_allclose(float(logdet), np.linalg.slogdet(k[:n, :n])[1], **F64)
    cross = rng.randn(n_max, 7)
    np.testing.assert_array_equal(
        TL.mask_cross_matrix(_t(cross), mask).numpy(),
        np.asarray(JL.mask_cross_matrix(jnp.asarray(cross), jnp.asarray(mask_np))))
    v = TL.solve_lower(chol0, TL.mask_cross_matrix(_t(cross), mask))
    np.testing.assert_allclose(v.numpy(), np.asarray(JL.solve_lower(jnp.asarray(chol0.numpy()),
                                                                    jnp.asarray(np.where(mask_np[:, None], cross, 0.0)))), **F64)


def test_failed_factor_is_nan_not_the_partial_factor():
    a = torch.ones(5, 5, dtype=torch.float64)  # rank 1: potrf fails at the second pivot
    partial, info = torch.linalg.cholesky_ex(a)
    assert int(info) != 0 and bool(torch.isfinite(partial).all())  # the trap
    l_mat, info2 = TL.cholesky_nan(a)
    lower = torch.tril_indices(5, 5)
    assert int(info2) == int(info) and bool(torch.isnan(l_mat[lower[0], lower[1]]).all())
    np.testing.assert_array_equal(l_mat.numpy(), np.asarray(jnp.linalg.cholesky(jnp.asarray(a.numpy()))))


@pytest.mark.parametrize("kind", ["pd", "rank1", "indefinite"])
def test_jitter_ladder_keys_on_info_and_matches_jax(kind, rng):
    if kind == "pd":
        k = _spd(rng, 6)
    elif kind == "rank1":
        u = rng.rand(6)
        k = np.outer(u, u) + 0.5  # PSD, singular: the 0 rung fails, a jitter rung succeeds
    else:
        k = np.diag([1.0, 1.0, -1.0, 1.0, 1.0, 1.0])  # fails on every rung
    jitters = (0.0, 1e-8, 1e-6, 1e-4)
    got = TL.safe_cholesky(_t(k), jitters).numpy()
    ref = np.asarray(JL.safe_cholesky(jnp.asarray(k), jitters))
    np.testing.assert_allclose(got, ref, **F64)  # NaN where JAX has NaN
    assert np.all(np.isfinite(got)) == (kind != "indefinite")


def test_batch_row_that_fails_is_nan_and_scores_minus_inf_in_grid(rng, monkeypatch):
    good, bad = _spd(rng, 4), -np.eye(4)
    l_mat = TL.cholesky_jittered(_t(np.stack([good, bad])), 1e-6)
    assert bool(torch.isfinite(l_mat[0]).all()) and bool(torch.isnan(l_mat[1].diagonal()).all())

    # the grid fit: make the unpatched winner's matrix indefinite; its MLL must
    # be NaN (never a finite value from a partial factor) and the fit must
    # pick the best of the remaining rows
    config = GPConfig(kernel="matern52", fit_optimizer="grid")
    n_max, n, d = 24, 18, 3
    x = np.where((np.arange(n_max) < n)[:, None], rng.rand(n_max, d), 0.0)
    y = np.where(np.arange(n_max) < n, np.sin(5 * x[:, 0]) + 0.1 * rng.randn(n_max), 0.0)
    x_t, y_t, mask = _t(x), _t(y), TL.row_mask(n_max, n)
    y_std, _, _ = TG.T.standardize(y_t, mask)
    grid = TG.grid_params(d, config, torch.float64)
    clean = TG.mll(grid, x_t, y_std, mask, config)
    winner = int(torch.argmax(clean))
    real = TG._kernel_matrix

    def broken(params, x1, x2, cfg, add_noise):
        k = real(params, x1, x2, cfg, add_noise)
        if k.dim() == 3:
            k = k.clone()
            k[winner] = -k[winner]
        return k

    monkeypatch.setattr(TG, "_kernel_matrix", broken)
    scores = TG.mll(grid, x_t, y_std, mask, config)
    assert bool(torch.isnan(scores[winner]))
    state = TG.fit_gp(x_t, y_t, mask, config)
    runner_up = int(torch.argmax(torch.where(torch.arange(len(clean)) == winner, -torch.inf, clean)))
    np.testing.assert_allclose(state.raw.raw_noise.numpy(), grid.raw_noise[runner_up].numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(state.raw.raw_lengthscale.numpy(), grid.raw_lengthscale[runner_up].numpy(), rtol=0, atol=0)
    # the JAX grid's scores on the unpatched problem agree row for row
    jcfg = JGPConfig(kernel="matern52", fit_optimizer="grid", use_pallas=False)
    jgrid = JG.grid_params(d, jcfg, jnp.float64)
    jscores = [float(JG.mll(JG.GPParams(*(a[i] for a in jgrid)), jnp.asarray(x), jnp.asarray(y_std.numpy()),
                            jnp.asarray(mask.numpy()), jcfg)) for i in range(len(clean))]
    np.testing.assert_allclose(clean.numpy(), jscores, **F64)


@pytest.mark.parametrize(
    "base, n, lead, n_active",
    [(2048, 37, (), 37),  # below the base: one triangular solve against the identity, one product
     (8, 8, (), 8),  # at the base
     (8, 9, (3,), 9),  # one split, odd, a batch of three
     (4, 37, (2,), 37),  # odd, four levels of the recursion
     (5, 64, (2, 2), 50),  # two leading axes; an identity-padded block of 14 rows
     (3, 101, (), 80)],
)
def test_chol_inverse_matches_cholesky_inverse(rng, monkeypatch, base, n, lead, n_active):
    """``chol_inverse`` against ``torch.cholesky_inverse`` in f64, with the
    recursion's base set small so that the recursion runs at these sizes;
    the result is exactly symmetric, and a padded block's inverse is the
    identity's."""
    monkeypatch.setattr(TL, "_CHOL_INVERSE_BASE", base)
    k = np.stack([_spd(rng, n) for _ in range(int(np.prod(lead, dtype=int)))]).reshape(lead + (n, n))
    mask = TL.row_mask(n, n_active)
    l_mat = torch.linalg.cholesky(TL.mask_kernel_matrix(_t(k), mask))
    got = TL.chol_inverse(l_mat)
    assert got.shape == l_mat.shape
    torch.testing.assert_close(got, torch.cholesky_inverse(l_mat), **F64)
    assert torch.equal(got, got.mT)
    assert torch.equal(got[..., n_active:, n_active:], torch.eye(n - n_active, dtype=got.dtype).expand(lead + (-1, -1)))
    assert torch.equal(l_mat, torch.linalg.cholesky(TL.mask_kernel_matrix(_t(k), mask)))  # the factor is left as it was
