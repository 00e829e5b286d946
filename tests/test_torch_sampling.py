"""The port's samplers against ``turbojax.sampling`` and scipy. JAX's
threefry draws and torch's generators differ, so the draws JAX made are
handed to the port (shift, permutations, uniforms, masks). Sobol points are
compared bit for bit; the rest is deterministic f64 (rtol 1e-12)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import qmc

from turbojax import sampling as JS
from turbojax_torch import sampling as TS

torch.set_num_threads(1)


@pytest.mark.parametrize("dim, n, start", [(1, 64, 0), (10, 300, 0), (10, 100, 77), (60, 128, 0)])
def test_sobol_raw_bit_exact(dim, n, start):
    got = TS.sobol_raw(dim, n, start, dtype=torch.float64).numpy()
    np.testing.assert_array_equal(got, np.asarray(JS.sobol_raw(dim, n, start, dtype=jnp.float64)))
    ref = qmc.Sobol(d=dim, scramble=False)
    if start:
        ref.fast_forward(start)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # n need not be a power of 2 here
        np.testing.assert_array_equal(got, ref.random(n))
    np.testing.assert_array_equal(TS.sobol_raw(dim, n, start).numpy(),
                                  np.asarray(JS.sobol_raw(dim, n, start, dtype=jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sobol_sample_with_injected_shift(dtype):
    key = jax.random.key(5)
    dim, n = 10, 200
    shift = np.asarray(jax.random.bits(key, (dim,), jnp.uint32) >> 2)
    ref = np.asarray(JS.sobol_sample(key, dim, n, dtype=getattr(jnp, dtype)))
    got = TS.sobol_sample(dim, n, dtype=getattr(torch, dtype), shift=torch.as_tensor(shift.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), ref)
    g = torch.Generator().manual_seed(0)
    drawn = TS.sobol_sample(dim, n, g)
    assert drawn.shape == (n, dim) and float(drawn.min()) >= 0.0 and float(drawn.max()) < 1.0
    lms = TS.sobol_sample(dim, n, g, scramble="lms")  # held bit for bit in test_torch_sampling_lms.py
    assert lms.shape == (n, dim) and float(lms.min()) >= 0.0 and float(lms.max()) < 1.0
    with pytest.raises(ValueError):
        TS.sobol_sample(dim, n, g, scramble="owen")


def test_latin_hypercube_stratified_and_matches_jax_formula(rng):
    n, dim = 25, 6
    g = torch.Generator().manual_seed(1)
    x = TS.latin_hypercube(n, dim, g, torch.float64).numpy()
    assert x.shape == (n, dim)
    for j in range(dim):  # one point per stratum in every dimension
        np.testing.assert_array_equal(np.sort(np.floor(x[:, j] * n)), np.arange(n))
    key = jax.random.key(2)
    ref = np.asarray(JS.latin_hypercube(key, n, dim, jnp.float64))
    kp, ku = jax.random.split(key)
    perms = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(jax.random.split(kp, dim)))
    u = np.asarray(jax.random.uniform(ku, (n, dim), jnp.float64))
    got = TS.latin_hypercube(n, dim, dtype=torch.float64, perms=torch.tensor(perms), u=torch.tensor(u))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=0)


def test_perturbation_mask_rules_and_injected_draws():
    n, dim = 400, 40
    g = torch.Generator().manual_seed(4)
    m = TS.perturbation_mask(n, dim, g).numpy()
    assert m.shape == (n, dim) and m.dtype == np.bool_
    assert np.all(m.any(axis=1))  # every candidate perturbs at least one dimension
    assert abs(m.mean() - 20.0 / dim) < 0.03  # P(perturb) = min(20/d, 1)
    assert np.all(TS.perturbation_mask(50, 10, g).numpy())  # d ≤ 20: every dimension
    key = jax.random.key(7)
    kb, kf = jax.random.split(key)
    bern = np.array(jax.random.bernoulli(kb, 0.5, (n, dim)))
    bern[:5] = False  # rows that take the fallback dimension
    fb = np.asarray(jax.random.randint(kf, (n,), 0, dim))
    got = TS.perturbation_mask(n, dim, bern=torch.as_tensor(bern), fallback_dim=torch.as_tensor(fb)).numpy()
    ref = np.where(bern.any(axis=1, keepdims=True), bern, np.eye(dim, dtype=bool)[fb])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:5].sum(axis=1), 1)


@pytest.mark.parametrize("dim", [4, 30])
def test_tr_candidates_with_injected_draws_match_jax(dim, rng):
    key = jax.random.key(11)
    center = rng.rand(dim)
    ls = rng.uniform(0.05, 1.5, dim)
    length, n_cand = 0.4, 128
    ref = np.asarray(JS.tr_candidates(key, jnp.asarray(center), jnp.asarray(length), jnp.asarray(ls), n_cand))
    ks, km, _ = jax.random.split(key, 3)
    shift = np.asarray(jax.random.bits(ks, (dim,), jnp.uint32) >> 2).astype(np.int64)
    mask = np.asarray(JS.perturbation_mask(km, n_cand, dim))
    length_t = torch.tensor(length, dtype=torch.float64)
    got = TS.tr_candidates(torch.as_tensor(center), length_t, torch.as_tensor(ls), n_cand,
                           shift=torch.as_tensor(shift), mask=torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-15)
    g = torch.Generator().manual_seed(0)
    drawn = TS.tr_candidates(torch.as_tensor(center), length_t, torch.as_tensor(ls), n_cand, g).numpy()
    half = ls / ls.mean()
    half = half / np.exp(np.log(half).mean()) * length / 2
    assert np.all(drawn >= np.clip(center - half, 0, 1) - 1e-12) and np.all(drawn <= np.clip(center + half, 0, 1) + 1e-12)
    assert TS.n_candidates(dim) == JS.n_candidates(dim)
