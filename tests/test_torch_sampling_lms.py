"""The LMS Sobol scramble of the port, bit for bit: ``lms_scramble_sv``
against ``turbojax.sampling`` and against scipy's ``Sobol(scramble=True)``
with scipy's own draws replayed (as ``tests/test_sampling.py`` does for the
JAX package), ``lms_random_rows`` from injected bits, and
``sobol_sample(scramble="lms")`` with the rows and the shift JAX drew."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import qmc

from turbojax import sampling as JS
from turbojax_torch import sampling as TS

torch.set_num_threads(1)

BITS = TS._SOBOL_BITS


def _scipy_rows(d, seed):
    """scipy's own LMS draws for (d, seed), as integer row masks, with the
    scrambled direction numbers and shift they must produce."""
    from scipy.stats._qmc import rng_integers

    ref = qmc.Sobol(d=d, scramble=True, seed=seed)
    rng = np.random.default_rng(seed)
    shift_bits = rng_integers(rng, 2, size=(d, BITS), dtype=ref._sv.dtype)
    shift = shift_bits.astype(np.uint64) @ (2 ** np.arange(BITS, dtype=np.uint64))
    ltm = np.tril(rng_integers(rng, 2, size=(d, BITS, BITS), dtype=ref._sv.dtype)).astype(np.int64)
    idx = np.arange(BITS)
    ltm[:, idx, idx] = 1  # scipy sets the unit diagonal inside _cscramble
    rows = (ltm * (1 << (BITS - 1 - idx)).astype(np.int64)[None, None, :]).sum(axis=2)
    return rows, shift.astype(np.int64), ref


@pytest.mark.parametrize("d,seed", [(3, 1234), (10, 7), (60, 0)])
def test_lms_scramble_sv_bit_exact_vs_scipy_and_jax(d, seed):
    rows, shift, ref = _scipy_rows(d, seed)
    sv0 = TS._direction_numbers(d)
    got = TS.lms_scramble_sv(torch.as_tensor(sv0), torch.as_tensor(rows))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref._sv, np.int64))
    jax_sv = JS.lms_scramble_sv(jnp.asarray(sv0, jnp.uint32), jnp.asarray(rows, jnp.uint32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sv).astype(np.int64))
    # the points too: scipy's first 64 scrambled points from its rows and shift
    pts = TS.sobol_sample(d, 64, dtype=torch.float64, scramble="shift", shift=torch.as_tensor(shift))
    assert pts.shape == (64, d)
    acc = TS._gray_sobol(d, torch.arange(64), got) ^ torch.as_tensor(shift)[None, :]
    np.testing.assert_array_equal((acc.double() / 2.0**BITS).numpy(), ref.random(64))


@pytest.mark.parametrize("dim", [1, 8])
def test_lms_random_rows_from_injected_bits_matches_jax(dim):
    key = jax.random.key(dim)
    bits = np.asarray(jax.random.bits(key, (dim, BITS), jnp.uint32)).astype(np.int64)
    got = TS.lms_random_rows(dim, bits=torch.as_tensor(bits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JS.lms_random_rows(key, dim)).astype(np.int64))
    for i in range(BITS):
        diag = 1 << (BITS - 1 - i)
        assert np.all(got[:, i] & diag == diag) and np.all(got[:, i] & (diag - 1) == 0)
    drawn = TS.lms_random_rows(dim, torch.Generator().manual_seed(0)).numpy()
    assert drawn.shape == (dim, BITS) and np.all(drawn[:, 0] == 1 << (BITS - 1))
    other = TS.lms_random_rows(dim, torch.Generator().manual_seed(1)).numpy()
    assert not np.array_equal(drawn[:, -1], other[:, -1])  # 29 free bits in the last row


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sobol_sample_lms_with_jax_draws_is_bit_exact(dtype):
    key = jax.random.key(11)
    dim, n = 10, 256
    k_lms, k_shift = jax.random.split(key)
    bits = np.asarray(jax.random.bits(k_lms, (dim, BITS), jnp.uint32)).astype(np.int64)
    shift = np.asarray(jax.random.bits(k_shift, (dim,), jnp.uint32) >> 2).astype(np.int64)
    ref = np.asarray(JS.sobol_sample(key, dim, n, dtype=getattr(jnp, dtype), scramble="lms"))
    got = TS.sobol_sample(dim, n, dtype=getattr(torch, dtype), scramble="lms", shift=torch.as_tensor(shift),
                          lms_bits=torch.as_tensor(bits))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sobol_lms_keeps_the_net_stratified():
    """LMS and shift keep the (t, m, s)-net: 2^m points put one point in
    each of the 2^m dyadic intervals of every dimension."""
    g = torch.Generator().manual_seed(3)
    pts = TS.sobol_sample(6, 128, g, torch.float64, scramble="lms").numpy()
    for j in range(6):
        np.testing.assert_array_equal(np.sort(np.floor(pts[:, j] * 128)), np.arange(128))
    again = TS.sobol_sample(6, 128, g, torch.float64, scramble="lms").numpy()
    assert not np.array_equal(pts, again)  # a fresh scramble per call
