"""What the CUDA kernels are launched with, checked on the CPU.

The kernels themselves run only on a GPU (``tests/test_torch_kernels.py``
and ``tests/test_torch_ts_cov.py`` hold them to their plain versions there).
Here: the launch plans (``cuda_kernels.kernel_matrix_plan``,
``ts_cov_plan``) cover each output tile once and partition ts_cov's
training rows, within CUDA's grid limits; the per-batch scalars and the
symmetric flag reach the launch as the plain version reads them; and
``optimize`` runs on the card unless asked for the CPU.
"""

import math

import numpy as np
import pytest
import torch

from turbojax_torch import cuda_kernels as CK
from turbojax_torch import kernels as TK
from turbojax_torch import optimize

torch.set_num_threads(1)

# (batch, n, d): config 5's grid at the 2000 and 512 rungs, its polish and
# small regions, config 4's grid and factor, the bench's factor; ragged sizes
# around the 64- and 128-tiles
SYMMETRIC = [(16, 2000, 60), (1, 2000, 60), (64, 512, 60), (4, 512, 60), (15, 1000, 10), (1, 1000, 10),
             (1, 2048, 10), (1, 1, 10), (1, 63, 60), (1, 65, 60), (1, 999, 60), (2, 129, 70)]
# (batch, m, n, d): the chunks the paths launch, config 5's batched chunks,
# and ragged m and n
TS_SHAPES = [(1, 1000, 2000, 60), (1, 1000, 512, 60), (1, 1000, 1000, 10), (1, 1000, 2048, 10),
             (5, 1000, 2048, 60), (20, 1000, 512, 60), (1, 999, 1750, 60), (1, 1, 1, 10), (1, 63, 300, 60),
             (1, 65, 700, 60), (1, 1000, 1, 10), (1, 129, 0, 60)]


def _upper_tile(t):
    """The decode of ``tile::upper_tile`` (csrc/tile_mainloop.cuh)."""
    j = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while j * (j + 1) // 2 > t:
        j -= 1
    while (j + 1) * (j + 2) // 2 <= t:
        j += 1
    return t - j * (j + 1) // 2, j


def _check_upper_tiles(plan):
    tiles = plan.tiles()
    assert len(tiles) == plan.blocks == len(set(tiles))
    assert set(tiles) == {(i, j) for j in range(plan.row_tiles) for i in range(j + 1)}
    assert [_upper_tile(t) for t in range(plan.blocks)] == tiles


@pytest.mark.parametrize("batch, n, d", SYMMETRIC)
def test_kernel_matrix_plan_covers_each_upper_tile_once(batch, n, d):
    plan = CK.kernel_matrix_plan(batch, n, n, d, True)
    assert plan.symmetric and plan.row_tiles == plan.col_tiles == math.ceil(n / plan.tile)
    _check_upper_tiles(plan)
    # the mirrored upper tiles cover the whole matrix, each entry once
    seen = np.zeros((plan.row_tiles, plan.row_tiles), dtype=int)
    for i, j in plan.tiles():
        seen[i, j] += 1
        if i != j:
            seen[j, i] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("batch, n, m, d", [(1, 2000, 1000, 60), (1, 2048, 5000, 10), (2, 130, 257, 10), (1, 1, 1, 0)])
def test_kernel_matrix_plan_covers_each_cross_tile_once(batch, n, m, d):
    plan = CK.kernel_matrix_plan(batch, n, m, d, False)
    assert not plan.symmetric and plan.blocks == plan.row_tiles * plan.col_tiles
    assert plan.tiles() == [(i, j) for i in range(math.ceil(n / plan.tile)) for j in range(math.ceil(m / plan.tile))]


@pytest.mark.parametrize("batch, m, n, d", TS_SHAPES)
def test_ts_cov_plan_splits_partition_n(batch, m, n, d):
    plan = CK.ts_cov_plan(batch, m, n, d)
    assert plan.symmetric and plan.tile == 128
    _check_upper_tiles(plan)
    rows = []
    for s in range(plan.splits):  # the first split may hand all its rows to the kernel term
        lo, hi = max(0, s * plan.chunk - plan.lead), min(n, (s + 1) * plan.chunk - plan.lead)
        rows.extend(range(lo, hi))
        assert hi - lo <= 384  # the longest partial sum
    assert rows == list(range(n))  # in order, each row once
    assert plan.splits * plan.chunk >= n + plan.lead > (plan.splits - 1) * plan.chunk
    assert plan.workspace == (plan.splits + 1) * batch * plan.blocks * 128**2
    if batch * plan.blocks * 2 <= 2 * 132:  # a single chunk: one wave of two blocks per SM
        assert batch * plan.blocks * plan.splits <= 2 * 132 or plan.chunk <= 384


def test_ts_cov_plan_at_the_path_chunk():
    """One 1000-candidate chunk at n = 2000: 36 upper 128-tiles, n split
    seven ways, 252 blocks for 132 SMs holding two each."""
    plan = CK.ts_cov_plan(1, 1000, 2000, 60)
    assert (plan.blocks, plan.splits, plan.chunk, plan.lead) == (36, 7, 326, 280)


@pytest.mark.parametrize("call", [
    lambda: CK.kernel_matrix_plan(65536, 10, 10, 3, True),
    lambda: CK.kernel_matrix_plan(1, 2**31 - 1, 2**31 - 1, 3, True),
    lambda: CK.kernel_matrix_plan(1, 10, 11, 3, True),
    lambda: CK.ts_cov_plan(65536, 10, 10, 3),
    lambda: CK.ts_cov_plan(1, 2**31 - 1, 10, 3),
])
def test_plans_respect_the_grid_limits(call):
    with pytest.raises(ValueError):
        call()


def _strided(value, stride, batch):
    """The per-batch values a kernel reads through (pointer, batch stride)."""
    return torch.as_strided(value, (batch,), (stride,), value.storage_offset())


def _per_batch_values(batch):
    full = torch.tensor([1.3, 0.7, 2.0, 0.1, 0.5, 0.9], dtype=torch.float64)
    return {"scalar": torch.tensor(1.7, dtype=torch.float64), "one": torch.tensor([1.7], dtype=torch.float64),
            "batched": full[:batch].clone(), "strided": full[::2]}


@pytest.mark.parametrize("kind", ["scalar", "one", "batched", "strided"])
def test_kernel_matrix_scalars_reach_the_launch_as_the_plain_version_reads_them(kind, rng):
    z = torch.as_tensor(rng.randn(3, 40, 5))
    scale = _per_batch_values(3)[kind]
    noise = scale * 1e-2
    a, b, (s, s_stride), (nz, n_stride), plan = CK._kernel_matrix_args(z, z, scale, noise, True)
    assert a is b and plan.symmetric and s_stride == (0 if scale.numel() == 1 else scale.stride(0))
    s_b, nz_b = _strided(s, s_stride, 3), _strided(nz, n_stride, 3)
    by_launch = torch.stack([CK.kernel_matrix_reference(a[i], a[i], s_b[i], nz_b[i], "matern52", True)
                             for i in range(3)])
    plain = CK.kernel_matrix_reference(z, z, scale, noise, "matern52", True)
    np.testing.assert_allclose(by_launch.numpy(), plain.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(CK.kernel_matrix(z, z, scale, noise, "matern52", True).numpy(), plain.numpy())


@pytest.mark.parametrize("kind", ["scalar", "batched", "strided"])
def test_ts_cov_scalars_reach_the_launch_as_the_plain_version_reads_them(kind, rng):
    zs, v = torch.as_tensor(rng.randn(3, 30, 4)), torch.as_tensor(rng.randn(3, 20, 30) / 5)
    scale = _per_batch_values(3)[kind]
    jitter = scale * 1e-3
    z, vv, (s, s_stride), (jit, j_stride), plan = CK._ts_cov_args(zs, v, scale, jitter)
    s_b, jit_b = _strided(s, s_stride, 3), _strided(jit, j_stride, 3)
    by_launch = torch.stack([CK.ts_cov_reference(z[i], vv[i], s_b[i], jit_b[i], "matern32") for i in range(3)])
    plain = CK.ts_cov_reference(zs, v, scale, jitter, "matern32")
    np.testing.assert_allclose(by_launch.numpy(), plain.numpy(), rtol=1e-12, atol=1e-14)


def test_per_batch_rejects_a_wrong_length():
    with pytest.raises(ValueError):
        CK._per_batch(torch.ones(3), 2, "outputscale")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_same_input_is_kept_through_the_2d_to_3d_step(dtype, rng, monkeypatch):
    """K(Z, Z) from a 2-D Z passed twice launches the symmetric schedule: the
    wrapper decides `same` before the batch axis is added (z[None] and
    z[None] are different objects). On the CPU the result is the plain
    version's, diagonal exact."""
    z = torch.as_tensor(rng.randn(70, 6), dtype=dtype)
    seen = []
    real = CK._forward

    def spy(z1, z2, outputscale, noise, kernel_name, add_noise, same, diag_offset):
        seen.append(same)
        return real(z1, z2, outputscale, noise, kernel_name, add_noise, same, diag_offset)

    monkeypatch.setattr(CK, "_forward", spy)
    got = CK.kernel_matrix(z, z, 1.3, 0.25, "matern12", True)
    CK.kernel_matrix(z, z.clone(), 1.3, 0.25, "matern12", True)
    assert seen == [True, False]
    np.testing.assert_array_equal(got.numpy(), CK.kernel_matrix_reference(z, z, 1.3, 0.25, "matern12", True).numpy())
    k0 = TK.from_sqdist("matern12", torch.zeros((), dtype=dtype), torch.tensor(1.3, dtype=dtype))
    assert torch.all(got.diagonal() == k0 + torch.tensor(0.25, dtype=dtype))  # d² = 0 exactly
    a, b, _, _, plan = CK._kernel_matrix_args(z, z, torch.tensor(1.3, dtype=dtype), torch.tensor(0.25, dtype=dtype),
                                              True)
    assert a.shape == (1, 70, 6) and a.data_ptr() == b.data_ptr() and plan.symmetric and plan.blocks == 3


def test_optimize_defaults_to_the_card(monkeypatch):
    """Without device= optimize runs on "cuda"; with no card it raises and
    names the CPU override, evaluating nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []

    def fn(x):
        calls.append(x)
        return (x**2).sum(-1)

    with pytest.raises(RuntimeError, match='device="cpu"'):
        optimize(fn, [0.0] * 3, [1.0] * 3, 20, n_init=5, batch_size=5, n_candidates=16)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        optimize(fn, [0.0] * 3, [1.0] * 3, 20, method="turbom", m=2, n_init=5, batch_size=5, n_candidates=16)
    assert calls == []
