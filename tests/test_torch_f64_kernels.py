"""The float64 designs of both CUDA kernels against their plain versions.

``csrc/ts_cov.cu``'s double path (vᵀv on the FP64 tensor cores, pairs of
blocks summed in a cluster, a finishing pass on 32-sub-tiles) and
``csrc/tile_f64.cuh``'s kernel tile under ``csrc/kernel_matrix.cu`` run
only on a GPU: every test here is marked ``cuda`` and skips without one
(run them on the card with ``python -m pytest tests/test_torch_f64_kernels.py
-m cuda``). The shapes reach the designs' edges: m and n off the 96-tile,
the 16-row DMMA step and the 32-sub-tile, n = 0 and 1, d past the 64
features staged at once, batches, all four kernel functions, and row blocks
with ``diag_offset``. Tolerances are ``chip_smoke.py`` phase 2's for
float64: the TS covariance within 1e-12·outputscale of the plain version,
the kernel matrix within rtol 1e-12; both bitwise symmetric where the
output is, two calls bitwise equal.
"""

import math

import pytest
import torch

from turbojax_torch import cuda_kernels as CK

torch.set_num_threads(1)

KERNEL_NAMES = ["rbf", "matern12", "matern32", "matern52"]
# (batch, m, n, d)
TS_SHAPES = [(1, 1000, 1000, 10), (1, 1000, 2000, 60), (1, 1, 1, 10), (1, 15, 3, 60), (1, 17, 1001, 70),
             (3, 999, 1001, 10), (2, 97, 17, 100), (1, 129, 0, 60), (5, 1000, 2048, 60)]
# (batch, n, m, d, K(Z, Z))
KM_SHAPES = [(1, 1000, 1000, 10, True), (1, 2000, 1000, 60, False), (1, 15, 15, 2, True), (1, 17, 17, 100, True),
             (3, 33, 33, 5, True), (2, 31, 65, 10, False), (64, 512, 512, 60, True), (1, 7, 9, 3, False)]


def _need_card():
    if not CK.available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_f64_ts_cov_matches_plain_version(name):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(8)
    CK.TS_COV_LAUNCHES_F64 = 0
    for batch, m, n, d in TS_SHAPES:
        zs = torch.rand((batch, m, d), generator=g, device="cuda", dtype=torch.float64) / math.sqrt(d / 24)
        zs = zs - zs.mean(dim=-2, keepdim=True)
        v = torch.randn((batch, n, m), generator=g, device="cuda", dtype=torch.float64) / math.sqrt(max(n, 1))
        s = torch.linspace(0.3, 1.7, batch, device="cuda", dtype=torch.float64)
        got = CK.ts_cov(zs, v, s, 1e-6, name)
        ref = CK.ts_cov_reference(zs, v, s, 1e-6, name)
        assert float(((got - ref).abs() / s[:, None, None]).max()) <= 1e-12, (batch, m, n, d)
        assert torch.equal(got, got.mT) and torch.equal(got, CK.ts_cov(zs, v, s, 1e-6, name))
    assert CK.TS_COV_LAUNCHES_F64 == 2 * len(TS_SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_f64_kernel_matrix_matches_plain_version(name):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(9)
    for batch, n, m, d, same in KM_SHAPES:
        z1 = torch.randn(batch, n, d, generator=g, device="cuda", dtype=torch.float64) / 3
        z2 = z1 if same else torch.randn(batch, m, d, generator=g, device="cuda", dtype=torch.float64) / 3
        s = torch.linspace(1.0, 2.0, batch, device="cuda", dtype=torch.float64)
        nz = torch.linspace(0.1, 0.01, batch, device="cuda", dtype=torch.float64)
        got = CK.kernel_matrix(z1, z2, s, nz, name, True)
        torch.testing.assert_close(got, CK.kernel_matrix_reference(z1, z2, s, nz, name, True), rtol=1e-12, atol=0.0)
        assert torch.equal(got, CK.kernel_matrix(z1, z2, s, nz, name, True))
        if same:
            assert torch.equal(got, got.mT)


@pytest.mark.cuda
@pytest.mark.parametrize("rows, n, d, offset", [(2048, 8192, 10, 4096), (130, 390, 60, 130), (100, 333, 7, 3)])
def test_f64_kernel_matrix_row_blocks_keep_the_exact_diagonal(rows, n, d, offset):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(10)
    z = torch.rand((n, d), generator=g, device="cuda", dtype=torch.float64) / math.sqrt(d / 24)
    z = z - z.mean(dim=0)
    block = z[offset:offset + rows]
    s, nz = torch.tensor(1.3, device="cuda", dtype=torch.float64), torch.tensor(1e-3, device="cuda", dtype=torch.float64)
    r = torch.arange(rows, device="cuda")
    for name in KERNEL_NAMES:
        got = CK.kernel_matrix(block, z, s, nz, name, True, diag_offset=offset)
        ref = CK.kernel_matrix_reference(block, z, s, nz, name, True, offset)
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=0.0)
        assert bool((got[r, offset + r] == s + nz).all())
