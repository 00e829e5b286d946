"""The dense routing surface of the port's ``distributed_linalg``
(``fit_gp_auto``, ``refactor_gp_auto``, ``_DenseGPAdapter``) against
``turbojax.distributed_linalg`` without a mesh, in float64 on the CPU.

``fit_gp_auto`` from JAX's restart draws: L-BFGS held by its result, as in
``tests/test_torch_gp_fit.py`` (the final −mll/n at most JAX's + 1e-3);
``refactor_gp_auto``, ``.posterior`` and ``.mll`` at pinned
hypers to rtol 1e-10, with and without the bilog warp. A mesh of one
device takes the dense route whatever the budget, one of two above it the
distributed route, and ``run_bo_distributed`` runs batches that the mesh
size does not divide (the meshes of more ranks are in
``tests/test_torch_distributed_mesh.py``);
the off-cadence refactor sees new data (``tests/test_bo_distributed.py:114``
at world size 1); the grid fit's two branches (``gp.grid_rows_batched``)
give equal hypers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbojax import distributed_linalg as JDL
from turbojax import gp as JG
from turbojax.config import GPConfig as JGPConfig
from turbojax_torch import bo_distributed as BD
from turbojax_torch import convert as C
from turbojax_torch import distributed_linalg as DL
from turbojax_torch import gp as TG
from turbojax_torch import transforms as TT
from turbojax_torch.bo import BOConfig
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

N, D = 24, 3
CFG = dataclasses.replace(GPConfig(kernel="matern52"), fit_optimizer="adam", fit_maxiter=5)


def _quad(x):
    return torch.sum((x - 0.3) ** 2, dim=-1)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _data(seed, n=N):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, D)
    return x, np.sin(3 * x[:, 0]) + x[:, 1] ** 2 + 0.05 * rng.randn(n)


def _restart_uniforms(key, n, d_eff):
    """The [0, 1) draws behind ``turbojax.gp.sample_restart_params(key, ...)``,
    in the port's column order."""
    k1, k2, k3 = jax.random.split(key, 3)
    return np.concatenate([np.asarray(jax.random.uniform(k1, (n, d_eff), jnp.float64)),
                           np.asarray(jax.random.uniform(k2, (n,), jnp.float64))[:, None],
                           np.asarray(jax.random.uniform(k3, (n,), jnp.float64))[:, None]], axis=1)


def test_fit_gp_auto_matches_jax():
    """The default L-BFGS fit (4 restarts) from JAX's restart draws."""
    jcfg, tcfg = JGPConfig(kernel="matern52"), GPConfig(kernel="matern52")
    x, y = _data(1)
    key = jax.random.key(2)
    g_j = JDL.fit_gp_auto(key, jnp.asarray(x), jnp.asarray(y), jcfg)
    g_t = DL.fit_gp_auto(torch.as_tensor(x), torch.as_tensor(y), tcfg,
                         restart_uniforms=torch.as_tensor(_restart_uniforms(key, tcfg.fit_restarts - 1, D)))
    assert isinstance(g_t, DL._DenseGPAdapter) and bool(g_t.state.mask.all())
    mll_j, mll_t = float(g_j.mll()), float(g_t.mll())
    assert -mll_t / N <= -mll_j / N + 1e-3, (mll_t, mll_j)
    assert bool(TG._finite_rows(g_t.raw).all())


@pytest.mark.parametrize("y_warp", ["none", "bilog"])
def test_refactor_posterior_and_mll_match_jax(y_warp):
    """At pinned hypers over a history: the posterior and the MLL of the
    warped, standardized targets to round-off."""
    jcfg, tcfg = JGPConfig(kernel="matern52", y_warp=y_warp), GPConfig(kernel="matern52", y_warp=y_warp)
    rng = np.random.RandomState(3)
    raw = JG.GPParams(raw_lengthscale=rng.randn(D) * 0.3 - 0.5, raw_outputscale=np.asarray(0.2),
                      raw_noise=np.asarray(-3.0), raw_mean=np.asarray(0.0))
    x, y = _data(4, n=N + 8)
    y = 20.0 * y
    r_j = JDL.refactor_gp_auto(jnp.asarray(x), jnp.asarray(y), JG.GPParams(*map(jnp.asarray, raw)), jcfg)
    r_t = DL.refactor_gp_auto(torch.as_tensor(x), torch.as_tensor(y), C.gp_params_from_numpy(raw), tcfg)
    xs = rng.rand(16, D)
    for got, want in zip(r_t.posterior(torch.as_tensor(xs)), r_j.posterior(jnp.asarray(xs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(r_t.mll()), float(r_j.mll()), rtol=1e-10)
    ones = torch.ones(N + 8, dtype=torch.bool)
    y_std, _, _ = TT.standardize(TT.warp_y(torch.as_tensor(y), y_warp), ones)
    want = TG.mll(C.gp_params_from_numpy(raw), torch.as_tensor(x), y_std, ones, tcfg)
    np.testing.assert_allclose(float(r_t.mll()), float(want), rtol=1e-12)
    np.testing.assert_array_equal(r_t.raw.raw_lengthscale.numpy(), raw.raw_lengthscale)


def test_routing_is_dense_without_a_mesh_and_refuses_one(tmp_path):
    from torch_mesh_cases import world1_group
    from turbojax_torch.parallel import Mesh

    assert DL.should_distribute(1 << 20, None, budget_bytes=1) is False
    # the rule alone, on a mesh of two (its group is never used)
    two = Mesh(group=None, axis="rows", size=2, rank=0, device=torch.device("cpu"))
    assert DL.should_distribute(64, two, budget_bytes=1) is True
    assert DL.should_distribute(64, two) is False  # 3·64²·4 bytes is under the default budget
    x, y = _data(5)
    with world1_group(tmp_path) as mesh:
        assert DL.should_distribute(1 << 20, mesh, budget_bytes=1) is False
        g = DL.fit_gp_auto(torch.as_tensor(x), torch.as_tensor(y), CFG, mesh=mesh, budget_bytes=1, generator=_gen())
        assert isinstance(g, DL._DenseGPAdapter)
        # n_init 8 and q = 4 on a mesh of three: no longer refused (below the
        # default budget the route is dense, so the points are the world-1 run's)
        three = Mesh(group=mesh.group, axis="rows", size=3, rank=0, device=mesh.device)
        odd = BD.run_bo_distributed(_quad, [0.0] * D, [1.0] * D, BOConfig(n_init=8, max_evals=16, batch_size=4), CFG,
                                    mesh=three, generator=_gen())
        res = BD.run_bo_distributed(_quad, [0.0] * D, [1.0] * D, BOConfig(n_init=8, max_evals=16, batch_size=4),
                                    CFG, mesh=mesh, budget_bytes=1, generator=_gen())
        assert res.y_hist.shape == (16,) and bool(torch.isfinite(res.y_hist).all())
    assert odd.y_hist.shape == (16,) and bool(torch.isfinite(odd.y_hist).all())
    torch.testing.assert_close(odd.x_hist, res.x_hist, rtol=0, atol=0)


@pytest.mark.parametrize("budget_bytes", [1, None])
def test_refactor_sees_new_data(budget_bytes):
    """The off-cadence refresh absorbs the grown history at pinned hypers."""
    kw = {} if budget_bytes is None else {"budget_bytes": budget_bytes}
    g = _gen(1)
    x1 = torch.rand((16, D), generator=g, dtype=torch.float64)
    fit = DL.fit_gp_auto(x1, _quad(x1), CFG, panel=2, generator=g, **kw)
    x_new = torch.rand((8, D), generator=g, dtype=torch.float64)
    y_new = _quad(x_new)
    refit = DL.refactor_gp_auto(torch.cat([x1, x_new]), torch.cat([_quad(x1), y_new]), fit.raw, CFG, panel=2, **kw)
    mu_old, var_old = fit.posterior(x_new)
    mu_new, var_new = refit.posterior(x_new)
    assert bool((var_new < var_old).all())
    assert float((mu_new - y_new).abs().mean()) <= float((mu_old - y_new).abs().mean()) + 1e-9


@pytest.mark.parametrize("fit_optimizer", ["grid", "grid+adam"])
def test_grid_branches_give_equal_hypers(monkeypatch, fit_optimizer):
    """The grid rows scored as one batch and one after another
    (``gp.grid_rows_batched``) pick the same hypers."""
    x, y = _data(6, n=40)
    cfg = GPConfig(kernel="matern52", fit_optimizer=fit_optimizer)
    args = (torch.as_tensor(x), torch.as_tensor(y), torch.ones(40, dtype=torch.bool), cfg)
    assert TG.grid_rows_batched(15, 40, 8)
    batched = TG.fit_gp(*args)
    monkeypatch.setattr(TG, "_GRID_VMAP_BUDGET_BYTES", 0)
    assert not TG.grid_rows_batched(15, 40, 8)
    sequential = TG.fit_gp(*args)
    for a, b in zip(batched.raw, sequential.raw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(batched.chol.numpy(), sequential.chol.numpy(), rtol=1e-12, atol=1e-14)
