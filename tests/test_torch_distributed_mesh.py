"""The port's ``distributed_linalg`` on meshes of D = 1, 2 and 4 gloo ranks
against ``turbojax.distributed_linalg`` on meshes of the same size (the
conftest's virtual CPU devices), in float64.

One process group per world size: D = 1 in this process, D = 2 and D = 4
spawned (``tests/torch_mesh_cases.py``) and run in the background while the
JAX references are computed here (compiled: ``tests/jax_mesh_refs.py``); every case of a world size runs in its
group, and the parametrised tests read the results. N = 32 with panels of
4: at D = 4 each rank holds two panels, and ranks 1-3 own panels.

Tolerances: the Cholesky, both solves, ``cho_solve``, the logdet, the
posterior mean and variance and the kernel Cholesky (also against the
dense factor) at rtol 1e-10; the MLL at 1e-10 and its gradient in raw, x
and y_std (against ``jax.grad`` of JAX's custom VJP) at rtol 1e-8; 5 Adam
steps of ``fit_distributed_gp`` at rtol 1e-6; pathwise draws with JAX's
draws injected at rtol 1e-8. Duplicated rows at extreme hypers in float32
(a NaN warm start among them) give finite hypers; a mesh of one device
takes the dense route whatever the budget, a larger one the distributed
route above it. Replicated results must be equal on every rank.

The padded layout (any N): at N = 30, divisible by neither D nor the
panel, the GP level (factor, α, posterior, MLL and its gradient in raw, x
and y_std, pathwise draws with injected draws) against the plain float64
GP of ``portbench/reference/gp64.py`` at the same tolerances, the padded
block of the factor the identity's and α zero there; at N = 32 with
panels of 12 (padded on every D) the unpadded route's values at panels
of 4; ``run_bo_distributed`` with q = 3, forced distributed, visits the
points of the dense route on one device. A factorization records its
spans (``dlinalg.factor``, its ladder, rungs and reads) nested.

The GP level deals its rows out in blocks (``distributed_linalg._layout``:
at N = 30 with panels of 4, four blocks a rank on D = 2 and two on D = 4,
the padded rows on rank 0; at N = 17 every rank holds padded rows): its
factor and α, gathered in global order, its posterior, MLL, gradient and
pathwise values equal those of one block a rank at rtol 1e-12 in float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as TMC
from jax_mesh_refs import jax_compiled
from turbojax import acq as JA
from turbojax import distributed_linalg as JDL
from turbojax import gp as JG
from turbojax import parallel as JPAR
from turbojax.config import GPConfig as JGPConfig
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
N, DIM, PANEL, M_FEAT, N_PATHS = 32, 3, 4, 16, 3
TIGHT = dict(rtol=1e-10, atol=1e-12)
GRAD = dict(rtol=1e-8, atol=1e-11)
GP_KW = dict(kernel="matern52", learn_mean=True)
FIT_KW = dict(kernel="matern52", fit_optimizer="adam", fit_maxiter=5, fit_lr=0.1)


def _inputs():
    rng = np.random.RandomState(7)
    x = rng.rand(N, DIM)
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2 + 0.05 * rng.randn(N)
    xs = rng.rand(5, DIM)
    params = {"lengthscale": np.array([0.4, 0.7, 1.1]), "outputscale": np.asarray(1.3), "noise": np.asarray(1e-2)}
    raw = JG.GPParams(raw_lengthscale=np.array([-0.4, 0.1, 0.3]), raw_outputscale=np.asarray(0.2),
                      raw_noise=np.asarray(-3.0), raw_mean=np.asarray(0.1))
    return rng, x, y, xs, params, raw


def _matern52(x1, x2):
    """k(x1, x2) at PARAMS in numpy (``turbojax.kernels.matern52``'s formula)."""
    d2 = (((x1[:, None, :] - x2[None, :, :]) / PARAMS["lengthscale"]) ** 2).sum(-1)
    r = np.sqrt(d2 + 1e-30)
    return PARAMS["outputscale"] * (1.0 + np.sqrt(5.0) * r + 5.0 / 3.0 * d2) * np.exp(-np.sqrt(5.0) * r)


RNG, X, Y, XS, PARAMS, RAW = _inputs()
K_MAT = _matern52(X, X) + PARAMS["noise"] * np.eye(N)
B = RNG.randn(N, 3)
K_CROSS = _matern52(X, XS)
K_DIAG = np.full(5, 1.3)
ALPHA = np.linalg.solve(K_MAT, Y)[:, None]
Y_STD = (Y - Y.mean()) / Y.std()
PATH_SEED = 3
# 8 distinct points, each four times, for the rescue case
X_DUP = np.repeat(RNG.rand(8, DIM), 4, axis=0)
Y_DUP = np.sin(3 * X_DUP[:, 0])


RAW0 = RAW._replace(raw_mean=np.asarray(0.0))  # the reference's mean is 0
N_ODD, PANEL_PAD, N_SPREAD = 30, 12, 17
BO_ODD = dict(n_init=7, max_evals=16, batch_size=3, n_candidates=48, fit_every=0)


def _path_draws():
    kf, kw, ke = jax.random.split(jax.random.key(PATH_SEED), 3)
    omega, b = JA.rff_frequencies(kf, DIM, M_FEAT, "matern52", jnp.float64)
    w = jax.random.normal(kw, (N_PATHS, M_FEAT), jnp.float64)
    eps = jax.random.normal(ke, (N_PATHS, N), jnp.float64)
    return {k: np.asarray(v) for k, v in dict(omega=omega, b=b, w=w, eps=eps).items()}


def _jobs():
    pcfg = GPConfig(**GP_KW)
    return [
        ("linalg", "linalg", dict(k=K_MAT, b=B, k_cross=K_CROSS, k_diag=K_DIAG, alpha=ALPHA, panel=PANEL)),
        ("kernel_chol", "kernel_chol", dict(x=X, params=PARAMS, jitter=1e-6, kernel="matern52", panel=PANEL)),
        ("mll", "mll", dict(raw=RAW, x=X, y_std=Y_STD, config=pcfg, panel=PANEL)),
        ("fit", "fit", dict(x=X, y=Y, config=GPConfig(**FIT_KW), panel=PANEL, steps=5, xs=XS)),
        ("rescue", "rescue", dict(
            x=X_DUP, y=Y_DUP, config=GPConfig(**FIT_KW), panel=PANEL, steps=5, xs=XS,
            warm=(np.full(DIM, np.nan), np.asarray(0.0), np.asarray(-20.0), np.asarray(0.0)))),
        ("rescue_extreme", "rescue", dict(
            x=X_DUP, y=Y_DUP, config=GPConfig(**FIT_KW), panel=PANEL, steps=5, xs=XS,
            warm=(np.full(DIM, 8.0), np.asarray(8.0), np.asarray(-20.0), np.asarray(0.0)))),
        ("pathwise", "pathwise", dict(x=X, y=Y, raw=RAW, config=pcfg, panel=PANEL, xs=XS, n_paths=N_PATHS,
                                      **_path_draws())),
        ("route", "route", dict(x=X, y=Y, config=GPConfig(**FIT_KW), panel=PANEL)),
        *_padded_jobs(),
    ]


def _standardized(y):
    return (y - y.mean()) / y.std()


def _padded_jobs():
    """The padded layout's cases: the GP level at N = 30 and at N = 32 with
    panels of 12, the BO loop with q = 3, a factorization's spans."""
    draws = _path_draws()
    odd = dict(draws, eps=draws["eps"][:, :N_ODD])
    x_odd, y_odd = X[:N_ODD], Y[:N_ODD]
    rng = np.random.RandomState(11)
    bo_inputs = dict(x_init=rng.rand(BO_ODD["n_init"], DIM),
                     sobol=[rng.rand(BO_ODD["n_candidates"], DIM) for _ in range(3)])
    from turbojax_torch.bo import BOConfig

    return [
        ("padded_odd", "padded", dict(x=x_odd, y=y_odd, y_std=_standardized(y_odd), raw=RAW0,
                                      config=GPConfig(kernel="matern52"), panel=PANEL, xs=XS, **odd)),
        ("balanced_odd", "balanced", dict(x=x_odd, y=y_odd, y_std=_standardized(y_odd), raw=RAW0,
                                          config=GPConfig(kernel="matern52"), panel=PANEL, xs=XS, **odd)),
        ("balanced_spread", "balanced", dict(x=X[:N_SPREAD], y=Y[:N_SPREAD], y_std=_standardized(Y[:N_SPREAD]),
                                             raw=RAW0, config=GPConfig(kernel="matern52"), panel=PANEL, xs=XS,
                                             **dict(draws, eps=draws["eps"][:, :N_SPREAD]))),
        ("padded_even", "padded", dict(x=X, y=Y, y_std=Y_STD, raw=RAW, config=GPConfig(**GP_KW), panel=PANEL_PAD,
                                       xs=XS, **draws)),
        *((f"bo_odd_{acq}", "bo_loop", dict(bo=BOConfig(**BO_ODD, acq=acq), config=GPConfig(kernel="matern52"),
                                            budget_bytes=1, **bo_inputs)) for acq in ("ts", "ei")),
        ("factor_spans", "factor_spans", dict(x=x_odd, y=y_odd, raw=RAW0, config=GPConfig(kernel="matern52"),
                                              panel=PANEL)),
    ]


@functools.partial(jax.jit, static_argnames=("mesh", "config"))
def _jax_mll(raw, x, y_std, mesh, config):
    return jax.value_and_grad(lambda r, xx, yy: JDL.distributed_mll(r, xx, yy, mesh, config, PANEL),
                              argnums=(0, 1, 2))(raw, x, y_std)


def _jax_refs(world):
    mesh = JPAR.make_mesh(world, axis="rows")
    a = jnp.asarray
    ref = {}
    chol = JDL.distributed_cholesky(a(K_MAT), mesh, PANEL)
    mu, var = JDL.distributed_gp_posterior(chol, a(ALPHA), a(K_CROSS), a(K_DIAG), mesh, PANEL, mean=0.25)
    ref["linalg"] = {
        "chol": chol, "solve_lower": JDL.distributed_solve_lower(chol, a(B), mesh, PANEL),
        "solve_upper_t": JDL.distributed_solve_upper_t(chol, a(B), mesh, PANEL),
        "cho_solve": JDL.distributed_cho_solve(chol, a(B), mesh, PANEL),
        "logdet": JDL.distributed_logdet_from_chol(chol, mesh), "mu": mu, "var": var,
    }
    jp = {k: a(v) for k, v in PARAMS.items()}
    ref["kernel_chol"] = {"chol": JDL.distributed_kernel_chol(jp, a(X), mesh, PANEL, "matern52", jitter=1e-6)}
    jcfg = JGPConfig(**GP_KW)
    raw = JG.GPParams(*map(a, RAW))
    value, grads = _jax_mll(raw, a(X), a(Y_STD), mesh, jcfg)
    ref["mll"] = {"value": value, "grad_x": grads[1], "grad_y_std": grads[2],
                  **{f"grad_{f}": getattr(grads[0], f) for f in JG.GPParams._fields}}
    dgp = JDL.fit_distributed_gp(a(X), a(Y), mesh, JGPConfig(**FIT_KW), PANEL, steps=5)
    mu, var = dgp.posterior(a(XS))
    ref["fit"] = {**{f"raw_{i}": v for i, v in enumerate(dgp.raw)}, "mu": mu, "var": var, "mll": dgp.mll()}
    dgp = JDL._assemble_distributed_gp(a(X), a(Y), raw, jcfg, mesh, PANEL)
    mu, var = dgp.posterior(a(XS))
    paths = jax.jit(JDL.distributed_pathwise_paths, static_argnums=(1, 3, 4))(jax.random.key(PATH_SEED), dgp, a(XS),
                                                                             N_PATHS, M_FEAT)
    ref["pathwise"] = {"paths": paths, "mu": mu, "var": var, "mll": dgp.mll()}
    return {case: {k: np.asarray(v) for k, v in vals.items()} for case, vals in ref.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{world: (the port's outputs, JAX's)}; the spawned groups run while
    the world-1 cases and the JAX references are computed."""
    tmp = tmp_path_factory.mktemp("mesh")
    jobs = _jobs()
    spawned = {w: TMC.Spawned(w, jobs, tmp) for w in WORLDS if w > 1}
    with TMC.world1_group(tmp) as mesh:
        ports = {1: [TMC.run_jobs(jobs, mesh)]}
    with jax_compiled():
        refs = {w: _jax_refs(w) for w in WORLDS}
    for w, group in spawned.items():
        ports[w] = group.wait()
    return {w: (ports[w], refs[w]) for w in WORLDS}


def _case(results, world, case):
    ranks, ref = results[world]
    return TMC.same_on_every_rank(ranks, case), ref.get(case)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("what", ["chol", "solve_lower", "solve_upper_t", "cho_solve", "logdet", "mu", "var"])
def test_linalg_matches_jax(results, world, what):
    got, want = _case(results, world, "linalg")
    np.testing.assert_allclose(got[what], want[what], **TIGHT)


@pytest.mark.parametrize("world", WORLDS)
def test_kernel_chol_matches_jax_and_the_dense_factor(results, world):
    got, want = _case(results, world, "kernel_chol")
    np.testing.assert_allclose(got["chol"], want["chol"], **TIGHT)
    jitter = 1e-6 * (PARAMS["outputscale"] + PARAMS["noise"])
    dense = np.linalg.cholesky(K_MAT + jitter * np.eye(N))
    np.testing.assert_allclose(got["chol"], dense, **TIGHT)


@pytest.mark.parametrize("world", WORLDS)
def test_mll_value_and_gradient_match_jax(results, world):
    got, want = _case(results, world, "mll")
    np.testing.assert_allclose(got["value"], want["value"], **TIGHT)
    for name in ["grad_x", "grad_y_std"] + [f"grad_{f}" for f in JG.GPParams._fields]:
        np.testing.assert_allclose(got[name], want[name], **GRAD, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_fit_distributed_gp_adam5_matches_jax(results, world):
    got, want = _case(results, world, "fit")
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, rtol=1e-6, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["rescue", "rescue_extreme"])
def test_nan_rescue_gives_finite_hypers(results, world, case):
    got, _ = _case(results, world, case)
    assert got["finite"].all(), got["finite"]


@pytest.mark.parametrize("world", WORLDS)
def test_pathwise_draws_match_jax(results, world):
    got, want = _case(results, world, "pathwise")
    np.testing.assert_allclose(got["paths"], want["paths"], rtol=1e-8, atol=1e-10)
    for name in ("mu", "var", "mll"):
        np.testing.assert_allclose(got[name], want[name], **TIGHT, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_routing_by_mesh_size_and_budget(results, world):
    """budget_bytes=1: the distributed route on D ≥ 2, the dense one on a
    mesh of one device (``should_distribute`` as in the JAX package); the
    default budget: dense at N = 32."""
    got, _ = _case(results, world, "route")
    assert got["distributed"].tolist() == [world > 1, world > 1, False]
    assert np.isfinite(got["mll"])
    for w in (world,):
        assert JDL.should_distribute(N, JPAR.make_mesh(w), budget_bytes=1) == (w > 1)


# --------------------------------------------------------------------------
# The padded layout


def _reference_odd():
    """The plain float64 GP of ``portbench/reference/gp64.py`` on the N = 30
    case's data and hypers: the factor, α, the posterior, the MLL with its
    gradient (autograd through the plain dense MLL) and the pathwise
    values."""
    from portbench.reference import gp64 as R

    cfg = GPConfig(kernel="matern52")
    gp = {"kernel": "matern52", "noise_floor": cfg.noise_floor, "jitter": cfg.jitter,
          "lengthscale_bounds": list(cfg.lengthscale_bounds), "outputscale_bounds": list(cfg.outputscale_bounds),
          "noise_bounds": list(cfg.noise_bounds), "fit_lr": cfg.fit_lr}
    t = functools.partial(torch.tensor, dtype=torch.float64)
    x, y, xs = t(X[:N_ODD]), t(Y[:N_ODD]), t(XS)
    raw = torch.cat([t(RAW0.raw_lengthscale), t([float(RAW0.raw_outputscale), float(RAW0.raw_noise), 0.0])])
    post = R.posterior(x, y, raw, gp)
    k_s = R.kernel(xs, x, post.h, gp)
    v = torch.linalg.solve_triangular(post.l_mat, k_s.T, upper=False)
    draws = _path_draws()
    paths = R.pathwise_values(post, xs, *(t(draws[k]) for k in ("omega", "b", "w")), t(draws["eps"][:, :N_ODD]))
    x_g, y_g, raw_g = x.clone().requires_grad_(True), post.y_std.clone().requires_grad_(True), raw.requires_grad_(True)
    h = R.constrain(raw_g, gp)
    k = R.kernel(x_g, None, h, gp) + R.train_shift(h, gp["jitter"], gp["jitter"]) * torch.eye(N_ODD, dtype=x.dtype)
    l_mat = torch.linalg.cholesky(k)
    alpha = torch.cholesky_solve(y_g[:, None], l_mat)[:, 0]
    value = -0.5 * ((y_g * alpha).sum() + 2.0 * torch.log(l_mat.diagonal()).sum() + N_ODD * np.log(2 * np.pi))
    g_raw, g_x, g_y = torch.autograd.grad(value, [raw_g, x_g, y_g])
    n = lambda a: a.detach().numpy()  # noqa: E731
    return {"chol": n(post.l_mat), "alpha": n(post.alpha), "mu": n((k_s @ post.alpha) * post.y_sd + post.y_mean),
            "var": n((post.h.outputscale - (v * v).sum(dim=0)) * post.y_sd**2), "mll": n(value), "value": n(value),
            "paths": n(paths), "grad_x": n(g_x), "grad_y_std": n(g_y), "grad_raw_lengthscale": n(g_raw[:DIM]),
            "grad_raw_outputscale": n(g_raw[DIM]), "grad_raw_noise": n(g_raw[DIM + 1]),
            "grad_raw_mean": np.asarray(0.0)}


@pytest.mark.parametrize("world", WORLDS)
def test_padded_gp_at_an_odd_n_matches_the_plain_reference(results, world):
    """N = 30 on D = 1, 2, 4 with panels of 4: padded to 32 rows, the
    padded block of the factor the identity's and α zero on it; every value
    the plain reference's."""
    got, _ = _case(results, world, "padded_odd")
    want = _reference_odd()
    n = N_ODD
    assert int(got["n_pad"]) == 32
    chol = got["chol"]
    np.testing.assert_array_equal(chol[n:, :n], 0.0)
    np.testing.assert_array_equal(chol[n:, n:], np.eye(32 - n))
    np.testing.assert_array_equal(got["alpha"][n:], 0.0)
    np.testing.assert_allclose(chol[:n, :n], want["chol"], **TIGHT)
    np.testing.assert_allclose(got["alpha"][:n], want["alpha"], **TIGHT)
    for name in ("mu", "var", "mll", "value"):
        np.testing.assert_allclose(got[name], want[name], **TIGHT, err_msg=name)
    for name in ["grad_x", "grad_y_std"] + [f"grad_{f}" for f in JG.GPParams._fields]:
        np.testing.assert_allclose(got[name], want[name], **GRAD, err_msg=name)
    np.testing.assert_allclose(got["paths"], want["paths"], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_padded_gp_matches_the_unpadded_route(results, world):
    """N = 32 with panels of 12 (padded to 36, 48, 48 rows on D = 1, 2, 4)
    gives the values of the route at panels of 4, which pads nothing and is
    held against JAX above."""
    got, _ = _case(results, world, "padded_even")
    assert int(got["n_pad"]) == {1: 36, 2: 48, 4: 48}[world]
    mll, _ = _case(results, world, "mll")
    paths, _ = _case(results, world, "pathwise")
    np.testing.assert_allclose(got["value"], mll["value"], **TIGHT)
    for name in ["grad_x", "grad_y_std"] + [f"grad_{f}" for f in JG.GPParams._fields]:
        np.testing.assert_allclose(got[name], mll[name], **GRAD, err_msg=name)
    for name in ("mu", "var", "mll"):
        np.testing.assert_allclose(got[name], paths[name], **TIGHT, err_msg=name)
    np.testing.assert_allclose(got["paths"], paths["paths"], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("acq", ["ts", "ei"])
def test_run_bo_distributed_with_q3_visits_the_dense_points(results, world, acq):
    """n_init 7 and q = 3 at pinned hypers, forced onto the row-sharded GP
    on D = 2 and 4, visit the points of the dense route on one device (the
    pathwise draws from the same generator state)."""
    got, _ = _case(results, world, f"bo_odd_{acq}")
    dense, _ = _case(results, 1, f"bo_odd_{acq}")
    assert got["distributed"].tolist() == [world > 1] * 3 and not dense["distributed"].any()
    np.testing.assert_allclose(got["x_hist"], dense["x_hist"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["y_hist"], dense["y_hist"], rtol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_a_distributed_factorization_records_its_spans(results, world):
    """One ``dlinalg.factor`` holding one ladder, one rung and one read of
    the all-reduced flag here (the first rung succeeds)."""
    got, _ = _case(results, world, "factor_spans")
    counts = {k: int(got[k]) for k in ("dlinalg.factor", "linalg.cholesky_ladder", "linalg.cholesky_rung",
                                       "sync.dlinalg.ladder")}
    assert counts == {"dlinalg.factor": 1, "linalg.cholesky_ladder": 1, "linalg.cholesky_rung": 1,
                      "sync.dlinalg.ladder": 1}
    assert got["nested"].all(), got["nested"]


# --------------------------------------------------------------------------
# The dealt-out layout

# blocks a rank on D = 1, 2, 4 with panels of 4: N = 30 pads to 32 on every D, N = 17 to 20 / 24 / 32
BLOCKS = {"balanced_odd": {1: 1, 2: 4, 4: 2}, "balanced_spread": {1: 1, 2: 3, 4: 2}}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_dealt_out_blocks_give_the_values_of_one_block_a_rank(results, world, case):
    """The GP level's rows dealt out in snake order give, in float64, what
    one block a rank gives: the factor and α gathered in global order, the
    posterior, the MLL and its gradient in raw, x and y_std, the pathwise
    values, to 1e-12 of each array's largest magnitude, the gradient to
    1e-11 (one block a rank on D = 2 and 4 already differs from D = 1 by
    round-off of 5e-15 to 2e-13 of it, the gradient up to 1.4e-12: in raw
    noise, through K⁻¹). The padded rows stay the last global rows: the
    identity's block of the factor, α zero."""
    got, _ = _case(results, world, case)
    assert int(got["blocks"]) == BLOCKS[case][world] and int(got["contiguous_blocks"]) == 1
    n = N_ODD if case == "balanced_odd" else N_SPREAD
    n_pad = int(got["n_pad"])
    np.testing.assert_array_equal(got["chol"][n:, :n], 0.0)
    np.testing.assert_array_equal(got["chol"][n:, n:], np.eye(n_pad - n))
    np.testing.assert_array_equal(got["alpha"][n:], 0.0)
    for name in [k for k in got if not k.startswith("contiguous_") and k != "blocks"]:
        want = got[f"contiguous_{name}"]
        tol = 1e-11 if name.startswith("grad_") else 1e-12
        np.testing.assert_allclose(got[name], want, rtol=tol, atol=tol * np.abs(want).max(), err_msg=name)
