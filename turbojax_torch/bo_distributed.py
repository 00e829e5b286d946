"""Plain Bayesian optimization at large N (port of ``turbojax.bo_distributed``).

``run_bo_distributed`` is the plain BO loop over an unmasked, growing
history, with the surrogate routed through ``distributed_linalg.fit_gp_auto``
and ``refactor_gp_auto``: the dense GP without a mesh, on a mesh of one
device or below the memory threshold; above it on a larger mesh, the
row-sharded ``DistributedGP`` (in-shard kernel builds, blocked Cholesky, an
Adam fit of the distributed MLL). Every kernel-matrix build, dense or a row
block, goes through ``cuda_kernels.kernel_matrix`` on CUDA tensors.
Acquisition is EI or LCB over a fresh candidate set against the posterior
(with the candidate axis sharded across the mesh above ``CAND_SHARD_MIN``
candidates when the GP is dense: ``parallel.sharded_acq_topq``), or batch
Thompson sampling by the decoupled pathwise sampler
(``acq.pathwise_paths``, ``distributed_linalg.distributed_pathwise_paths``):
the chunked exact sampler factorizes chunk² candidate covariances that the
distributed posterior never forms, so ``acq="ts"`` always routes to
pathwise and ``ts_sampler="rff"`` is rejected. ``GPConfig.y_warp`` is
honoured: the surrogate models ``warp_y(y)`` and the EI incumbent is warped
at the same point.

With a mesh every rank runs the loop with the same arguments and a
generator in the same state (``parallel``'s layout contract), so the
replicated draws agree; rank 0 evaluates the objective and broadcasts its
values, and rank 0 alone writes the checkpoint, followed by a barrier,
while every rank reads it on resume.

The loop runs on the host: at this scale one fit is seconds of device time,
and the history grows by a batch each iteration. Every random draw comes
from ``generator`` or is handed in (``x_init`` and ``draws``), which lets the
tests replay the JAX package's keys.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from turbojax_torch import acq as A
from turbojax_torch import gp as G
from turbojax_torch import parallel as PAR
from turbojax_torch import sampling as S
from turbojax_torch import transforms as T
from turbojax_torch.bo import BOConfig, lowest_k
from turbojax_torch.config import GPConfig
from turbojax_torch.distributed_linalg import DENSE_BUDGET_BYTES, DistributedGP, fit_gp_auto, refactor_gp_auto
from turbojax_torch.runlog import span

Tensor = torch.Tensor

#: Candidate count below which a multi-device mesh does not shard the
#: candidate axis (``BOConfig.cand_shard_min`` overrides it; 0 always
#: shards). The JAX package's value, measured on its 8-device CPU
#: simulation (at 5000 candidates sharding lost, from ~32k it paid). A mesh
#: of one device never shards, so one card cannot re-measure it.
CAND_SHARD_MIN = 32768


class BigBOResult(NamedTuple):
    x_hist: Tensor  # (n, d) original box
    y_hist: Tensor  # (n,)
    best_x: Tensor
    best_y: Tensor
    incumbent_trace: Tensor  # (n_iters,) best y after each iteration


class IterationDraws(NamedTuple):
    """One iteration's random draws; each that is given replaces the
    generator's draw of it."""

    sobol: Optional[Tensor] = None  # (n_candidates − n_local, d) candidates in the unit cube
    local: Optional[Tensor] = None  # (n_local, d) standard normals of the local pool
    ts: A.Draws = A.Draws()  # the pathwise sampler's
    restart_uniforms: Optional[Tensor] = None  # the fit's (gp.fit_gp)


def run_bo_distributed(
    fn: Callable[[Tensor], Tensor],
    lb: Sequence[float],
    ub: Sequence[float],
    bo: BOConfig,
    config: GPConfig = GPConfig(),
    mesh: Optional[PAR.Mesh] = None,
    budget_bytes: int = DENSE_BUDGET_BYTES,
    on_iteration: Optional[Callable[[int, float], None]] = None,
    fixed_params: Optional[G.GPParams] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    runlog=None,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype=torch.float32,
    x_init: Optional[Tensor] = None,
    draws: Optional[Callable[[int], IterationDraws]] = None,
) -> BigBOResult:
    """The BO loop with the surrogate auto-routed over ``mesh`` (see the
    module docstring). ``fn`` maps a (q, d) tensor in the box to a (q,)
    tensor; with a mesh it runs on rank 0 only.
    ``bo.acq`` is "ei", "lcb" or "ts" (the pathwise sampler, with
    ``bo.rff_features`` prior features). Failures (NaN/inf y) are imputed
    against the history.

    Refits follow ``bo.fit_every``: 0 never fits (``fixed_params``, or the
    defaults, stay pinned and only the factorization is rebuilt); otherwise
    the loop fits when there are no hypers yet or ``it % fit_every == 0``
    and else refactorizes at the pinned hypers over the grown history.

    Runs on ``generator.device``, or on ``device`` with a generator seeded
    with 0; the default device is the GPU (with a mesh, ``mesh.device``),
    and the CPU runs only when asked for. With a mesh, ``n_init`` and
    ``batch_size`` may be any sizes: the distributed history is padded to
    a multiple of the mesh size times the panel of 128, and masked
    (``distributed_linalg``'s padded layout). ``x_init`` ((n_init, d), unit
    cube) replaces the initial Latin hypercube, and ``draws(it)`` gives
    iteration ``it``'s ``IterationDraws``. ``checkpoint_path`` with
    ``checkpoint_every=k`` saves the history, the pinned hypers and the
    generator's state every k iterations (and after the last; with a mesh,
    rank 0 writes); ``resume=True`` restores them, the leaves at the shapes
    in the file, and continues the uninterrupted run bit for bit.
    ``on_iteration(it, best)`` is called with the incumbent as a float;
    ``runlog`` receives one record per iteration: ``best_y``, the history
    size ``n``, the ``route`` and the iteration's wall ``iter_s``."""
    from turbojax_torch.checkpoint import RunCheckpointer

    if bo.acq not in ("ei", "lcb", "ts"):
        raise ValueError("run_bo_distributed supports acq 'ei', 'lcb', or 'ts'")
    if bo.acq == "ts" and bo.ts_sampler == "rff":
        raise ValueError(
            "ts_sampler='rff' is not supported on the distributed path: weight-space conditioning starves at the "
            "noise floor and the exact-conditioning pathwise sampler costs the same matmuls; use "
            "ts_sampler='pathwise' (or leave the default: 'ts' always routes to the pathwise sampler here)"
        )
    n_dev = mesh.size if mesh is not None else 1
    generator = PAR.run_generator(device, generator, mesh, 0, "run_bo_distributed")
    device = generator.device
    dim = len(lb)
    lb_t = torch.tensor(tuple(lb), dtype=dtype, device=device)
    ub_t = torch.tensor(tuple(ub), dtype=dtype, device=device)
    q = bo.batch_size

    def caller_fn(x: Tensor) -> Tensor:
        with span("bo.callback"):
            return fn(x)

    def evaluate(x_unit: Tensor) -> Tensor:
        x = T.from_unit_cube(x_unit, lb_t, ub_t)
        if mesh is not None:
            return PAR.evaluate_on_rank0(caller_fn, x, mesh)
        return caller_fn(x).to(dtype).reshape(-1)

    def pinned() -> G.GPParams:
        return fixed_params if fixed_params is not None else G.default_params(dim, config, dtype, device)

    def like():
        # leaf shapes come from the file: only the structure, devices and dtypes matter
        return {"x": torch.zeros((0, dim), dtype=dtype, device=device),
                "y": torch.zeros((0,), dtype=dtype, device=device), "warm": pinned()}

    def fresh():
        x0 = x_init if x_init is not None else S.latin_hypercube(bo.n_init, dim, generator, dtype, device)
        x0 = x0.to(dtype=dtype, device=device)
        # a masked-out dummy row: with no history the penalty falls to the floor
        y0 = T.impute_failures(evaluate(x0), torch.zeros(1, dtype=dtype, device=device),
                               torch.zeros(1, dtype=torch.bool, device=device))
        return {"x": x0, "y": y0, "warm": None}

    ckpt = RunCheckpointer(checkpoint_path, checkpoint_every, generator, mesh)
    state, trace = ckpt.start(resume, like, torch.empty(0, dtype=dtype, device=device), fresh)
    x_hist, y_hist, warm = state["x"], state["y"], state["warm"]

    for it in range(len(trace), bo.n_iters):
        with span("bo.iteration"):
            t_it = time.perf_counter()
            if draws is not None:
                with span("bo.callback"):
                    d_it = draws(it)
            else:
                d_it = IterationDraws()
            route = dict(mesh=mesh, panel=128, budget_bytes=budget_bytes)
            if bo.fit_every == 0:
                # 0 = never fit: pin the given (or default) hypers and only refresh
                # the factorization as the history grows. Routing on `g is None`
                # here would sneak one full MLL fit in at iteration 0.
                if warm is None:
                    warm = pinned()
                g = refactor_gp_auto(x_hist, y_hist, warm, config, **route)
            elif warm is None or it % bo.fit_every == 0:
                # `warm is None`, not `g is None`: a resumed run starts at an
                # arbitrary `it`, and an off-cadence iteration must refactorize at
                # the restored hypers, as the uninterrupted run did, not fit
                g = fit_gp_auto(x_hist, y_hist, config, warm_start=warm, generator=generator,
                                restart_uniforms=d_it.restart_uniforms, **route)
                warm = g.raw
            else:
                # off-cadence: the hypers stay pinned, but the factorization must
                # cover the grown history (a stale factor skips the newest batches)
                g = refactor_gp_auto(x_hist, y_hist, warm, config, **route)

            n_local = int(bo.local_frac * bo.n_candidates)
            cands = d_it.sobol
            if cands is None:
                cands = S.sobol_sample(dim, bo.n_candidates - n_local, generator, dtype, device, bo.sobol_scramble)
            cands = cands.to(dtype=dtype, device=device)
            if n_local:
                inc = x_hist.index_select(0, torch.argmin(y_hist).reshape(1))
                noise = d_it.local
                if noise is None:
                    noise = torch.randn((n_local, dim), generator=generator, dtype=dtype, device=device)
                local = inc + bo.local_sigma * noise.to(dtype=dtype, device=device)
                cands = torch.cat([cands, torch.clamp(local, 0.0, 1.0)], dim=0)

            distributed = isinstance(g, DistributedGP)
            if bo.acq == "ts":
                # pathwise draws, globally joint over the candidates, conditioned
                # exactly through the cached (dense or row-sharded) factor; the
                # warp is monotone in y, so the argmin selection is unchanged
                values = g.pathwise_paths(cands, q, bo.rff_features, generator, d_it.ts)
                x_new = cands[A.select_q_batch(values)[0]]
            else:
                # the surrogate predicts warp_y(y), so the EI incumbent is warped
                # too (monotone: the warp commutes with min)
                best = T.warp_y(y_hist.min(), config.y_warp)
                n_cand = cands.shape[0]
                cand_min = bo.cand_shard_min if bo.cand_shard_min is not None else CAND_SHARD_MIN
                if (n_dev > 1 and not distributed and n_cand % n_dev == 0 and q <= n_cand // n_dev
                        and n_cand >= cand_min):
                    # the candidate axis sharded: the dense state is replicated,
                    # each rank scores its block, and the global top-q rides an
                    # all-gather of q·D survivors
                    shard = n_cand // n_dev
                    x_new, _ = PAR.sharded_acq_topq(g.state, cands[mesh.rank * shard:(mesh.rank + 1) * shard], best, q,
                                                    mesh, config, acq=bo.acq, kappa=bo.kappa, xi=bo.xi)
                else:
                    mu, var = g.posterior(cands)
                    if bo.acq == "ei":
                        scores = -A.expected_improvement(mu, var, best, bo.xi)
                    else:
                        scores = A.lower_confidence_bound(mu, var, bo.kappa)
                    x_new = cands[lowest_k(scores, q)]

            y_new = T.impute_failures(evaluate(x_new), y_hist, torch.ones_like(y_hist, dtype=torch.bool))
            x_hist = torch.cat([x_hist, x_new], dim=0)
            y_hist = torch.cat([y_hist, y_new])
            trace.append(y_hist.min())
            if on_iteration is not None or runlog is not None:
                with span("sync.bo.incumbent"):
                    best_f = float(trace[-1])
                if on_iteration is not None:
                    with span("bo.callback"):
                        on_iteration(it, best_f)
                if runlog is not None:
                    with span("bo.callback"):
                        runlog.log(it, best_y=best_f, n=int(x_hist.shape[0]),
                                   route="distributed" if distributed else "dense",
                                   iter_s=round(time.perf_counter() - t_it, 4))
            ckpt.maybe_save(it + 1, {"x": x_hist, "y": y_hist, "warm": warm}, trace, last=it + 1 == bo.n_iters)

    best_i = torch.argmin(y_hist).reshape(1)
    return BigBOResult(
        x_hist=T.from_unit_cube(x_hist, lb_t, ub_t),
        y_hist=y_hist,
        best_x=T.from_unit_cube(x_hist.index_select(0, best_i)[0], lb_t, ub_t),
        best_y=y_hist.index_select(0, best_i)[0],
        incumbent_trace=torch.stack(trace) if trace else torch.empty(0, dtype=dtype, device=device),
    )
