"""The port's profiler spans (``turbojax_torch.runlog.span``) on the CPU:
what a traced request and a traced large-N loop record, by name and
nesting, and that a span is one shared null context when no profiler
records. The benchmark's span metrics (``portbench/metrics/``) count and
time these names."""

import contextlib
import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from turbojax_torch import acq as A
from turbojax_torch import bo as BO
from turbojax_torch import gp as G
from turbojax_torch import linalg as L
from turbojax_torch import runlog as RL
from turbojax_torch.bo_distributed import run_bo_distributed
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

D = 2


def _spans(prof):
    """(name, start µs, end µs) of every span the trace holds, by start."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU and e.is_user_annotation]
    return sorted(out, key=lambda s: s[1])


def _count(spans, name):
    return sum(1 for s in spans if s[0] == name)


def _inside(spans, inner, outer):
    """Every ``inner`` span lies within some ``outer`` span."""
    outers = [s for s in spans if s[0] == outer]
    return all(any(o[1] <= s[1] and s[2] <= o[2] for o in outers) for s in spans if s[0] == inner)


def _carry(n=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, D), generator=g, dtype=torch.float64)
    y = torch.sum((x - 0.3) ** 2, dim=-1)
    cfg = GPConfig()
    state = G.make_gp_state(x, y, L.row_mask(n, n), G.default_params(D, cfg, torch.float64), cfg)
    return BO.BOCarry(x_buf=x, y_buf=y, n=n, chol=state.chol, raw=state.raw, y_mean=state.y_mean,
                      y_std=state.y_std), cfg


def test_an_exact_request_records_its_sampler_ladders_and_reads():
    """One chunked exact request: one ``bo.suggest`` holding one
    ``acq.sample``, one covariance ladder a chunk with at least one rung,
    and one ``sync.acq.ts_ladder`` read a rung tried (no ladder reaches its
    last, unread rung here); nothing outside the request."""
    carry, cfg = _carry()
    bo = BO.BOConfig(n_init=24, max_evals=24, batch_size=2, acq="ts", n_candidates=32, ts_chunk=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        BO._suggest(carry, cfg, bo, torch.Generator().manual_seed(1))
    spans = _spans(prof)
    assert _count(spans, "bo.suggest") == 1 and _count(spans, "acq.sample") == 1
    ladders, rungs = _count(spans, "linalg.cholesky_ladder"), _count(spans, "linalg.cholesky_rung")
    assert ladders == 32 // 8 and rungs >= ladders
    assert _count(spans, "sync.acq.ts_ladder") == rungs
    assert _count(spans, "gp.ts_cov") == ladders
    for inner, outer in (("acq.sample", "bo.suggest"), ("linalg.cholesky_ladder", "acq.sample"),
                         ("linalg.cholesky_rung", "linalg.cholesky_ladder"),
                         ("sync.acq.ts_ladder", "linalg.cholesky_ladder")):
        assert _inside(spans, inner, outer), (inner, outer)
    assert not any(s[0] == "gp.factor" or s[0].startswith("bo.it") for s in spans)


def test_a_failing_covariance_ladder_records_each_rung():
    """A covariance that fails every rung: three rungs in one ladder, the
    first two read back and the last not (its factor is NaN, unread)."""
    cov = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        l_cov = A._robust_cov_chol(cov, torch.tensor(1e-12, dtype=torch.float64))
    spans = _spans(prof)
    assert bool(torch.isnan(l_cov.diagonal()).all())
    assert _count(spans, "linalg.cholesky_ladder") == 1 and _count(spans, "linalg.cholesky_rung") == 3
    assert _count(spans, "sync.acq.ts_ladder") == 2


def test_a_large_n_loop_records_iterations_fits_and_callbacks():
    """``run_bo_distributed`` with a 2-step Adam refit every iteration:
    per fit ``fit_maxiter + 1`` ``gp.loss`` spans (the steps and the final
    forward) and one ``gp.factor``; the objective and ``on_iteration`` run
    inside ``bo.callback`` spans, the incumbent's read inside
    ``sync.bo.incumbent``, each inside its ``bo.iteration``."""
    cfg = dataclasses.replace(GPConfig(), fit_optimizer="adam", fit_maxiter=2, fit_restarts=1)
    bo = BO.BOConfig(n_init=8, max_evals=14, batch_size=2, acq="ts", n_candidates=32, fit_every=1,
                     rff_features=16)
    seen = []

    def fn(x):
        with record_function("test.objective"):
            return torch.sum((x - 0.3) ** 2, dim=-1)

    def on_iteration(it, best):
        with record_function("test.on_iteration"):
            seen.append(best)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_bo_distributed(fn, [0.0] * D, [1.0] * D, bo, cfg, on_iteration=on_iteration,
                           generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    spans = _spans(prof)
    iters = bo.n_iters
    assert len(seen) == iters and _count(spans, "bo.iteration") == iters
    assert _count(spans, "gp.loss") == iters * (cfg.fit_maxiter + 1)
    assert _count(spans, "gp.polish_backward") == iters * cfg.fit_maxiter
    assert _count(spans, "gp.factor") == iters and _count(spans, "acq.sample") == iters
    assert _count(spans, "sync.bo.incumbent") == iters
    assert _count(spans, "linalg.cholesky_ladder") == iters  # the factorization's, one a fit
    assert _count(spans, "test.objective") == 1 + iters  # the initial design, then each batch
    assert _count(spans, "bo.callback") == (1 + iters) + iters
    assert _inside(spans, "test.objective", "bo.callback") and _inside(spans, "test.on_iteration", "bo.callback")
    for inner in ("gp.loss", "gp.factor", "acq.sample", "sync.bo.incumbent", "sync.linalg.ladder"):
        assert _inside(spans, inner, "bo.iteration"), inner
    assert _inside(spans, "gp.loss", "bo.iteration") and not _inside(spans, "gp.loss", "gp.factor")


def test_each_differentiated_loss_records_one_mll_vjp():
    """An Adam fit of ``fit_maxiter`` steps over two lanes: one ``gp.mll_vjp``
    (the closed-form backward, both lanes at once) inside each step's
    ``gp.polish_backward``, none in the final forward (no gradient) nor in
    the grid's scoring; an L-BFGS fit records one a loss evaluation."""
    cfg = dataclasses.replace(GPConfig(), fit_optimizer="adam", fit_maxiter=3, fit_restarts=2)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((12, D), generator=g, dtype=torch.float64)
    y = torch.sum((x - 0.3) ** 2, dim=-1)
    mask = L.row_mask(12, 10)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        G.fit_gp(x, y, mask, cfg, restart_uniforms=torch.full((1, D + 2), 0.5, dtype=torch.float64))
    spans = _spans(prof)
    assert _count(spans, "gp.mll_vjp") == cfg.fit_maxiter == _count(spans, "gp.polish_backward")
    assert _count(spans, "gp.loss") == cfg.fit_maxiter + 1
    assert _inside(spans, "gp.mll_vjp", "gp.polish_backward")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        G.fit_gp(x, y, mask, dataclasses.replace(cfg, fit_optimizer="grid"))
    assert _count(_spans(prof), "gp.mll_vjp") == 0
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        G.fit_gp(x, y, mask, dataclasses.replace(cfg, fit_optimizer="lbfgs", fit_maxiter=2), stats=stats,
                 restart_uniforms=torch.full((1, D + 2), 0.5, dtype=torch.float64))
    assert _count(_spans(prof), "gp.mll_vjp") == stats["loss_evals"] >= 2


def test_span_is_one_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    first, second = RL.span("bo.suggest"), RL.span("gp.loss")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recording = RL.span("test.recorded")
        with recording:
            torch.ones(4).sum()
    assert isinstance(recording, record_function)
    assert [s[0] for s in _spans(prof)] == ["test.recorded"]
