"""TuRBO-1: single trust-region Bayesian optimization (port of
``turbojax.trust_region``).

A box trust region centered at the local incumbent with side ``length · w_i``
(ARD-lengthscale weights), Thompson-sampling candidate selection inside the
box, and a success/failure state machine: ``succ_tol`` successes double the
length (cap ``length_max``), ``fail_tol`` failures halve it, and dropping
below ``length_min`` restarts from a fresh Latin-hypercube design with the
local history discarded.

The JAX package runs the loop as one ``lax.scan``; here it is a host loop of
``n_iters`` steps over device tensors. The active count ``n`` is a Python
int (it is deterministic given the restarts), so the init/search branch is a
plain ``if``. Per step the host reads back the restart decision and the
Cholesky ladders' ``info`` codes, and nothing else.
Buffers stay statically shaped and masked, ``(N_max, ·)``, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from turbojax_torch import acq as A
from turbojax_torch import gp as G
from turbojax_torch import linalg as L
from turbojax_torch import sampling as S
from turbojax_torch import transforms as T
from turbojax_torch.config import GPConfig, TRConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TurboConfig:
    """TuRBO loop knobs (same fields and defaults as the JAX package's)."""

    n_init: int = 20
    max_evals: int = 200
    batch_size: int = 10
    n_candidates: Optional[int] = None  # default min(100 d, 5000)
    fit_every: int = 1  # refit cadence in accepted batches (search phase); see refits_now
    local_frac: float = 0.0  # share of the candidates drawn around the center (sampling.tr_candidates)
    local_sigma: float = 0.3  # their σ, in TR half widths
    sobol_scramble: str = "shift"
    ts_chunk: Optional[int] = None
    ts_sampler: str = "exact"  # "exact" | "rff" | "pathwise" (acq.thompson_values)
    ts_dtype: Optional[str] = None  # "float64": the exact sampler in f64 (acq.thompson_samples)
    rff_features: int = 1024
    alloc_cap: Optional[int] = None
    tr: TRConfig = TRConfig()

    @property
    def n_iters(self) -> int:
        return max(0, (self.max_evals - self.n_init + self.batch_size - 1) // self.batch_size)


class TRState(NamedTuple):
    """The trust-region state machine variables (0-dim tensors)."""

    length: Tensor
    succ: Tensor  # int
    fail: Tensor  # int
    restarts: Tensor  # int: restarts so far
    stag: Tensor  # int: consecutive search batches without an improvement


def tr_init(dtype=torch.float32, length_init: float = 0.8, device=None) -> TRState:
    def zero():
        return torch.zeros((), dtype=torch.int64, device=device)

    return TRState(
        length=torch.tensor(length_init, dtype=dtype, device=device),
        succ=zero(), fail=zero(), restarts=zero(), stag=zero(),
    )


def tr_update(state: TRState, improved, counted, tr: TRConfig, fail_tol: int) -> TRState:
    """One success/failure transition. ``improved``: did this batch improve
    the local incumbent by more than ``success_eps·|best|``; ``counted``:
    whether this step participates (False in the init phase)."""
    improved = torch.as_tensor(improved, device=state.length.device)
    counted = torch.as_tensor(counted, device=state.length.device)
    zero = torch.zeros_like(state.succ)
    succ = torch.where(improved, state.succ + 1, zero)
    fail = torch.where(improved, zero, state.fail + 1)
    expand = succ >= tr.succ_tol
    shrink = fail >= fail_tol
    length = torch.where(
        expand,
        torch.clamp_max(2.0 * state.length, tr.length_max),
        torch.where(shrink, 0.5 * state.length, state.length),
    )
    succ = torch.where(expand, zero, succ)
    fail = torch.where(shrink, zero, fail)
    return TRState(
        length=torch.where(counted, length, state.length),
        succ=torch.where(counted, succ, state.succ),
        fail=torch.where(counted, fail, state.fail),
        restarts=state.restarts,
        stag=state.stag,  # tracked by turbo_absorb
    )


class TurboCarry(NamedTuple):
    """Loop state of one trust region; ``n`` is a host int. TuRBO-m stacks
    the regions on a leading TR axis, and ``n`` is then a tuple of ints."""

    x_buf: Tensor  # (N_loc, d) TR-local history, unit cube, zero-padded
    y_buf: Tensor  # (N_loc,)
    n: int  # active count (resets on restart)
    raw: G.GPParams  # warm-start hypers
    tr: TRState
    init_stream: Tensor  # (stream_len, d) LHS points for the current restart
    best_x: Tensor  # (d,) global best across restarts (unit cube)
    best_y: Tensor  # ()


def _stream_len(cfg: TurboConfig) -> int:
    q = cfg.batch_size
    return ((cfg.n_init + q - 1) // q) * q


def make_turbo_carry(dim: int, n_loc: int, cfg: TurboConfig, config: GPConfig,
                     generator: torch.Generator, dtype=torch.float32, device=None) -> TurboCarry:
    """Initial carry: empty buffers, init phase about to stream its LHS."""
    return TurboCarry(
        x_buf=torch.zeros((n_loc, dim), dtype=dtype, device=device),
        y_buf=torch.zeros((n_loc,), dtype=dtype, device=device),
        n=0,
        raw=G.default_params(dim, config, dtype, device),
        tr=tr_init(dtype, cfg.tr.length_init, device),
        init_stream=S.latin_hypercube(_stream_len(cfg), dim, generator, dtype, device),
        best_x=torch.zeros((dim,), dtype=dtype, device=device),
        best_y=torch.tensor(torch.inf, dtype=dtype, device=device),
    )


def refits_now(n: int, cfg: TurboConfig) -> bool:
    """The refit cadence: refit on every ``fit_every``-th batch of accepted
    data, ``(n − n_init) // q``, so a region whose allocation share varies
    refits per ~``fit_every·q`` points, and a region that just restarted
    refits on its first search batch."""
    return cfg.fit_every <= 1 or ((n - cfg.n_init) // cfg.batch_size) % cfg.fit_every == 0


def _fit_or_reuse(c: TurboCarry, mask: Tensor, cfg: TurboConfig, config: GPConfig,
                  generator: Optional[torch.Generator] = None) -> G.GPState:
    """Refit at the cadence of ``refits_now``; otherwise reuse the carried
    hypers and only refactorize over the grown history."""
    if refits_now(c.n, cfg):
        return G.fit_gp(c.x_buf, c.y_buf, mask, config, warm_start=c.raw, generator=generator)
    return G.make_gp_state(c.x_buf, c.y_buf, mask, c.raw, config)


def candidates(carry: TurboCarry, state: G.GPState, cfg: TurboConfig, n_cand: int,
               generator: Optional[torch.Generator] = None) -> Tensor:
    """Trust-region candidates around the local incumbent of one region,
    shaped by the fitted lengthscales."""
    dim = carry.x_buf.shape[-1]
    mask = L.row_mask(carry.x_buf.shape[0], carry.n, carry.x_buf.device)
    best_idx = torch.argmin(torch.where(mask, carry.y_buf, torch.inf)).reshape(1)
    ls = torch.broadcast_to(state.params["lengthscale"], (dim,))
    return S.tr_candidates(
        carry.x_buf.index_select(0, best_idx)[0], carry.tr.length, ls, n_cand, generator,
        local_frac=cfg.local_frac, scramble=cfg.sobol_scramble, local_sigma=cfg.local_sigma,
    )


def turbo_propose(
    carry: TurboCarry, cfg: TurboConfig, config: GPConfig,
    generator: Optional[torch.Generator] = None,
    cands: Optional[Tensor] = None, draws: A.Draws = A.Draws(),
) -> Tuple[TurboCarry, Tensor, bool]:
    """Propose ``batch_size`` unit-cube points.

    Init phase (``n < n_init``): slice the LHS stream. Search phase: refit
    (at the ``fit_every`` cadence) and Thompson-sample trust-region
    candidates with ``cfg.ts_sampler``. ``cands`` ((n_cand, d)) replaces the
    candidate draws and ``draws`` the sampler's. Returns (carry, (q, d)
    proposals, in_search)."""
    q = cfg.batch_size
    n_cand = cfg.n_candidates or S.n_candidates(carry.x_buf.shape[-1])
    if carry.n < cfg.n_init:
        start = min(carry.n, carry.init_stream.shape[0] - q)
        return carry, carry.init_stream[start:start + q], False
    mask = L.row_mask(carry.x_buf.shape[0], carry.n, carry.x_buf.device)
    state = _fit_or_reuse(carry, mask, cfg, config, generator)
    carry = carry._replace(raw=state.raw)
    if cands is None:
        cands = candidates(carry, state, cfg, n_cand, generator)
    values = A.thompson_values(state, cands, q, config, cfg.ts_sampler, cfg.ts_chunk, cfg.ts_dtype,
                               cfg.rff_features, generator, draws)
    idxs, _ = A.select_q_batch(values)
    return carry, cands[idxs], True


def stack_carries(carries: Sequence[TurboCarry]) -> TurboCarry:
    """Stack per-region carries on a new leading TR axis (``n`` becomes a
    tuple of host ints)."""
    def stack(field):
        return torch.stack([getattr(c, field) for c in carries])

    return TurboCarry(
        x_buf=stack("x_buf"), y_buf=stack("y_buf"), n=tuple(c.n for c in carries),
        raw=G.GPParams(*(torch.stack(a) for a in zip(*(c.raw for c in carries)))),
        tr=TRState(*(torch.stack(a) for a in zip(*(c.tr for c in carries)))),
        init_stream=stack("init_stream"), best_x=stack("best_x"), best_y=stack("best_y"),
    )


def carry_lane(carries: TurboCarry, i: int) -> TurboCarry:
    """Region ``i`` of carries stacked on a leading TR axis."""
    return TurboCarry(
        x_buf=carries.x_buf[i], y_buf=carries.y_buf[i], n=carries.n[i],
        raw=G.GPParams(*(a[i] for a in carries.raw)), tr=TRState(*(a[i] for a in carries.tr)),
        init_stream=carries.init_stream[i], best_x=carries.best_x[i], best_y=carries.best_y[i],
    )


def absorb(
    carries: TurboCarry, x_new: Tensor, y_new: Tensor, accept, in_search: Sequence[bool],
    cfg: TurboConfig, fail_tol: int, generator: Optional[torch.Generator] = None,
    restart_streams: Optional[Tensor] = None,
) -> TurboCarry:
    """Fold one evaluated batch into carries stacked on a leading TR axis
    (``n`` a tuple of host ints): buffer writes, incumbent update, counter
    transition, and restart of every region that collapsed.

    ``accept`` ((m, q) bool, read on the host: it is the allocation the
    host already holds) credits each region with its own points only:
    region i writes its accepted rows in batch order up to its capacity,
    takes its incumbent from them, and counts the step only when it is in
    its search phase and accepted a point; a search-phase region that the
    allocation starved still counts toward ``stag``. ``in_search``: one host
    bool per region. ``restart_streams`` ((m, stream_len, d)) replaces the
    LHS draws of the regions that restart. The restart decisions are read
    back to the host, one read for all regions."""
    x_buf, y_buf = carries.x_buf, carries.y_buf
    m, n_loc = y_buf.shape
    device = x_buf.device
    acc = np.asarray(torch.as_tensor(accept).cpu(), dtype=bool).reshape(m, -1)
    n_before = torch.tensor(carries.n, device=device)
    mask_before = torch.arange(n_loc, device=device)[None, :] < n_before[:, None]
    local_best_before = torch.where(mask_before, y_buf, torch.inf).min(dim=-1).values

    ns = list(carries.n)
    regions, slots, rows = [], [], []
    for i in range(m):
        take = np.flatnonzero(acc[i])[: n_loc - ns[i]]  # accepted rows that still fit
        regions += [i] * len(take)
        slots += range(ns[i], ns[i] + len(take))
        rows += take.tolist()
        ns[i] += len(take)
    if rows:
        where_to = (torch.tensor(regions, device=device), torch.tensor(slots, device=device))
        src = torch.tensor(rows, device=device)
        x_buf = x_buf.index_put(where_to, x_new.index_select(0, src))
        y_buf = y_buf.index_put(where_to, y_new.index_select(0, src))

    acc_t = torch.as_tensor(acc, device=device)
    y_masked = torch.where(acc_t, y_new[None, :], torch.inf)
    batch_best = y_masked.min(dim=-1).values
    better = batch_best < carries.best_y
    best_y = torch.where(better, batch_best, carries.best_y)
    best_x = torch.where(better[:, None], x_new.index_select(0, torch.argmin(y_masked, dim=-1)), carries.best_x)

    thresh = local_best_before - cfg.tr.success_eps * torch.abs(local_best_before)
    improved = batch_best < thresh
    searching = torch.tensor(list(in_search), device=device)
    counted = torch.tensor([bool(s) and bool(a.any()) for s, a in zip(in_search, acc)], device=device)
    new_tr = tr_update(carries.tr, improved, counted, cfg.tr, fail_tol)
    stag = torch.where(searching, torch.where(improved, 0, carries.tr.stag + 1), carries.tr.stag)
    tr = new_tr._replace(stag=stag)

    needs_restart = tr.length < cfg.tr.length_min
    if cfg.tr.stagnation_tol is not None:
        needs_restart = needs_restart | (tr.stag >= cfg.tr.stagnation_tol)
    flags = needs_restart.tolist()
    init_stream = carries.init_stream
    if any(flags):
        r = needs_restart
        zero = torch.zeros_like(tr.succ)
        x_buf = torch.where(r[:, None, None], torch.zeros_like(x_buf), x_buf)
        y_buf = torch.where(r[:, None], torch.zeros_like(y_buf), y_buf)
        ns = [0 if f else k for f, k in zip(flags, ns)]
        tr = TRState(
            length=torch.where(r, torch.full_like(tr.length, cfg.tr.length_init), tr.length),
            succ=torch.where(r, zero, tr.succ), fail=torch.where(r, zero, tr.fail),
            restarts=tr.restarts + r.to(tr.restarts.dtype), stag=torch.where(r, zero, tr.stag),
        )
        idx = [i for i, f in enumerate(flags) if f]
        if restart_streams is None:
            stream_len, dim = init_stream.shape[1:]
            fresh = torch.stack([
                S.latin_hypercube(stream_len, dim, generator, init_stream.dtype, device) for _ in idx
            ])
        else:
            fresh = restart_streams[idx].to(init_stream.dtype)
        init_stream = init_stream.index_copy(0, torch.tensor(idx, device=device), fresh)
    return carries._replace(
        x_buf=x_buf, y_buf=y_buf, n=tuple(ns), tr=tr, init_stream=init_stream, best_x=best_x, best_y=best_y,
    )


def turbo_absorb(
    carry: TurboCarry, x_new: Tensor, y_new: Tensor, in_search: bool, cfg: TurboConfig,
    fail_tol: int, generator: Optional[torch.Generator] = None, accept=None,
) -> TurboCarry:
    """``absorb`` for one trust region. ``accept`` ((q,) bool, default all
    True as TuRBO-1 passes it) marks the points credited to this region."""
    if accept is None:
        accept = np.ones(x_new.shape[0], dtype=bool)
    accept = np.asarray(torch.as_tensor(accept).cpu(), dtype=bool)[None]
    out = absorb(stack_carries([carry]), x_new, y_new, accept, [in_search], cfg, fail_tol, generator)
    return carry_lane(out, 0)


def run_turbo1(
    fn: Callable[[Tensor], Tensor],
    lb: Sequence[float],
    ub: Sequence[float],
    cfg: TurboConfig,
    config: GPConfig,
    generator: torch.Generator,
    dtype=torch.float32,
    n_loc: Optional[int] = None,
    on_iteration: Optional[Callable[[int, Tensor], None]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> Tuple[TurboCarry, Tensor]:
    """TuRBO-1 as a host loop of ``cfg.n_iters`` steps on the device of
    ``generator``. ``fn`` maps a (q, d) tensor in the box to a (q,) tensor.
    ``on_iteration(iteration, best)`` is called after each step with the
    incumbent as a device tensor (reading it is the caller's sync).

    ``checkpoint_path`` with ``checkpoint_every=k`` saves the carry and the
    generator's state every k iterations; ``resume=True`` restores them from
    ``checkpoint_path`` when it exists (a fresh start otherwise) and
    continues the uninterrupted run bit for bit.
    Returns (carry, incumbent trace (n_iters,))."""
    from turbojax_torch.checkpoint import RunCheckpointer

    device = generator.device
    dim = len(lb)
    n_loc = n_loc or cfg.n_init + cfg.n_iters * cfg.batch_size
    lb_t = torch.tensor(tuple(lb), dtype=dtype, device=device)
    ub_t = torch.tensor(tuple(ub), dtype=dtype, device=device)
    fail_tol = cfg.tr.resolved_fail_tol(dim, cfg.batch_size)
    ckpt = RunCheckpointer(checkpoint_path, checkpoint_every, generator)
    carry, trace = ckpt.start(
        resume, lambda: make_turbo_carry(dim, 0, cfg, config, torch.Generator(device=device), dtype, device), lb_t,
        lambda: make_turbo_carry(dim, n_loc, cfg, config, generator, dtype, device))
    for it in range(len(trace), cfg.n_iters):
        carry, xs, in_search = turbo_propose(carry, cfg, config, generator)
        ys = fn(T.from_unit_cube(xs, lb_t, ub_t)).to(dtype)
        ys = T.impute_failures(ys, carry.y_buf, L.row_mask(n_loc, carry.n, device))
        carry = turbo_absorb(carry, xs, ys, in_search, cfg, fail_tol, generator)
        trace.append(carry.best_y)
        if on_iteration is not None:
            on_iteration(it, carry.best_y)
        ckpt.maybe_save(it + 1, carry, trace, last=it + 1 == cfg.n_iters)
    return carry, torch.stack(trace) if trace else torch.empty(0, dtype=dtype, device=device)


#: The JAX package's checkpointable segmented loop; here every loop is a
#: host loop that checkpoints, so it is ``run_turbo1`` itself.
run_turbo1_host = run_turbo1
