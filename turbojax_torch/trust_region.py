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
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

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
    """TuRBO loop knobs (same fields and defaults as the JAX package's).
    Only the values of config 4's path are ported: ``ts_sampler="exact"``,
    ``ts_dtype=None``, ``sobol_scramble="shift"`` and ``local_frac=0``;
    others raise ``NotImplementedError`` when the loop reaches them."""

    n_init: int = 20
    max_evals: int = 200
    batch_size: int = 10
    n_candidates: Optional[int] = None  # default min(100 d, 5000)
    fit_every: int = 1  # refit cadence in accepted batches (search phase)
    local_frac: float = 0.0
    local_sigma: float = 0.3
    sobol_scramble: str = "shift"
    ts_chunk: Optional[int] = None
    ts_sampler: str = "exact"
    ts_dtype: Optional[str] = None
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
    """Loop state of one trust region. ``n`` is a host int."""

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


def _fresh_restart(carry: TurboCarry, generator: torch.Generator, stream_len: int,
                   tr_cfg: TRConfig) -> TurboCarry:
    """Discard local history, draw a new LHS stream, reset the TR state."""
    x = carry.x_buf
    zero = torch.zeros_like(carry.tr.succ)
    return carry._replace(
        x_buf=torch.zeros_like(x),
        y_buf=torch.zeros_like(carry.y_buf),
        n=0,
        tr=TRState(
            length=torch.tensor(tr_cfg.length_init, dtype=x.dtype, device=x.device),
            succ=zero, fail=zero, restarts=carry.tr.restarts + 1, stag=zero,
        ),
        init_stream=S.latin_hypercube(stream_len, x.shape[-1], generator, x.dtype, x.device),
    )


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


def _fit_or_reuse(c: TurboCarry, mask: Tensor, cfg: TurboConfig, config: GPConfig) -> G.GPState:
    """Refit every ``fit_every``-th batch of accepted data; otherwise reuse
    the carried hypers and only refactorize over the grown history."""
    if cfg.fit_every <= 1 or ((c.n - cfg.n_init) // cfg.batch_size) % cfg.fit_every == 0:
        return G.fit_gp(c.x_buf, c.y_buf, mask, config, warm_start=c.raw)
    return G.make_gp_state(c.x_buf, c.y_buf, mask, c.raw, config)


def _check_ported(cfg: TurboConfig):
    if cfg.ts_sampler != "exact":
        raise NotImplementedError(f"ts_sampler={cfg.ts_sampler!r} is not ported yet; only 'exact' is")
    if cfg.ts_dtype is not None:
        raise NotImplementedError(f"ts_dtype={cfg.ts_dtype!r} is not ported yet; only None is")


def turbo_propose(
    carry: TurboCarry, cfg: TurboConfig, config: GPConfig,
    generator: Optional[torch.Generator] = None,
    cands: Optional[Tensor] = None, normals: Optional[Tensor] = None,
) -> Tuple[TurboCarry, Tensor, bool]:
    """Propose ``batch_size`` unit-cube points.

    Init phase (``n < n_init``): slice the LHS stream. Search phase: refit
    and Thompson-sample trust-region candidates. ``cands`` ((n_cand, d)) and
    ``normals`` ((q, n_cand)) replace the candidate and Thompson draws.
    Returns (carry, (q, d) proposals, in_search)."""
    _check_ported(cfg)
    dim = carry.x_buf.shape[-1]
    q = cfg.batch_size
    n_cand = cfg.n_candidates or S.n_candidates(dim)
    if carry.n < cfg.n_init:
        start = min(carry.n, carry.init_stream.shape[0] - q)
        return carry, carry.init_stream[start:start + q], False
    mask = L.row_mask(carry.x_buf.shape[0], carry.n, carry.x_buf.device)
    state = _fit_or_reuse(carry, mask, cfg, config)
    carry = carry._replace(raw=state.raw)
    if cands is None:
        best_idx = torch.argmin(torch.where(mask, carry.y_buf, torch.inf))
        ls = torch.broadcast_to(state.params["lengthscale"], (dim,))
        cands = S.tr_candidates(
            carry.x_buf.index_select(0, best_idx.reshape(1))[0], carry.tr.length, ls, n_cand, generator,
            cfg.local_frac, cfg.sobol_scramble,
        )
    xs, _ = A.thompson_select(state, cands, q, config, cfg.ts_chunk, generator, normals)
    return carry, xs, True


def turbo_absorb(
    carry: TurboCarry, x_new: Tensor, y_new: Tensor, in_search: bool, cfg: TurboConfig,
    fail_tol: int, generator: Optional[torch.Generator] = None,
) -> TurboCarry:
    """Fold a batch of evaluations into the TR: buffer writes, incumbent
    update, counter transition, and restart when the region collapses (the
    restart decision is read back to the host)."""
    n_loc = carry.x_buf.shape[0]
    mask_before = L.row_mask(n_loc, carry.n, carry.x_buf.device)
    local_best_before = torch.where(mask_before, carry.y_buf, torch.inf).min()

    k = min(x_new.shape[0], n_loc - carry.n)  # rows that still fit
    rows = torch.arange(carry.n, carry.n + k, device=carry.x_buf.device)
    carry = carry._replace(
        x_buf=carry.x_buf.index_copy(0, rows, x_new[:k]),
        y_buf=carry.y_buf.index_copy(0, rows, y_new[:k]),
        n=carry.n + k,
    )

    # every evaluated point counts for the global incumbent
    batch_best = y_new.min()
    better = batch_best < carry.best_y
    carry = carry._replace(
        best_y=torch.where(better, batch_best, carry.best_y),
        best_x=torch.where(better, x_new.index_select(0, torch.argmin(y_new).reshape(1))[0], carry.best_x),
    )

    thresh = local_best_before - cfg.tr.success_eps * torch.abs(local_best_before)
    improved = batch_best < thresh
    new_tr = tr_update(carry.tr, improved, in_search, cfg.tr, fail_tol)
    stag = torch.where(improved, 0, carry.tr.stag + 1) if in_search else carry.tr.stag
    carry = carry._replace(tr=new_tr._replace(stag=stag))

    needs_restart = carry.tr.length < cfg.tr.length_min
    if cfg.tr.stagnation_tol is not None:
        needs_restart = needs_restart | (carry.tr.stag >= cfg.tr.stagnation_tol)
    if bool(needs_restart):
        carry = _fresh_restart(carry, generator, _stream_len(cfg), cfg.tr)
    return carry


def run_turbo1(
    fn: Callable[[Tensor], Tensor],
    lb: Sequence[float],
    ub: Sequence[float],
    cfg: TurboConfig,
    config: GPConfig,
    generator: torch.Generator,
    dtype=torch.float32,
    n_loc: Optional[int] = None,
) -> Tuple[TurboCarry, Tensor]:
    """TuRBO-1 as a host loop of ``cfg.n_iters`` steps on the device of
    ``generator``. ``fn`` maps a (q, d) tensor in the box to a (q,) tensor.
    Returns (carry, incumbent trace (n_iters,))."""
    device = generator.device
    dim = len(lb)
    n_loc = n_loc or cfg.n_init + cfg.n_iters * cfg.batch_size
    lb_t = torch.tensor(lb, dtype=dtype, device=device)
    ub_t = torch.tensor(ub, dtype=dtype, device=device)
    fail_tol = cfg.tr.resolved_fail_tol(dim, cfg.batch_size)
    carry = make_turbo_carry(dim, n_loc, cfg, config, generator, dtype, device)
    trace: List[Tensor] = []
    for _ in range(cfg.n_iters):
        carry, xs, in_search = turbo_propose(carry, cfg, config, generator)
        ys = fn(T.from_unit_cube(xs, lb_t, ub_t)).to(dtype)
        ys = T.impute_failures(ys, carry.y_buf, L.row_mask(n_loc, carry.n, device))
        carry = turbo_absorb(carry, xs, ys, in_search, cfg, fail_tol, generator)
        trace.append(carry.best_y)
    return carry, torch.stack(trace) if trace else torch.empty(0, dtype=dtype, device=device)
