"""Plain Bayesian-optimization loop (port of ``turbojax.bo``): init design,
fit the GP, maximize the acquisition over a fresh global candidate set,
evaluate, append, repeat.

The Cholesky factor is carried in the loop state and extended by O(n²)
``linalg.chol_append`` rows (``chol_mode="incremental"``) or rebuilt by one
masked refactorization (``"refactor"``); hyperparameter refits happen at the
cadence ``fit_every``. The y-standardization constants are frozen at fit
time and carried, so the cached factor stays consistent between refits.

The JAX package runs the loop as one ``lax.scan`` or as a host loop over a
jitted step; here it is a host loop over device tensors, and the active
count ``n`` is a host int. Every random draw comes from an explicit
``torch.Generator`` or is handed in (the init design, the candidates, the
Thompson normals, the restart uniforms). The RFF and pathwise Thompson
samplers, ``ts_dtype`` and checkpointing are not ported and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from turbojax_torch import acq as A
from turbojax_torch import gp as G
from turbojax_torch import kernels as K
from turbojax_torch import linalg as L
from turbojax_torch import sampling as S
from turbojax_torch import transforms as T
from turbojax_torch.config import GPConfig

Tensor = torch.Tensor

# On a CUDA device ``chol_mode="auto"`` appends while the batch is at most this
# many points, else refactorizes (see ``BOConfig.resolved_chol_mode``).
_AUTO_APPEND_MAX_Q = 1


@dataclasses.dataclass(frozen=True)
class BOConfig:
    """Loop knobs (same fields and defaults as the JAX package's):
    ``n_init``, ``max_evals``, ``batch_size``, and the acquisition,
    candidate-set and refit-cadence settings."""

    n_init: int = 10
    max_evals: int = 60
    batch_size: int = 1
    acq: str = "ei"  # "ei" | "lcb" | "ts"
    n_candidates: int = 2000
    fit_every: int = 1  # 0 = never refit (fixed hypers, the pure incremental path)
    kappa: float = 2.0
    xi: float = 0.0
    local_frac: float = 0.0  # fraction of the candidates drawn around the incumbent (Gaussian, ``local_sigma``)
    local_sigma: float = 0.05
    sobol_scramble: str = "shift"  # "shift" | "lms"
    ts_chunk: Optional[int] = None
    ts_sampler: str = "exact"  # only "exact" is ported
    ts_dtype: Optional[str] = None  # only None is ported
    rff_features: int = 1024
    cand_shard_min: Optional[int] = None  # the distributed loop's; unused here
    chol_mode: str = "auto"  # "incremental" | "refactor" | "auto"

    @property
    def n_iters(self) -> int:
        return max(0, (self.max_evals - self.n_init + self.batch_size - 1) // self.batch_size)

    def resolved_chol_mode(self, device) -> str:
        """``"auto"`` follows a measurement on an H100 (``python3 -m
        turbojax_torch.kernel_bench --chol``; PERF.md has the table). Both
        modes are host-bound there: one append (a kernel-matrix row and a
        single-vector triangular solve) takes 0.5-0.65 ms at 64, 512 and
        2048 points alike and each further row of a batch ~0.2-0.3 ms more,
        while one refactorization takes 0.5-0.9 ms up to 512 points and 1.0
        ms at 2048. So a single point is appended (a tie at small sizes, 2×
        faster at 2048), and a batch is refactorized (faster from q = 2 up
        to 512 points and from q = 8 at 2048; at 2048 points with q = 2-4
        the two are within 0.4 ms of each other, either way from call to
        call). On the CPU the O(n²) append wins at any batch size."""
        if self.chol_mode != "auto":
            return self.chol_mode
        if torch.device(device).type == "cuda" and self.batch_size > _AUTO_APPEND_MAX_Q:
            return "refactor"
        return "incremental"


class BOCarry(NamedTuple):
    """Loop state: masked history buffers and the cached factorization."""

    x_buf: Tensor  # (N_max, d), unit cube, zero-padded
    y_buf: Tensor  # (N_max,), original units, zero-padded
    n: int  # active count
    chol: Tensor  # (N_max, N_max) identity-padded factor of K+σ²I (standardized space)
    raw: G.GPParams  # current hypers (the warm start of the next refit)
    y_mean: Tensor  # standardization constants, frozen at fit time
    y_std: Tensor


class BOResult(NamedTuple):
    x_buf: Tensor  # (N_max, d) in the original box
    y_buf: Tensor  # (N_max,)
    n: int
    best_x: Tensor
    best_y: Tensor
    incumbent_trace: Tensor  # (n_iters,) best y after each iteration


def _check_ported(bo: BOConfig) -> None:
    if bo.ts_sampler != "exact":
        raise NotImplementedError(f"ts_sampler={bo.ts_sampler!r} is not ported yet; only 'exact' is")
    if bo.ts_dtype is not None:
        raise NotImplementedError(f"ts_dtype={bo.ts_dtype!r} is not ported yet; only None is")


def _mask(carry: BOCarry) -> Tensor:
    return L.row_mask(carry.x_buf.shape[0], carry.n, carry.x_buf.device)


def _state_from_carry(carry: BOCarry, config: GPConfig) -> G.GPState:
    """Rebuild the posterior cache from the carried buffers without
    refactorizing: α is an O(n²) ``cho_solve`` against the carried factor."""
    mask = _mask(carry)
    params = G.constrain_params(carry.raw, config)
    zero = torch.zeros_like(carry.y_buf)
    y_std_buf = torch.where(mask, (T.warp_y(carry.y_buf, config.y_warp) - carry.y_mean) / carry.y_std, zero)
    resid = torch.where(mask, y_std_buf - params["mean"], zero)
    alpha = L.cho_solve(carry.chol, resid)
    return G.GPState(
        x_buf=carry.x_buf, mask=mask, params=params, raw=carry.raw,
        chol=carry.chol, alpha=alpha, y_mean=carry.y_mean, y_std=carry.y_std,
    )


def _refit_carry(
    carry: BOCarry, config: GPConfig, generator: Optional[torch.Generator] = None,
    restart_uniforms: Optional[Tensor] = None,
) -> BOCarry:
    state = G.fit_gp(carry.x_buf, carry.y_buf, _mask(carry), config, warm_start=carry.raw,
                     generator=generator, restart_uniforms=restart_uniforms)
    return carry._replace(chol=state.chol, raw=state.raw, y_mean=state.y_mean, y_std=state.y_std)


def _append_batch(
    carry: BOCarry, x_new: Tensor, y_new: Tensor, config: GPConfig, chol_mode: str = "incremental"
) -> BOCarry:
    """Write a q-batch into the buffers and refresh the carried factor:
    q ``chol_append`` rows (``"incremental"``) or one masked
    refactorization (``"refactor"``). The carry handed in stays valid."""
    q = x_new.shape[0]
    n = carry.n
    if n + q > carry.x_buf.shape[0]:
        raise ValueError(f"appending {q} points to {n} exceeds the buffer's capacity {carry.x_buf.shape[0]}")
    params = G.constrain_params(carry.raw, config)
    x_buf, y_buf = carry.x_buf.clone(), carry.y_buf.clone()
    x_buf[n:n + q] = x_new
    y_buf[n:n + q] = y_new
    if chol_mode == "refactor":
        chol = G._masked_kernel_chol(params, x_buf, L.row_mask(x_buf.shape[0], n + q, x_buf.device), config)
    elif chol_mode == "incremental":
        # each new point against the buffer after the write, so that the j-th
        # append sees the points appended before it in its active prefix
        k_block = G._kernel_matrix(params, x_new, x_buf, config, add_noise=False)  # (q, N_max)
        k_diag = K.kernel_diag(params, x_new) + params["noise"]
        chol = L.chol_append_batch(carry.chol, n, k_block, k_diag, q)
    else:
        raise ValueError(f"unknown chol_mode {chol_mode!r}; expected 'incremental' or 'refactor'")
    return carry._replace(x_buf=x_buf, y_buf=y_buf, n=n + q, chol=chol)


def lowest_k(scores: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` lowest scores, the lowest index first among
    equals (as ``lax.top_k`` of the negated scores orders them), on every
    device: a stable sort, where ``torch.topk`` promises no order of ties."""
    return torch.sort(scores, stable=True).indices[:k]


def _suggest(
    carry: BOCarry, config: GPConfig, bo: BOConfig, generator: Optional[torch.Generator] = None,
    cands: Optional[Tensor] = None, normals: Optional[Tensor] = None,
) -> Tensor:
    """One acquisition maximization over a fresh global candidate set;
    returns (q, d) unit-cube points. ``cands`` ((n_candidates, d)) replaces
    the candidate draws (Sobol, and the local pool) and ``normals``
    ((q, n_candidates)) the Thompson normals."""
    _check_ported(bo)
    dim = carry.x_buf.shape[-1]
    dtype, device = carry.x_buf.dtype, carry.x_buf.device
    mask = _mask(carry)
    if cands is None:
        n_local = int(bo.local_frac * bo.n_candidates)
        cands = S.sobol_sample(dim, bo.n_candidates - n_local, generator, dtype, device, bo.sobol_scramble)
        if n_local:
            inc = carry.x_buf.index_select(0, torch.argmin(torch.where(mask, carry.y_buf, torch.inf)).reshape(1))
            local = inc + bo.local_sigma * torch.randn((n_local, dim), generator=generator, dtype=dtype, device=device)
            cands = torch.cat([cands, torch.clamp(local, 0.0, 1.0)], dim=0)
    state = _state_from_carry(carry, config)
    if bo.acq == "ts":
        xs, _ = A.thompson_select(state, cands, bo.batch_size, config, bo.ts_chunk, generator, normals)
        return xs
    mu, var = G.gp_posterior(state, cands, config)
    if bo.acq == "ei":
        # the incumbent lives in the same (possibly warped) space as the
        # posterior: warp_y is monotone, so min commutes with it
        best = T.warp_y(torch.where(mask, carry.y_buf, torch.inf).min(), config.y_warp)
        scores = -A.expected_improvement(mu, var, best, bo.xi)  # minimize −EI
    elif bo.acq == "lcb":
        scores = A.lower_confidence_bound(mu, var, bo.kappa)
    else:
        raise ValueError(f"unknown acquisition {bo.acq!r}")
    return cands[lowest_k(scores, bo.batch_size)]


def _bo_init(
    fn, lb_t: Tensor, ub_t: Tensor, bo: BOConfig, config: GPConfig, n_max: int,
    fixed_params: Optional[G.GPParams], generator: Optional[torch.Generator] = None,
    x0: Optional[Tensor] = None, restart_uniforms: Optional[Tensor] = None,
) -> BOCarry:
    """Init design (a Latin hypercube, or ``x0`` in the unit cube) and the
    first fit or factorization, on the device and in the dtype of ``lb_t``."""
    dim = lb_t.shape[0]
    dtype, device = lb_t.dtype, lb_t.device
    if x0 is None:
        x0 = S.latin_hypercube(bo.n_init, dim, generator, dtype, device)
    x0 = x0.to(dtype=dtype, device=device)
    y0 = fn(T.from_unit_cube(x0, lb_t, ub_t)).to(dtype)
    # a masked-out dummy row: with no history the penalty falls to the floor
    y0 = T.impute_failures(y0, torch.zeros(1, dtype=dtype, device=device),
                           torch.zeros(1, dtype=torch.bool, device=device))
    x_buf = torch.zeros((n_max, dim), dtype=dtype, device=device)
    y_buf = torch.zeros((n_max,), dtype=dtype, device=device)
    x_buf[:bo.n_init] = x0
    y_buf[:bo.n_init] = y0
    mask = L.row_mask(n_max, bo.n_init, device)
    if bo.fit_every == 0:
        raw0 = fixed_params if fixed_params is not None else G.default_params(dim, config, dtype, device)
        state0 = G.make_gp_state(x_buf, y_buf, mask, raw0, config)
    else:
        state0 = G.fit_gp(x_buf, y_buf, mask, config, warm_start=fixed_params, generator=generator,
                          restart_uniforms=restart_uniforms)
    return BOCarry(x_buf=x_buf, y_buf=y_buf, n=bo.n_init, chol=state0.chol, raw=state0.raw,
                   y_mean=state0.y_mean, y_std=state0.y_std)


def _bo_step(
    carry: BOCarry, it: int, fn, lb_t: Tensor, ub_t: Tensor, bo: BOConfig, config: GPConfig,
    generator: Optional[torch.Generator] = None, cands: Optional[Tensor] = None,
    normals: Optional[Tensor] = None, restart_uniforms: Optional[Tensor] = None,
) -> Tuple[BOCarry, Tensor]:
    """One iteration: refit at the cadence, suggest, evaluate, impute
    failures against the history, append. Returns (carry, best y so far)."""
    if bo.fit_every > 0 and it % bo.fit_every == 0:
        carry = _refit_carry(carry, config, generator, restart_uniforms)
    x_unit = _suggest(carry, config, bo, generator, cands, normals)
    y_new = fn(T.from_unit_cube(x_unit, lb_t, ub_t)).to(x_unit.dtype)
    y_new = T.impute_failures(y_new, carry.y_buf, _mask(carry))
    carry = _append_batch(carry, x_unit, y_new, config, bo.resolved_chol_mode(x_unit.device))
    return carry, torch.where(_mask(carry), carry.y_buf, torch.inf).min()


def _bo_result(carry: BOCarry, lb_t: Tensor, ub_t: Tensor, trace: Tensor) -> BOResult:
    best_idx = torch.argmin(torch.where(_mask(carry), carry.y_buf, torch.inf)).reshape(1)
    return BOResult(
        x_buf=T.from_unit_cube(carry.x_buf, lb_t, ub_t),
        y_buf=carry.y_buf,
        n=carry.n,
        best_x=T.from_unit_cube(carry.x_buf.index_select(0, best_idx)[0], lb_t, ub_t),
        best_y=carry.y_buf.index_select(0, best_idx)[0],
        incumbent_trace=trace,
    )


def run_bo(
    fn: Callable[[Tensor], Tensor],
    lb: Sequence[float],
    ub: Sequence[float],
    bo: BOConfig,
    config: GPConfig,
    generator: torch.Generator,
    n_max: Optional[int] = None,
    fixed_params: Optional[G.GPParams] = None,
    host_loop: Optional[bool] = None,
    on_iteration: Optional[Callable[[int, Tensor], None]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    dtype=torch.float32,
) -> BOResult:
    """The BO loop as a host loop of ``bo.n_iters`` steps on the device of
    ``generator``. ``fn`` maps a (q, d) tensor in the box to a (q,) tensor.
    ``fixed_params`` with ``bo.fit_every == 0`` pins the hypers (the
    fixed-hyperparameter GP of config 1); otherwise it warm-starts the first
    fit. ``on_iteration(iteration, best)`` is called after each step with the
    incumbent as a device tensor (reading it is the caller's sync).
    ``host_loop`` keeps the JAX package's signature and changes nothing."""
    if checkpoint_path or checkpoint_every or resume:
        raise NotImplementedError("checkpointing is not ported yet")
    _check_ported(bo)
    device = generator.device
    lb_t = torch.tensor(tuple(lb), dtype=dtype, device=device)
    ub_t = torch.tensor(tuple(ub), dtype=dtype, device=device)
    n_max = n_max or bo.n_init + bo.n_iters * bo.batch_size
    carry = _bo_init(fn, lb_t, ub_t, bo, config, n_max, fixed_params, generator)
    trace: List[Tensor] = []
    for it in range(bo.n_iters):
        carry, best = _bo_step(carry, it, fn, lb_t, ub_t, bo, config, generator)
        trace.append(best)
        if on_iteration is not None:
            on_iteration(it, best)
    trace_t = torch.stack(trace) if trace else torch.empty(0, dtype=dtype, device=device)
    return _bo_result(carry, lb_t, ub_t, trace_t)
