"""User API (port of ``turbojax.api``): the one-shot ``optimize`` for tensor
objectives, the host-side ask/tell ``Optimizer`` for black-box objectives,
and the constructor-style ``Turbo1`` and ``TurboM``.

``optimize`` keeps the JAX package's signature and adds ``ts_chunk``,
``device`` and ``generator``; its objective maps a (q, d) tensor in the
original box to a (q,) tensor. The ``Optimizer`` takes and returns numpy
arrays and keeps tensors on the device inside. Every entry point runs on the
GPU unless the caller asks for the CPU. Checkpointing (``checkpoint_*``,
``save``/``restore``) and meshes are not ported and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from turbojax_torch import bo as BO
from turbojax_torch import gp as G
from turbojax_torch import linalg as L
from turbojax_torch import sampling as S
from turbojax_torch import transforms as T
from turbojax_torch import trust_region as TR
from turbojax_torch import turbo_m as TM
from turbojax_torch.config import GPConfig, TRConfig

Tensor = torch.Tensor


@dataclasses.dataclass
class Result:
    best_x: np.ndarray
    best_y: float
    x_hist: np.ndarray  # (n, d) evaluated points, original box
    y_hist: np.ndarray  # (n,)
    incumbent_trace: np.ndarray  # best-so-far after each batch (each tell)


def _resolve_device(device, what: str) -> torch.device:
    """``device`` or, by default, the GPU; raises when that is not there."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the GPU unless told otherwise, and torch.cuda.is_available() is False; "
            'pass device="cpu" to run on the CPU'
        )
    return device


def bo_result(res: BO.BOResult) -> Result:
    """A ``run_bo`` result at the package boundary (numpy, active rows only)."""
    n = res.n
    return Result(
        best_x=res.best_x.cpu().numpy(), best_y=float(res.best_y),
        x_hist=res.x_buf[:n].cpu().numpy(), y_hist=res.y_buf[:n].cpu().numpy(),
        incumbent_trace=res.incumbent_trace.cpu().numpy(),
    )


def optimize(
    fn: Callable[[Tensor], Tensor],
    lb: Sequence[float],
    ub: Sequence[float],
    max_evals: int,
    method: str = "turbo1",
    n_init: Optional[int] = None,
    batch_size: Optional[int] = None,
    acq: str = "ei",
    m: int = 5,
    seed: int = 0,
    gp_config: GPConfig = GPConfig(),
    tr_config: TRConfig = TRConfig(),
    fit_every: int = 1,
    n_candidates: Optional[int] = None,
    host_loop: Optional[bool] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    mesh=None,
    budget_bytes: Optional[int] = None,
    ts_chunk: Optional[int] = None,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> Result:
    """One-shot optimization of a tensor objective with plain BO
    (``method="bo"``, acquisition ``acq`` ∈ {"ei", "lcb", "ts"}), TuRBO-1
    (``"turbo1"``) or TuRBO-m with ``m`` trust regions (``"turbom"``).

    Runs on ``generator.device`` when a generator is given, otherwise on
    ``device`` with a generator seeded from ``seed``. The default device is
    the GPU (``"cuda"``): without one this raises, and the CPU runs only
    when asked for with ``device="cpu"``.
    ``ts_chunk`` is the Thompson-sampling chunk of the candidate axis (None
    samples all candidates jointly, as the JAX package's ``optimize`` does).
    ``host_loop`` does not apply (the loops are host loops); it keeps the
    JAX package's signature."""
    if method not in ("bo", "turbo1", "turbom"):
        raise ValueError(f"unknown method {method!r}")
    if checkpoint_path or checkpoint_every or resume:
        raise NotImplementedError("checkpointing is not ported yet")
    if mesh is not None or budget_bytes is not None:
        raise NotImplementedError("mesh= and budget_bytes= are not ported yet")
    if generator is None:
        generator = torch.Generator(device=_resolve_device(device, "optimize")).manual_seed(seed)
    elif device is not None and torch.device(device) != generator.device:
        raise ValueError(f"device {device} differs from the generator's {generator.device}")

    lb_t, ub_t = tuple(float(v) for v in lb), tuple(float(v) for v in ub)
    dim = len(lb_t)
    n_init = n_init or min(2 * dim, max_evals // 3) or 1
    batch_size = batch_size or (1 if method == "bo" else 10)
    if method == "bo":
        cfg = BO.BOConfig(
            n_init=n_init, max_evals=max_evals, batch_size=batch_size, acq=acq, fit_every=fit_every,
            n_candidates=n_candidates or S.n_candidates(dim), ts_chunk=ts_chunk,
        )
        return bo_result(BO.run_bo(fn, lb_t, ub_t, cfg, gp_config, generator))
    cfg = TR.TurboConfig(
        n_init=n_init, max_evals=max_evals, batch_size=batch_size,
        n_candidates=n_candidates, fit_every=fit_every, ts_chunk=ts_chunk, tr=tr_config,
    )
    if method == "turbom":
        carries, trace = TM.run_turbom(fn, lb_t, ub_t, cfg, gp_config, m, generator)
        best_tr = int(torch.argmin(carries.best_y))
        carry = TR.carry_lane(carries, best_tr)
        lo = torch.tensor(lb_t, dtype=carry.x_buf.dtype, device=carry.x_buf.device)
        hi = torch.tensor(ub_t, dtype=carry.x_buf.dtype, device=carry.x_buf.device)
        xs = torch.cat([carries.x_buf[i, :n] for i, n in enumerate(carries.n)])
        ys = torch.cat([carries.y_buf[i, :n] for i, n in enumerate(carries.n)])
        return Result(
            best_x=T.from_unit_cube(carry.best_x, lo, hi).cpu().numpy(),
            best_y=float(carry.best_y),
            x_hist=T.from_unit_cube(xs, lo, hi).cpu().numpy(),
            y_hist=ys.cpu().numpy(),
            incumbent_trace=trace.cpu().numpy(),
        )
    carry, trace = TR.run_turbo1(fn, lb_t, ub_t, cfg, gp_config, generator)
    lo = torch.tensor(lb_t, dtype=carry.x_buf.dtype, device=carry.x_buf.device)
    hi = torch.tensor(ub_t, dtype=carry.x_buf.dtype, device=carry.x_buf.device)
    n = carry.n
    return Result(
        best_x=T.from_unit_cube(carry.best_x, lo, hi).cpu().numpy(),
        best_y=float(carry.best_y),
        x_hist=T.from_unit_cube(carry.x_buf[:n], lo, hi).cpu().numpy(),
        y_hist=carry.y_buf[:n].cpu().numpy(),
        incumbent_trace=trace.cpu().numpy(),
    )


class Optimizer:
    """Host-side ask/tell optimizer for black-box objectives: the caller
    evaluates the objective on numpy arrays; all surrogate math runs on the
    device, through the same functions the one-shot loops use.

    Example:
        opt = Optimizer(lb, ub, method="turbo1", batch_size=10)
        for _ in range(50):
            xs = opt.ask()
            opt.tell(xs, my_expensive_function(xs))
        print(opt.best)
    """

    def __init__(
        self,
        lb: Sequence[float],
        ub: Sequence[float],
        method: str = "turbo1",
        n_init: int = 20,
        max_evals: int = 500,
        batch_size: int = 10,
        acq: str = "ts",
        seed: int = 0,
        gp_config: GPConfig = GPConfig(),
        tr_config: TRConfig = TRConfig(),
        fit_every: int = 1,
        n_candidates: Optional[int] = None,
        max_cholesky_size: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        m: int = 5,
        device=None,
    ):
        """``max_cholesky_size`` mirrors the reference knob: it is the
        Thompson-sampling chunk of the candidate axis here.

        ``method="turbom"`` runs ``m`` trust regions with a global Thompson
        allocation; its ``tell`` must follow the matching ``ask`` (the
        allocation maps each point to its region).

        The buffers are allocated once at the size ``max_evals`` needs (no
        growth); TuRBO-m fits on views sized to the active counts, as
        ``turbo_m.run_turbom`` does.

        ``device=None`` is the GPU; without one this raises, and the CPU
        runs only when asked for with ``device="cpu"``."""
        if method not in ("bo", "turbo1", "turbom"):
            raise ValueError("ask/tell supports methods 'bo', 'turbo1' and 'turbom'")
        if checkpoint_path or checkpoint_every:
            raise NotImplementedError("checkpointing is not ported yet")
        self.device = _resolve_device(device, "Optimizer")
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._dtype = torch.float32
        self.lb = np.asarray(lb, np.float32)
        self.ub = np.asarray(ub, np.float32)
        self._lb_t = torch.tensor(self.lb, device=self.device)
        self._ub_t = torch.tensor(self.ub, device=self.device)
        self.dim = len(self.lb)
        self.method = method
        self.gp_config = gp_config
        self._history_x: List[np.ndarray] = []
        self._history_y: List[np.ndarray] = []
        self._trace: List[float] = []
        self._pending = None
        self._n_tells = 0

        if method == "bo":
            self.cfg = BO.BOConfig(
                n_init=n_init, max_evals=max_evals, batch_size=batch_size, acq=acq, fit_every=fit_every,
                n_candidates=n_candidates or S.n_candidates(self.dim), ts_chunk=max_cholesky_size,
            )
            self._carry = None  # built once n_init points are told
            self._init_x = S.latin_hypercube(n_init, self.dim, self._generator, self._dtype, self.device)
            self._n_told = 0
            return
        self.cfg = TR.TurboConfig(
            n_init=n_init, max_evals=max_evals, batch_size=batch_size, n_candidates=n_candidates,
            fit_every=fit_every, tr=tr_config, ts_chunk=max_cholesky_size,
        )
        self._n_loc_final = TM.final_capacity(self.cfg)
        self._fail_tol = tr_config.resolved_fail_tol(self.dim, batch_size)

        def fresh():
            return TR.make_turbo_carry(self.dim, self._n_loc_final, self.cfg, gp_config, self._generator,
                                       self._dtype, self.device)

        if method == "turbo1":
            self._carry = fresh()
        else:
            self.m = m
            self._carry = TR.stack_carries([fresh() for _ in range(m)])

    def _to_box(self, x_unit: Tensor) -> np.ndarray:
        return T.from_unit_cube(x_unit, self._lb_t, self._ub_t).cpu().numpy()

    # -- ask/tell protocol --------------------------------------------------

    def ask(self) -> np.ndarray:
        """Propose the next batch of points (original box)."""
        q = self.cfg.batch_size
        if self.method == "turbo1":
            self._carry, xs, in_search = TR.turbo_propose(self._carry, self.cfg, self.gp_config, self._generator)
            self._pending = (xs, in_search)
            return self._to_box(xs)
        if self.method == "turbom":
            cap, cap_b = TM.fit_capacities(self._carry.n, self.cfg)
            self._carry, x_sel, tr_idx, _ = TM.turbom_propose_batch(
                self._carry, self.cfg, self.gp_config, self._generator, cap, cap_b)
            self._pending = (x_sel, tr_idx)
            return self._to_box(x_sel)
        if self._carry is None:
            xs = self._init_x[self._n_told:self._n_told + q]
            if xs.shape[0] < q:  # the init design ended mid-batch: pad from a fresh LHS
                extra = S.latin_hypercube(q - xs.shape[0], self.dim, self._generator, self._dtype, self.device)
                xs = torch.cat([xs, extra], dim=0)
            self._pending = (xs, False)
            return self._to_box(xs)
        if self.cfg.fit_every > 0 and len(self._trace) % self.cfg.fit_every == 0:
            self._carry = BO._refit_carry(self._carry, self.gp_config, self._generator)
        xs = BO._suggest(self._carry, self.gp_config, self.cfg, self._generator)
        self._pending = (xs, True)
        return self._to_box(xs)

    def tell(self, x: np.ndarray, y: np.ndarray) -> None:
        """Report evaluations for the last ``ask`` (or arbitrary points)."""
        x = np.atleast_2d(np.asarray(x, np.float32))
        y = np.atleast_1d(np.asarray(y, np.float32))
        # NaN/inf objective values are imputed with a penalty. Its reference is
        # the worst over the full history and this batch, with
        # transforms.impute_failures's floor for an empty scope: an all-failed
        # early batch must never produce a penalty that ranks as the best.
        if not np.isfinite(y).all():
            if self._history_y:
                hist = np.concatenate(self._history_y)
                hist_mask = np.isfinite(hist)
            else:
                hist, hist_mask = np.zeros((1,), np.float32), np.zeros((1,), bool)  # a masked-out dummy row
            y = T.impute_failures(torch.as_tensor(y), torch.as_tensor(hist), torch.as_tensor(hist_mask)).numpy()
        x_unit = T.to_unit_cube(torch.as_tensor(x, device=self.device), self._lb_t, self._ub_t)
        y_t = torch.as_tensor(y, device=self.device)
        # capacity guard: a write past the buffers must not happen silently
        if self.method == "bo":
            n_now, cap = (self._carry.n, self._carry.x_buf.shape[0]) if self._carry is not None else (0, None)
        else:
            n_now, cap = (self._carry.n if self.method == "turbo1" else max(self._carry.n)), self._n_loc_final
        if cap is not None and n_now + x.shape[0] > cap:
            raise ValueError(
                f"tell() exceeds max_evals capacity ({cap}); construct the Optimizer with a larger max_evals"
            )
        if self.method == "turbom":
            # validated before the host history is touched: the global Thompson
            # allocation maps each point to a region, so tells must match asks
            if self._pending is None:
                raise ValueError(
                    "turbom tell() must follow its matching ask(): the global Thompson allocation maps "
                    "each point to a trust region"
                )
            if x.shape != tuple(self._pending[0].shape) or not np.allclose(x, self._to_box(self._pending[0]), atol=1e-5):
                raise ValueError("turbom tell() points must be the ones ask() proposed")
        self._history_x.append(x)
        self._history_y.append(y)

        if self.method == "turbo1":
            in_search = self._pending[1] if self._pending is not None else True
            self._carry = TR.turbo_absorb(self._carry, x_unit, y_t, in_search, self.cfg, self._fail_tol,
                                          self._generator)
        elif self.method == "turbom":
            x_pend, tr_idx = self._pending
            self._carry, _ = TM.turbom_absorb_batch(self._carry, x_pend, y_t, tr_idx, self.cfg, self._fail_tol,
                                                    self._generator)
        else:
            self._n_told += x.shape[0]
            if self._carry is None:
                if self._n_told >= self.cfg.n_init:
                    self._carry = self._build_bo_carry()
            else:
                self._carry = BO._append_batch(self._carry, x_unit, y_t, self.gp_config,
                                               self.cfg.resolved_chol_mode(self.device))
        self._trace.append(self.best[1])
        self._pending = None
        self._n_tells += 1

    def save(self, path: str) -> None:
        raise NotImplementedError("checkpointing is not ported yet")

    def restore(self, path: str) -> "Optimizer":
        raise NotImplementedError("checkpointing is not ported yet")

    def _build_bo_carry(self) -> BO.BOCarry:
        xs = np.concatenate(self._history_x)
        ys = np.concatenate(self._history_y)
        n = len(ys)
        n_max = max(self.cfg.n_init + self.cfg.n_iters * self.cfg.batch_size, n)
        x_buf = torch.zeros((n_max, self.dim), dtype=self._dtype, device=self.device)
        y_buf = torch.zeros((n_max,), dtype=self._dtype, device=self.device)
        x_buf[:n] = T.to_unit_cube(torch.as_tensor(xs, device=self.device), self._lb_t, self._ub_t)
        y_buf[:n] = torch.as_tensor(ys, device=self.device)
        state = G.fit_gp(x_buf, y_buf, L.row_mask(n_max, n, self.device), self.gp_config,
                         generator=self._generator)
        return BO.BOCarry(x_buf=x_buf, y_buf=y_buf, n=n, chol=state.chol, raw=state.raw,
                          y_mean=state.y_mean, y_std=state.y_std)

    # -- results -------------------------------------------------------------

    @property
    def best(self) -> Tuple[np.ndarray, float]:
        if not self._history_y:
            return np.full(self.dim, np.nan), float("inf")
        ys = np.concatenate(self._history_y)
        xs = np.concatenate(self._history_x)
        i = int(np.argmin(ys))
        return xs[i], float(ys[i])

    def optimize(self, f: Callable[[np.ndarray], np.ndarray], max_evals: Optional[int] = None) -> Result:
        """Convenience loop: ask → f → tell until the budget is spent."""
        budget = max_evals or self.cfg.max_evals
        n = 0
        while n < budget:
            xs = self.ask()
            ys = np.asarray(f(xs)).reshape(-1)
            self.tell(xs, ys)
            n += xs.shape[0]
        bx, by = self.best
        return Result(
            best_x=bx, best_y=by,
            x_hist=np.concatenate(self._history_x),
            y_hist=np.concatenate(self._history_y),
            incumbent_trace=np.asarray(self._trace),
        )


class Turbo1:
    """Constructor-style API:
    ``Turbo1(f, lb, ub, n_init, max_evals, batch_size).optimize()``, then read
    ``.X``, ``.fX``, ``best_x``, ``best_y``. ``f`` is any host-side callable
    taking (q, d) numpy arrays in the original box; the surrogate math runs
    on the device through the ask/tell ``Optimizer``."""

    def __init__(
        self,
        f: Callable[[np.ndarray], np.ndarray],
        lb: Sequence[float],
        ub: Sequence[float],
        n_init: int = 20,
        max_evals: int = 200,
        batch_size: int = 10,
        verbose: bool = False,
        seed: int = 0,
        use_ard: bool = True,
        max_cholesky_size: Optional[int] = None,
        gp_config: Optional[GPConfig] = None,
        tr_config: TRConfig = TRConfig(),
        device=None,
    ):
        self.f = f
        self.verbose = verbose
        self._opt = Optimizer(
            lb, ub, method="turbo1", n_init=n_init, max_evals=max_evals, batch_size=batch_size, seed=seed,
            gp_config=gp_config or GPConfig(use_ard=use_ard), tr_config=tr_config,
            max_cholesky_size=max_cholesky_size, device=device,
        )
        self.X = np.zeros((0, len(lb)))
        self.fX = np.zeros((0,))

    def optimize(self) -> "Turbo1":
        n = 0
        while n < self._opt.cfg.max_evals:
            xs = self._opt.ask()
            ys = np.asarray(self.f(xs)).reshape(-1)
            self._opt.tell(xs, ys)
            n += xs.shape[0]
            if self.verbose:
                print(f"[{n:4d}] best = {self._opt.best[1]:.6f}")
        self.X = np.concatenate(self._opt._history_x)
        self.fX = np.concatenate(self._opt._history_y)
        return self

    @property
    def best_x(self) -> np.ndarray:
        return self._opt.best[0]

    @property
    def best_y(self) -> float:
        return self._opt.best[1]


class TurboM:
    """Constructor-style TuRBO-m: runs the one-shot multi-trust-region loop,
    so ``f`` maps a (q, d) tensor to a (q,) tensor (use the ``Optimizer``'s
    ask/tell for black boxes)."""

    def __init__(
        self,
        f,
        lb: Sequence[float],
        ub: Sequence[float],
        n_init: int = 20,
        max_evals: int = 200,
        batch_size: int = 10,
        n_trust_regions: int = 5,
        seed: int = 0,
        gp_config: GPConfig = GPConfig(),
        tr_config: TRConfig = TRConfig(),
        device=None,
    ):
        self._kwargs = dict(
            fn=f, lb=lb, ub=ub, max_evals=max_evals, method="turbom", n_init=n_init, batch_size=batch_size,
            m=n_trust_regions, seed=seed, gp_config=gp_config, tr_config=tr_config, device=device,
        )
        self.X = np.zeros((0, len(lb)))
        self.fX = np.zeros((0,))

    def optimize(self) -> "TurboM":
        res = optimize(**self._kwargs)
        self.X, self.fX = res.x_hist, res.y_hist
        self.best_x, self.best_y = res.best_x, res.best_y
        self.result = res
        return self
