"""User API (port of ``turbojax.api``, ``optimize`` with
``method="turbo1"`` and ``"turbom"``).

``optimize`` keeps the JAX package's signature and adds ``ts_chunk``,
``device`` and ``generator``. The objective maps a (q, d) tensor in the
original box to a (q,) tensor. The ask/tell ``Optimizer``, ``method="bo"``,
checkpointing and meshes are later work and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

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
    incumbent_trace: np.ndarray  # best-so-far after each batch


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
    """One-shot optimization of a tensor objective with TuRBO-1
    (``method="turbo1"``) or TuRBO-m with ``m`` trust regions
    (``method="turbom"``).

    Runs on ``generator.device`` when a generator is given, otherwise on
    ``device`` (default CPU) with a generator seeded from ``seed``.
    ``ts_chunk`` is the Thompson-sampling chunk of the candidate axis
    (``TurboConfig.ts_chunk``; None samples all candidates jointly, as the
    JAX package's ``optimize`` does). ``acq`` and ``host_loop`` do not
    apply (the loops are host loops); they keep the JAX package's
    signature."""
    if method not in ("turbo1", "turbom"):
        raise NotImplementedError(f"method={method!r} is not ported yet; only 'turbo1' and 'turbom' are")
    if checkpoint_path or checkpoint_every or resume:
        raise NotImplementedError("checkpointing is not ported yet")
    if mesh is not None or budget_bytes is not None:
        raise NotImplementedError("mesh= and budget_bytes= are not ported yet")
    if generator is None:
        generator = torch.Generator(device=torch.device(device or "cpu")).manual_seed(seed)
    elif device is not None and torch.device(device) != generator.device:
        raise ValueError(f"device {device} differs from the generator's {generator.device}")

    lb_t, ub_t = tuple(float(v) for v in lb), tuple(float(v) for v in ub)
    dim = len(lb_t)
    n_init = n_init or min(2 * dim, max_evals // 3) or 1
    cfg = TR.TurboConfig(
        n_init=n_init, max_evals=max_evals, batch_size=batch_size or 10,
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
