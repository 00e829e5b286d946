"""Carry state across from the JAX package and back.

The ``*_from_numpy`` functions take the JAX package's values as NamedTuples
whose leaves are numpy arrays (callers apply ``np.asarray`` on the JAX
side; this module imports no JAX) and return the port's NamedTuples of
tensors on a given device, floating leaves cast to ``dtype``. The
``*_to_numpy`` inverses return the port's NamedTuples with numpy leaves.
Fields the port does not carry (the JAX ``TurboCarry.key``) are dropped.
TuRBO-m carries (a leading TR axis on every leaf) convert with the same
functions; their ``n`` becomes a tuple of host ints, and back an array.
"""

from __future__ import annotations

import numpy as np
import torch

from turbojax_torch.gp import GPParams, GPState
from turbojax_torch.trust_region import TRState, TurboCarry


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)  # a copy below: arrays viewed from JAX are read-only
    if np.issubdtype(a.dtype, np.floating):
        return torch.tensor(a, dtype=dtype, device=device)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    return torch.tensor(a.astype(np.int64), device=device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def gp_params_from_numpy(p, device=None, dtype=torch.float64) -> GPParams:
    return GPParams(**{f: _tensor(getattr(p, f), device, dtype) for f in GPParams._fields})


def gp_params_to_numpy(p: GPParams) -> GPParams:
    return GPParams(*(_numpy(a) for a in p))


def gp_state_from_numpy(s, device=None, dtype=torch.float64) -> GPState:
    return GPState(
        x_buf=_tensor(s.x_buf, device, dtype),
        mask=_tensor(s.mask, device, dtype),
        params={k: _tensor(v, device, dtype) for k, v in s.params.items()},
        raw=gp_params_from_numpy(s.raw, device, dtype),
        chol=_tensor(s.chol, device, dtype),
        alpha=_tensor(s.alpha, device, dtype),
        y_mean=_tensor(s.y_mean, device, dtype),
        y_std=_tensor(s.y_std, device, dtype),
    )


def gp_state_to_numpy(s: GPState) -> GPState:
    return GPState(
        x_buf=_numpy(s.x_buf), mask=_numpy(s.mask),
        params={k: _numpy(v) for k, v in s.params.items()},
        raw=gp_params_to_numpy(s.raw), chol=_numpy(s.chol), alpha=_numpy(s.alpha),
        y_mean=_numpy(s.y_mean), y_std=_numpy(s.y_std),
    )


def tr_state_from_numpy(t, device=None, dtype=torch.float64) -> TRState:
    return TRState(**{f: _tensor(getattr(t, f), device, dtype) for f in TRState._fields})


def turbo_carry_from_numpy(c, device=None, dtype=torch.float64) -> TurboCarry:
    return TurboCarry(
        x_buf=_tensor(c.x_buf, device, dtype),
        y_buf=_tensor(c.y_buf, device, dtype),
        n=int(np.asarray(c.n)) if np.ndim(c.n) == 0 else tuple(int(v) for v in np.asarray(c.n)),
        raw=gp_params_from_numpy(c.raw, device, dtype),
        tr=tr_state_from_numpy(c.tr, device, dtype),
        init_stream=_tensor(c.init_stream, device, dtype),
        best_x=_tensor(c.best_x, device, dtype),
        best_y=_tensor(c.best_y, device, dtype),
    )


def turbo_carry_to_numpy(c: TurboCarry) -> TurboCarry:
    return TurboCarry(
        x_buf=_numpy(c.x_buf), y_buf=_numpy(c.y_buf), n=c.n if isinstance(c.n, int) else np.asarray(c.n),
        raw=gp_params_to_numpy(c.raw),
        tr=TRState(*(_numpy(a) for a in c.tr)),
        init_stream=_numpy(c.init_stream), best_x=_numpy(c.best_x), best_y=_numpy(c.best_y),
    )
