"""Auto-routing of the exact GP between the dense single-device path and the
row-sharded distributed path (port of the routing surface of
``turbojax.distributed_linalg``).

Only the dense route is ported. ``should_distribute`` is False without a
mesh, as the JAX package's is on one device, so ``fit_gp_auto`` and
``refactor_gp_auto`` run ``gp.fit_gp`` and ``gp.make_gp_state`` over an
all-true row mask and wrap the state in ``_DenseGPAdapter``: the surface
(``.posterior``, ``.mll``, ``.raw``, ``.state``) that the distributed GP
shares with it. A mesh raises ``NotImplementedError``: the panel-blocked
Cholesky, ``DistributedGP`` and ``distributed_pathwise_paths`` come with the
multi-device port (ROADMAP.md §1, item 3).

Both routes model ``warp_y(y)``: ``.mll()`` scores the warped, standardized
targets, as the fit does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from turbojax_torch import gp as G
from turbojax_torch import linalg as L
from turbojax_torch import transforms as T
from turbojax_torch.config import GPConfig

Tensor = torch.Tensor

#: Per-device bytes the dense path may spend on (K, its factor, the autograd
#: residuals) before auto-routing distributes. The JAX package's value, sized
#: for a 16 GiB TPU chip. It matters only across devices (one device always
#: takes the dense route), so it is re-measured with the multi-device port.
DENSE_BUDGET_BYTES = 2 << 30


def _require_single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: the distributed GP (panel-blocked Cholesky, DistributedGP, "
            "distributed_pathwise_paths) comes with the multi-device port (ROADMAP.md §1, item 3); "
            "pass mesh=None for the dense single-device route"
        )


def should_distribute(n: int, mesh, dtype=torch.float32, budget_bytes: int = DENSE_BUDGET_BYTES) -> bool:
    """True when the dense fit's working set (~3 N² buffers: K, its factor
    and the autograd residuals) exceeds the per-device budget and a
    multi-device mesh is there to shard it: never without a mesh."""
    _require_single_device(mesh)
    return False


class _DenseGPAdapter:
    """A dense ``gp.GPState`` behind the distributed GP's interface, so that
    callers of ``fit_gp_auto`` see one surface either way."""

    def __init__(self, state: G.GPState, config: GPConfig, y_std_buf: Tensor):
        self.state = state
        self.config = config
        self.raw = state.raw
        self._y_std_buf = y_std_buf

    def posterior(self, xs: Tensor) -> Tuple[Tensor, Tensor]:
        return G.gp_posterior(self.state, xs, self.config)

    def mll(self) -> Tensor:
        """The MLL of the warped, standardized targets (the distributed GP's
        convention)."""
        return G.mll(self.state.raw, self.state.x_buf, self._y_std_buf, self.state.mask, self.config)


def _adapt_dense(state: G.GPState, y: Tensor, mask: Tensor, config: GPConfig) -> _DenseGPAdapter:
    y_std_buf, _, _ = T.standardize(T.warp_y(y, config.y_warp), mask)
    return _DenseGPAdapter(state, config, y_std_buf)


def fit_gp_auto(
    x: Tensor,
    y: Tensor,
    config: GPConfig = GPConfig(),
    mesh=None,
    panel: int = 128,
    budget_bytes: int = DENSE_BUDGET_BYTES,
    warm_start: Optional[G.GPParams] = None,
    generator: Optional[torch.Generator] = None,
    restart_uniforms: Optional[Tensor] = None,
) -> _DenseGPAdapter:
    """Fit an exact GP on the unmasked history ``(x, y)``, routed by
    ``should_distribute`` (the dense ``gp.fit_gp`` here). Returns an object
    with ``.posterior(xs) -> (mu, var)``, ``.mll()`` and ``.raw`` (pass
    ``.raw`` back as ``warm_start`` for the next refit). Where the JAX
    package takes a key, this takes the restart draws: ``generator`` or
    ``restart_uniforms``, as ``gp.fit_gp`` does. ``panel`` is the
    distributed route's factorization panel; the dense route ignores it."""
    n = x.shape[0]
    should_distribute(n, mesh, x.dtype, budget_bytes)
    mask = L.row_mask(n, n, x.device)
    state = G.fit_gp(x, y, mask, config, warm_start=warm_start, generator=generator,
                     restart_uniforms=restart_uniforms)
    return _adapt_dense(state, y, mask, config)


def refactor_gp_auto(
    x: Tensor,
    y: Tensor,
    raw: G.GPParams,
    config: GPConfig = GPConfig(),
    mesh=None,
    panel: int = 128,
    budget_bytes: int = DENSE_BUDGET_BYTES,
) -> _DenseGPAdapter:
    """Rebuild the cached factorization over the current ``(x, y)`` at the
    pinned hypers ``raw``: the off-cadence twin of ``fit_gp_auto`` (same
    routing, same surface, no MLL optimization). The posterior must see
    every observation between refits; reusing a stale fitted object would
    skip the newest batches."""
    n = x.shape[0]
    should_distribute(n, mesh, x.dtype, budget_bytes)
    mask = L.row_mask(n, n, x.device)
    state = G.make_gp_state(x, y, mask, raw, config)
    return _adapt_dense(state, y, mask, config)
