"""``mesh``: ``turbojax_torch.bo_distributed.run_bo_distributed`` over a
mesh of every rank of the run (``parallel.make_mesh()``), on the
row-sharded GP (``budget_bytes=0``: at the cells' sizes the default budget
routes there too; tiny twins need it forced), in segments of
``segment_iterations`` iterations from X₀ as ``loop`` runs them on one
card. Every rank runs the loop with the same inputs and draws and ends the
window with ``harness.window_over`` at each batch boundary, so that all
ranks stop after the same batch; rank 0 evaluates the objective and
records the answers, which the harness judges on rank 0 once the group is
gone. Without a process group (one process, as the control runs) the loop
runs without a mesh, on the dense route.

The reference is ``reference/gp64_blocked.py``: the history's K(X, X) in
one float64 buffer factored in place, since ``gp64``'s out-of-place factor
needs three N² buffers, more than the card holds at these N. It follows
each checked segment's history from X₀ as ``loop``'s does."""

from __future__ import annotations

import time
from typing import List

import torch

from portbench import harness as H
from portbench import inputs as I
from portbench.entries import loop
from portbench.reference import gp64_blocked as RB
from portbench.yardstick import mesh_work as MW

Tensor = torch.Tensor


class Entry(loop.Entry):
    def __init__(self, config: dict, traffic: dict, inputs, device):
        super().__init__(config, traffic, inputs, device)
        self.mesh = None

    def _mesh(self):
        import torch.distributed as dist

        if self.mesh is None and dist.is_available() and dist.is_initialized():
            from turbojax_torch.parallel import make_mesh

            self.mesh = make_mesh()
        return self.mesh

    def _segment(self, tag: str, seg: int, bo, on_iteration) -> None:
        from turbojax_torch.bo_distributed import run_bo_distributed

        inputs = self.inputs
        run_bo_distributed(
            self._fn, [inputs.lb] * inputs.dim, [inputs.ub] * inputs.dim, bo, self.gp, mesh=self._mesh(),
            budget_bytes=0, on_iteration=on_iteration, fixed_params=self.fixed,
            generator=I.generator(self.device, inputs.seed, tag, "segment", seg),
            x_init=inputs.x0, draws=lambda it: self._draws(tag, seg, it),
        )

    def window(self, seconds: float) -> List[dict]:
        batches: List[dict] = []
        t_start = time.perf_counter()
        marks = {"prev": t_start}
        seg = 0

        def on_iteration(it: int, best: float) -> None:
            t = time.perf_counter()
            batches.append({"segment": seg, "it": it, "n": self.n_init + it * self.q, "fit": self.fits(it),
                            "t": t - t_start, "latency_s": t - marks["prev"], "points": H.host(self._last),
                            "values": H.host(self._tap.take())})
            marks["prev"] = t
            if H.window_over(t - t_start, seconds):
                raise H.Stop

        with H.ValueTap() as tap:
            self._tap = tap
            while True:
                try:
                    self._segment("window", seg, self.bo, on_iteration)
                except H.Stop:
                    break
                seg += 1
        return batches

    def release(self) -> None:
        super().release()
        self.mesh = None

    def work(self, batch: dict) -> dict:
        world = self.mesh.size if self.mesh is not None else 1
        return MW.mesh_batch(int(batch["n"]), self.q, world)

    # the reference

    def _values(self, seg: int, it: int, x: Tensor, y: Tensor, raw: Tensor, cands: Tensor) -> Tensor:
        dtype = x.dtype
        p = self.inputs.pathwise(self.n_init + it * self.q, "window", seg, it)
        post = RB.posterior(x, y, raw, self.config["gp"])
        return RB.pathwise_values(post, cands.to(dtype), p.omega.to(dtype), p.b.to(dtype), p.weights.to(dtype),
                                  p.eps.to(dtype))
