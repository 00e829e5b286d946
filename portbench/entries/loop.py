"""``loop``: ``turbojax_torch.bo_distributed.run_bo_distributed`` at world
size one (the dense route) in segments of ``segment_iterations``
iterations, each from the initial design X₀ with the segment's own
generator and draws; the window ends at the first iteration boundary after
``--seconds`` (stopped from ``on_iteration``). A batch is one iteration: a
fit at the traffic's cadence (``fit_every``; 0 pins the configuration's
default hypers) by ``fit_maxiter`` Adam steps from one start, q points by
pathwise Thompson sampling, their evaluation.

The reference follows each checked segment's history from X₀ (the
program's recorded points, or in the control its own picks), fitting its
own hypers at the same cadence from the same start, and works out each
checked batch's pathwise values from the same draws."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from portbench import harness as H
from portbench import inputs as I
from portbench.reference import gp64 as R
from portbench.reference import judge as J
from portbench.yardstick import work as W

Tensor = torch.Tensor


class Entry:
    #: Warm-up runs this many iterations of a segment: the first history
    #: size is a multiple of 4 and the next is not, which is what makes the
    #: libraries pick (and load) other kernels; later sizes repeat the two.
    WARM_ITERATIONS = 2

    def __init__(self, config: dict, traffic: dict, inputs, device):
        from turbojax_torch.bo import BOConfig

        self.config, self.traffic, self.inputs, self.device = config, traffic, inputs, torch.device(device)
        self.q = int(config["batch_size"])
        self.n_init = int(config["n_init"])
        self.seg_iters = int(traffic["segment_iterations"])
        self.fit_every = int(traffic["fit_every"])
        self.adam_steps = int(traffic.get("fit_maxiter", 0)) if self.fit_every else 0
        self.gp = H.gp_config(config, traffic)
        if self.fit_every and (self.gp.fit_optimizer != "adam" or self.gp.fit_restarts != 1):
            raise ValueError("the reference fits by Adam from one start: fit_optimizer 'adam', fit_restarts 1")
        if config["acq"] != "ts" or config["ts_sampler"] != "pathwise":
            raise ValueError("the loop entry samples pathwise: acq 'ts', ts_sampler 'pathwise'")
        self.bo = BOConfig(n_init=self.n_init, max_evals=self.n_init + self.seg_iters * self.q, batch_size=self.q,
                           acq=config["acq"], n_candidates=int(config["n_candidates"]), fit_every=self.fit_every,
                           rff_features=int(config["rff_features"]), local_frac=0.0)
        self.default_raw = H.default_raw(config)
        self.fixed = H.gp_params(self.default_raw, self.device) if self.fit_every == 0 else None
        self._last: Optional[Tensor] = None
        self._first_fit: Dict[torch.dtype, Tensor] = {}

    # the program

    def _fn(self, x_box: Tensor) -> Tensor:
        if x_box.shape[0] == self.q:
            self._last = x_box
        return self.inputs.objective(x_box)

    def _draws(self, tag: str, seg: int, it: int):
        from turbojax_torch import acq as A
        from turbojax_torch.bo_distributed import IterationDraws

        p = self.inputs.pathwise(self.n_init + it * self.q, tag, seg, it)
        return IterationDraws(sobol=self.inputs.candidates(tag, seg, it),
                              ts=A.Draws(omega=p.omega, b=p.b, weights=p.weights, eps=p.eps))

    def _segment(self, tag: str, seg: int, bo, on_iteration) -> None:
        from turbojax_torch.bo_distributed import run_bo_distributed

        inputs = self.inputs
        run_bo_distributed(
            self._fn, [inputs.lb] * inputs.dim, [inputs.ub] * inputs.dim, bo, self.gp,
            on_iteration=on_iteration, fixed_params=self.fixed,
            generator=I.generator(self.device, inputs.seed, tag, "segment", seg),
            x_init=inputs.x0, draws=lambda it: self._draws(tag, seg, it),
        )

    def fits(self, it: int) -> bool:
        return self.fit_every > 0 and it % self.fit_every == 0

    def warm_up(self) -> None:
        """The first iterations of a segment, with draws of their own."""
        bo = dataclasses.replace(self.bo, max_evals=self.n_init + self.WARM_ITERATIONS * self.q)
        self._segment("warm", 0, bo, None)
        H.sync(self.device)

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
            if t - t_start >= seconds:
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
        self.fixed = None

    def work(self, batch: dict) -> dict:
        return W.pathwise_batch(int(batch["n"]), int(self.config["dim"]), self.q, int(self.config["n_candidates"]),
                                self.adam_steps if batch["fit"] else 0)

    # the reference

    def _walk(self, seg: int, dtype):
        """The reference's history of segment ``seg`` from X₀, one
        iteration at a time: yields ``(it, x, y, raw)``, the history and
        the hypers that iteration samples from (fitted at the traffic's
        cadence from the default hypers), and takes back the iteration's q
        points as ``(unit points, their objective values)``."""
        inputs = self.inputs
        x = inputs.x0.to(dtype)
        y = inputs.objective(inputs.to_box(inputs.x0)).to(dtype)
        raw = torch.tensor(self.default_raw, dtype=dtype, device=self.device)
        it = 0
        while True:
            if self.fits(it):
                if it == 0 and dtype in self._first_fit:
                    raw = self._first_fit[dtype]  # every segment's first fit sees X₀ alone
                else:
                    raw = R.fit_adam(x, R.standardize(y)[0], raw, self.config["gp"], self.adam_steps)
                    if it == 0:
                        self._first_fit[dtype] = raw
            new_x, new_y = yield it, x, y, raw
            x = torch.cat([x, new_x.to(dtype)])
            y = torch.cat([y, new_y.to(dtype)])
            it += 1

    def _values(self, seg: int, it: int, x: Tensor, y: Tensor, raw: Tensor, cands: Tensor) -> Tensor:
        dtype = x.dtype
        p = self.inputs.pathwise(self.n_init + it * self.q, "window", seg, it)
        post = R.posterior(x, y, raw, self.config["gp"])
        return R.pathwise_values(post, cands.to(dtype), p.omega.to(dtype), p.b.to(dtype), p.weights.to(dtype),
                                 p.eps.to(dtype))

    def judge(self, batches: List[dict], dtype=torch.float64) -> dict:
        """The reference over the batches ``check_sample`` picks: per
        segment it follows the program's history (the recorded points, on
        the candidate each matches) from X₀ and judges each checked batch
        (``judge.judge_batch``)."""
        inputs = self.inputs
        checked = H.check_sample(len(batches), int(self.traffic.get("check_batches", 0)), inputs.seed,
                                 key=lambda i: batches[i]["n"])
        by_seg: Dict[int, List[int]] = {}
        for i in checked:
            by_seg.setdefault(batches[i]["segment"], []).append(i)
        per_batch = []
        for seg, idxs in sorted(by_seg.items()):
            seg_batches = [b for b in batches if b["segment"] == seg]
            last_it = max(batches[i]["it"] for i in idxs)
            wanted = {batches[i]["it"] for i in idxs}
            walk = self._walk(seg, dtype)
            it, x, y, raw = next(walk)
            while True:
                b = seg_batches[it]
                pts = b["points"].to(self.device)
                unit = inputs.to_unit(pts)
                cands = inputs.candidates("window", seg, it)
                if it in wanted:
                    per_batch.append(J.judge_batch(b["values"], unit, cands, self._values(seg, it, x, y, raw, cands)))
                if it == last_it:
                    break
                picks = J.match(unit, cands)
                points = torch.where((picks >= 0)[:, None], cands[picks.clamp(min=0)].to(unit.dtype), unit)
                it, x, y, raw = walk.send((points, inputs.objective(pts)))
        return J.numbers(per_batch)

    def control_batches(self, count: int, dtype=torch.float32) -> List[dict]:
        """``count`` batches of the reference in ``dtype`` in the program's
        place, with the window's draws, in the window's order."""
        inputs = self.inputs
        out: List[dict] = []
        seg = 0
        while len(out) < count:
            walk = self._walk(seg, dtype)
            it, x, y, raw = next(walk)
            while len(out) < count:
                cands = inputs.candidates("window", seg, it)
                values = self._values(seg, it, x, y, raw, cands)
                unit = cands[R.select_q(values)]
                box = inputs.to_box(unit)
                out.append({"segment": seg, "it": it, "n": self.n_init + it * self.q, "fit": self.fits(it),
                            "points": box, "values": values})
                if it + 1 == self.seg_iters:
                    break
                it, x, y, raw = walk.send((unit, inputs.objective(box)))
            seg += 1
        return out
