"""``suggest``: ``turbojax_torch.bo._suggest`` back to back from one caller
(a closed loop) against a posterior cached in set-up over X₀ at the
configuration's default hypers; a batch is one request of q points by
exact Thompson sampling (``ts_sampler`` "exact", chunks of ``ts_chunk``)
over fresh candidates, timed to its ``synchronize``. Its answer is q
points of the unit cube.

The reference works out the posterior over X₀ once, then each checked
request's joint draws from its own candidates and normals."""

from __future__ import annotations

import time
from typing import List

import torch

from portbench import harness as H
from portbench.reference import gp64 as R
from portbench.reference import judge as J
from portbench.yardstick import work as W

Tensor = torch.Tensor


class Entry:
    def __init__(self, config: dict, traffic: dict, inputs, device):
        from turbojax_torch import gp as G
        from turbojax_torch.bo import BOCarry, BOConfig
        from turbojax_torch.linalg import row_mask

        self.config, self.traffic, self.inputs, self.device = config, traffic, inputs, torch.device(device)
        self.q, self.n = int(config["batch_size"]), int(config["n_init"])
        self.chunk = int(config["ts_chunk"])
        if config["acq"] != "ts" or traffic["ts_sampler"] != "exact":
            raise ValueError("the suggest entry samples exactly: acq 'ts', ts_sampler 'exact'")
        self.gp = H.gp_config(config, traffic)
        self.bo = BOConfig(n_init=self.n, max_evals=self.n, batch_size=self.q, acq="ts",
                           n_candidates=int(config["n_candidates"]), ts_chunk=self.chunk, ts_sampler="exact")
        self.default_raw = H.default_raw(config)
        y0 = inputs.objective(inputs.to_box(inputs.x0))
        state = G.make_gp_state(inputs.x0, y0, row_mask(self.n, self.n, self.device),
                                H.gp_params(self.default_raw, self.device), self.gp)
        self.carry = BOCarry(x_buf=inputs.x0, y_buf=y0, n=self.n, chol=state.chol, raw=state.raw,
                             y_mean=state.y_mean, y_std=state.y_std)

    # the program

    def _request(self, tag: str, r: int) -> Tensor:
        from turbojax_torch import acq as A
        from turbojax_torch.bo import _suggest

        draws = A.Draws(normals=self.inputs.ts_normals(tag, r))
        return _suggest(self.carry, self.gp, self.bo, None, cands=self.inputs.candidates(tag, r), draws=draws)

    def warm_up(self) -> None:
        for r in range(2):
            self._request("warm", r)
        H.sync(self.device)

    def window(self, seconds: float) -> List[dict]:
        batches: List[dict] = []
        t_start = time.perf_counter()
        prev = t_start
        with H.ValueTap() as tap:
            while prev - t_start < seconds:
                points = self._request("window", len(batches))
                H.sync(self.device)
                t = time.perf_counter()
                batches.append({"segment": 0, "it": len(batches), "n": self.n, "fit": False, "t": t - t_start,
                                "latency_s": t - prev, "points": H.host(points), "values": H.host(tap.take())})
                prev = t
        return batches

    def release(self) -> None:
        self.carry = None

    def work(self, batch: dict) -> dict:
        return W.exact_ts_batch(int(batch["n"]), int(self.config["dim"]), int(self.config["n_candidates"]),
                                self.chunk)

    # the reference

    def _posterior(self, dtype) -> R.Posterior:
        inputs = self.inputs
        y0 = inputs.objective(inputs.to_box(inputs.x0)).to(dtype)
        raw = torch.tensor(self.default_raw, dtype=dtype, device=self.device)
        return R.posterior(inputs.x0.to(dtype), y0, raw, self.config["gp"])

    def _values(self, post: R.Posterior, r: int, cands: Tensor) -> Tensor:
        dtype = post.x.dtype
        return R.exact_values(post, cands.to(dtype), self.inputs.ts_normals("window", r).to(dtype), self.chunk)

    def judge(self, batches: List[dict], dtype=torch.float64) -> dict:
        checked = H.check_sample(len(batches), int(self.traffic.get("check_batches", 0)), self.inputs.seed)
        post = self._posterior(dtype)
        per_batch = []
        for i in checked:
            r = batches[i]["it"]
            cands = self.inputs.candidates("window", r)
            per_batch.append(J.judge_batch(batches[i]["values"], batches[i]["points"], cands,
                                           self._values(post, r, cands)))
        return J.numbers(per_batch)

    def control_batches(self, count: int, dtype=torch.float32) -> List[dict]:
        """``count`` requests answered by the reference in ``dtype`` in the
        program's place, with the window's candidates and normals."""
        post = self._posterior(dtype)
        out = []
        for r in range(count):
            cands = self.inputs.candidates("window", r)
            values = self._values(post, r, cands)
            out.append({"segment": 0, "it": r, "n": self.n, "fit": False,
                        "points": cands[R.select_q(values)], "values": values})
        return out
