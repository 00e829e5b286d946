"""What every entry (``entries/<entry>.py``) shares: the window's stop,
the tap on the sampler's values, the program's GP settings from a
configuration, a batch's record on the host, and the sample of batches
the reference checks.

An entry's ``Entry(config, traffic, inputs, device)`` has ``warm_up()``,
``window(seconds) -> batches``, ``release()``, ``work(batch)`` (the
batch's work, ``yardstick.work``), ``judge(batches) -> numbers``
(``reference.judge.numbers``) and ``control_batches(count)`` (the
reference, one precision below, in the program's place); on more than one
chip its ``window`` ends on ``window_over``. A batch is a
dict with ``segment``, ``it``, ``n`` (the history size), ``fit``, ``t``
and ``latency_s`` (host clock, from the window's start), ``points`` (the
answer, in the box) and ``values`` (the sampler's values)."""

from __future__ import annotations

from typing import List, Optional

import torch

from portbench import inputs as I
from portbench.reference import gp64 as R

Tensor = torch.Tensor


class Stop(Exception):
    """Ends the window at an iteration boundary."""


def window_over(elapsed_s: float, seconds: float) -> bool:
    """Whether the window ends at this batch boundary, ``elapsed_s`` after
    its start. On one chip it is the clock test. On a group of ranks (see
    ``ranks``) rank 0's clock decides, and one broadcast of one flag hands
    its decision to every rank, so that all end the window after the same
    batch; an entry that runs on more than one chip calls it at each batch
    boundary, on every rank."""
    import torch.distributed as dist

    over = elapsed_s >= seconds
    if not (dist.is_available() and dist.is_initialized()):
        return over
    nccl = dist.get_backend() == "nccl"
    flag = torch.tensor([over], dtype=torch.uint8,
                        device=torch.device("cuda", torch.cuda.current_device()) if nccl else "cpu")
    dist.broadcast(flag, src=0)
    return bool(flag.item())


class ValueTap:
    """Keeps the Thompson values each batch hands to the program's q-batch
    selection (``turbojax_torch.acq.select_q_batch``, which both entries
    call through the module): a reference to the tensor, no copy and no
    sync inside the program's step. The answers are judged by their picks;
    these values let the reference judge the sampler's numbers as well."""

    def __init__(self):
        self.last: Optional[Tensor] = None
        self._orig = None

    def __enter__(self):
        from turbojax_torch import acq as A

        self._orig = orig = A.select_q_batch

        def tapped(samples, *args, **kwargs):
            self.last = samples
            return orig(samples, *args, **kwargs)

        A.select_q_batch = tapped
        return self

    def __exit__(self, *exc):
        from turbojax_torch import acq as A

        A.select_q_batch = self._orig
        return False

    def take(self) -> Optional[Tensor]:
        out, self.last = self.last, None
        return out


def gp_config(config: dict, traffic: dict):
    from turbojax_torch.config import GPConfig

    gp = config["gp"]
    return GPConfig(
        kernel=gp["kernel"], use_ard=True, noise_floor=gp["noise_floor"], jitter=gp["jitter"],
        lengthscale_bounds=tuple(gp["lengthscale_bounds"]), outputscale_bounds=tuple(gp["outputscale_bounds"]),
        noise_bounds=tuple(gp["noise_bounds"]), fit_lr=gp["fit_lr"],
        fit_optimizer=traffic.get("fit_optimizer", "adam"), fit_maxiter=int(traffic.get("fit_maxiter", 5)),
        fit_restarts=int(traffic.get("fit_restarts", 1)),
    )


def default_raw(config: dict) -> List[float]:
    """The configuration's default hypers as raw values, float32-rounded
    as the program holds them."""
    hy, dim = config["default_hypers"], int(config["dim"])
    raw = R.raw_from_values(hy["lengthscale"], hy["outputscale"], hy["noise"], dim, config["gp"], torch.float32)
    return raw.tolist()


def gp_params(raw: List[float], device):
    from turbojax_torch.gp import GPParams

    t = torch.tensor(raw, dtype=torch.float32, device=device)
    return GPParams(raw_lengthscale=t[:-3].clone(), raw_outputscale=t[-3].clone(), raw_noise=t[-2].clone(),
                    raw_mean=t[-1].clone())


def host(t: Optional[Tensor]) -> Optional[Tensor]:
    """A batch's record, kept on the host once the batch has ended, so that
    what the harness keeps never adds to the window's device memory."""
    return None if t is None else t.detach().to("cpu")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check_sample(n_batches: int, count: int, seed: int, key=None) -> List[int]:
    """The batches the reference checks: all of them when ``count`` is 0
    or covers them, else ``count`` drawn from the seed, with the batch
    ``key`` orders last (the largest history) always among them."""
    if count <= 0 or count >= n_batches:
        return list(range(n_batches))
    order = sorted(range(n_batches), key=key) if key else list(range(n_batches))
    g = torch.Generator().manual_seed(I.sub_seed(seed, "check"))
    rest = torch.randperm(n_batches - 1, generator=g)[:count - 1].tolist()
    return sorted({order[-1]} | {order[i] for i in rest})
