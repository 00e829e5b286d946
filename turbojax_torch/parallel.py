"""Device parallelism over ``torch.distributed`` (port of ``turbojax.parallel``).

A mesh is a process group: one process per device, NCCL between GPUs and
gloo between CPU processes (the tests). ``make_mesh`` wraps the group that
the caller initialised (``torch.distributed.init_process_group``, or
``torchrun``, which sets the ranks and the rendezvous) in a ``Mesh``; it
never initialises one itself, and a one-device mesh is a group of one
process whose collectives run all the same. The JAX package's ``shard_map``
bodies become plain functions of the local block, and its collectives map
as ``lax.all_gather(tiled=True)`` → ``all_gather`` and ``cat``,
``lax.psum`` → ``all_reduce(SUM)``, ``lax.pmin`` → ``all_reduce(MIN)``,
``lax.axis_index`` → ``mesh.rank``.

**Layout contract**, held by every function here and in
``distributed_linalg``:

* every rank calls each function with the same arguments;
* what the JAX package replicates (``P()``, ``P(None, ...)``: ``x``, ``xs``,
  ``y``, hypers, draws) is passed whole on every rank;
* what it shards on the mesh axis (``P(axis, ...)``: the distributed
  matrices and right-hand sides, the candidates of ``sharded_acq_topq`` and
  ``sharded_thompson_select``, the TuRBO-m carries) is passed as the rank's
  own block, rows ``[rank·N/D, (rank+1)·N/D)``;
* outputs follow the same rule: sharded outputs come back as the local
  block, replicated ones whole on every rank (``gather_rows`` assembles a
  sharded one, for tests and checks);
* a branch that depends on data one rank sees alone is decided on an
  all-reduced flag, so that every rank takes it and meets the same next
  collective.

Random draws: a generator that every rank holds in the same state draws
replicated values (restart inits, candidates, prior paths) identically on
every rank. Where the JAX package folds the device index into a key (the
per-shard Thompson draws, TuRBO-m's regions), the port draws the whole
stacked set and keeps the rank's slice, or seeds one generator per rank.

Three axes: the **candidate** axis (``sharded_acq_topq``,
``sharded_thompson_select``: a per-rank top-q, then an all-gather of the
q·D survivors), the **restart** axis (``sharded_fit_gp``) and the
**trust-region** axis (``sharded_turbom_step``, ``run_turbom_sharded``).
The objective runs on rank 0, which broadcasts its values: the same
computation as the JAX package's, where every device evaluates it, but a
nondeterministic objective cannot give different ranks different values.
``fleet_run`` splits seeds over processes with no communication.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from turbojax_torch import acq as A
from turbojax_torch import gp as G
from turbojax_torch import sampling as S
from turbojax_torch import transforms as T
from turbojax_torch import trust_region as TR
from turbojax_torch import turbo_m as TM
from turbojax_torch.bo import lowest_k
from turbojax_torch.config import GPConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the process group of its ``size`` ranks, this process's
    ``rank`` in it, the mesh ``axis`` name, and the ``device`` this rank's
    tensors live on (``cuda:LOCAL_RANK`` under NCCL, the CPU under gloo)."""

    group: Any
    axis: str
    size: int
    rank: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    """A mesh over the first ``n_devices`` ranks (default: all) of the
    initialised default process group. Every rank of the group calls it (a
    sub-group is created collectively); a rank outside the mesh gets a
    ``ValueError``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised process group, one process per device: call "
            "torch.distributed.init_process_group first, or start the script under "
            "torchrun --nproc-per-node N"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    size = n_devices or world
    if not 1 <= size <= world:
        raise ValueError(f"a mesh of {size} devices needs as many ranks; the process group has {world}")
    group = dist.group.WORLD if size == world else dist.new_group(list(range(size)))
    if rank >= size:
        raise ValueError(f"rank {rank} is outside the mesh of the first {size} ranks")
    backend = dist.get_backend(group)
    if backend == "nccl":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"a mesh runs on an nccl or gloo process group, not {backend!r}")
    return Mesh(group=group, axis=axis, size=size, rank=rank, device=device)


# --------------------------------------------------------------------------
# Collectives on the mesh: every rank calls each with a tensor of the same
# shape and dtype on mesh.device.


def gather_rows(local: Tensor, mesh: Mesh) -> Tensor:
    """The ranks' blocks stacked along dim 0 in rank order (a row-sharded
    array made whole; ``lax.all_gather(tiled=True)``)."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts)


def all_sum(t: Tensor, mesh: Mesh) -> Tensor:
    """``lax.psum``: the sum over the ranks, on every rank."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_min(t: Tensor, mesh: Mesh) -> Tensor:
    """``lax.pmin``: the minimum over the ranks, on every rank."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=mesh.group)
    return out


def all_true(flag: Tensor, mesh: Mesh) -> bool:
    """Whether ``flag`` holds on every rank, read on the host: the one way
    to branch on data that one rank sees alone (a row block's
    factorization), so that every rank takes the same branch."""
    return bool(all_min(flag.to(torch.int32).reshape(1), mesh).item())


def barrier(mesh: Mesh) -> None:
    """A host barrier: returns once every rank has reached it. A collective
    read back to the host, so it also orders what the ranks did before it
    (a file rank 0 wrote) under NCCL, whose collectives are asynchronous."""
    all_true(torch.ones(1, dtype=torch.int32, device=mesh.device), mesh)


def broadcast_from(t: Tensor, mesh: Mesh, src: int = 0) -> Tensor:
    """Rank ``src``'s ``t`` on every rank (``t`` is a buffer of the right
    shape elsewhere)."""
    out = t.contiguous()
    dist.broadcast(out, src=src, group=mesh.group)
    return out


def evaluate_on_rank0(fn: Callable[[Tensor], Tensor], x: Tensor, mesh: Mesh) -> Tensor:
    """``fn(x)`` as a (q,) tensor of x's dtype on every rank: rank 0
    evaluates the objective and broadcasts its values."""
    if mesh.rank == 0:
        y = torch.as_tensor(fn(x)).to(dtype=x.dtype, device=mesh.device).reshape(-1)
    else:
        y = torch.empty(x.shape[0], dtype=x.dtype, device=mesh.device)
    return broadcast_from(y, mesh)


def resolve_device(device, what: str) -> torch.device:
    """``device`` or, by default, the GPU; raises when that is not there."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the GPU unless told otherwise, and torch.cuda.is_available() is False; "
            'pass device="cpu" to run on the CPU'
        )
    return device


def run_generator(device, generator: Optional[torch.Generator], mesh: Optional[Mesh], seed: int,
                  what: str) -> torch.Generator:
    """The generator a run draws from, whose device is the run's: with a
    mesh, ``device`` and ``generator`` must be on the mesh's device; without
    a generator, one seeded with ``seed`` on ``device`` (``resolve_device``);
    a given generator must be on ``device`` where that is given too."""
    if mesh is not None:
        device = mesh_device(mesh, device, generator)
    if generator is None:
        return torch.Generator(device=resolve_device(device, what)).manual_seed(seed)
    if device is not None and not same_device(device, generator.device):
        raise ValueError(f"device {device} differs from the generator's {generator.device}")
    return generator


def mesh_device(mesh: Mesh, device=None, generator: Optional[torch.Generator] = None) -> torch.device:
    """The device a run on ``mesh`` uses, the mesh's; a ``device`` or a
    ``generator`` given beside the mesh must be on the same one."""
    for given in (device, None if generator is None else generator.device):
        if given is not None and not same_device(given, mesh.device):
            raise ValueError(f"device {given} differs from the mesh's {mesh.device}")
    return mesh.device


def same_device(a, b) -> bool:
    """Whether two device specs name one device (``cuda`` is the current
    CUDA device)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == (b.index if b.index is not None else current)


# --------------------------------------------------------------------------
# Candidate axis: posterior + acquisition + top-q over a sharded candidate set


def sharded_acq_topq(
    state: G.GPState, cands_loc: Tensor, best: Tensor, q: int, mesh: Mesh, config: GPConfig,
    acq: str = "ei", kappa: float = 2.0, xi: float = 0.0,
) -> Tuple[Tensor, Tensor]:
    """EI (negated) or LCB over the rank's candidate block ``cands_loc`` and
    the global top-q (points, scores; the lower score the better), on every
    rank. The GP state is replicated. Each rank keeps its q best (ties to
    the lower index, ``bo.lowest_k``), then the q·D survivors are
    all-gathered in rank order and the q best of them taken the same way:
    the traffic is O(q·D·d), not O(n_cand)."""
    if q > cands_loc.shape[0]:
        raise ValueError(f"q ({q}) must fit in one candidate shard ({cands_loc.shape[0]})")
    mu, var = G.gp_posterior(state, cands_loc, config)
    if acq == "ei":
        scores = -A.expected_improvement(mu, var, best, xi)
    elif acq == "lcb":
        scores = A.lower_confidence_bound(mu, var, kappa)
    else:
        raise ValueError(f"unknown acq {acq!r}")
    idx = lowest_k(scores, q)
    all_scores = gather_rows(scores[idx], mesh)  # (D·q,)
    all_points = gather_rows(cands_loc[idx], mesh)  # (D·q, d)
    top = lowest_k(all_scores, q)
    return all_points[top], all_scores[top]


def sharded_thompson_select(
    state: G.GPState, cands_loc: Tensor, q: int, mesh: Mesh, config: GPConfig,
    chunk_size: Optional[int] = None, generator: Optional[torch.Generator] = None,
    normals: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Batched Thompson sampling with the candidate axis sharded: each rank
    draws q joint sample rows over its block (``acq.thompson_samples``,
    independent across blocks, as across chunks), keeps each row's q lowest
    (with global candidate ids), and the all-gathered survivors go through
    the argmin without replacement, one draw row after another. Returns
    (points (q, d), values (q,)) on every rank.

    ``normals`` ((q, shard): this rank's draws) replaces the generator's.
    Without it every rank draws the whole (D, q, shard) stack from a
    generator held in the same state everywhere and keeps its own slice,
    where the JAX package folds the device index into the key."""
    shard = cands_loc.shape[0]
    if q > shard:
        raise ValueError(f"q ({q}) must fit in one candidate shard ({shard})")
    if normals is None:
        normals = torch.randn((mesh.size, q, shard), generator=generator, dtype=cands_loc.dtype,
                              device=cands_loc.device)[mesh.rank]
    draws = A.thompson_samples(state, cands_loc, q, config, chunk_size, generator, normals)  # (q, shard)
    idx = torch.sort(draws, dim=-1, stable=True).indices[:, :q]  # (q, q): each row's q lowest
    scores = draws.gather(-1, idx)
    gidx = mesh.rank * shard + idx
    pts = cands_loc[idx]  # (q, q, d)
    all_scores = gather_rows(scores[None], mesh).transpose(0, 1).reshape(q, mesh.size * q)
    all_gidx = gather_rows(gidx[None], mesh).transpose(0, 1).reshape(q, mesh.size * q)
    all_pts = gather_rows(pts[None], mesh).transpose(0, 1).reshape(q, mesh.size * q, -1)
    big = torch.finfo(all_scores.dtype).max
    taken = torch.zeros(mesh.size * shard, dtype=torch.bool, device=cands_loc.device)
    chosen, vals = [], []
    for row_s, row_g, row_p in zip(all_scores, all_gidx, all_pts):
        masked = torch.where(taken[row_g], big, row_s)
        i = torch.argmin(masked).reshape(1)  # the first among equals
        taken = taken.index_fill(0, row_g.index_select(0, i), True)
        chosen.append(row_p.index_select(0, i))
        vals.append(masked.index_select(0, i))
    return torch.cat(chosen), torch.cat(vals)


# --------------------------------------------------------------------------
# Restart axis


def sharded_fit_gp(
    x_buf: Tensor, y_buf: Tensor, mask: Tensor, config: GPConfig, mesh: Mesh,
    warm_start: Optional[G.GPParams] = None, generator: Optional[torch.Generator] = None,
    restart_uniforms: Optional[Tensor] = None,
) -> G.GPState:
    """The multi-restart fit with the restarts sharded by rank: restart 0 is
    ``warm_start`` (or the defaults), the others log-uniform inits drawn on
    every rank alike (``generator``, or ``restart_uniforms`` of shape
    (fit_restarts − 1, d_eff + 2)); each rank runs its ``fit_restarts / D``
    lanes as one batch (``gp._fit_one``), the ranks all-gather the losses
    (non-finite as +inf) and the fitted hypers, and every rank takes the
    argmin, the first among equals. Returns ``make_gp_state`` at the
    winner, on every rank."""
    r = config.fit_restarts
    if r % mesh.size:
        raise ValueError(f"fit_restarts ({r}) must be a multiple of the mesh size ({mesh.size})")
    dim = x_buf.shape[-1]
    dtype, device = y_buf.dtype, y_buf.device
    # the GP models warp_y(y), as gp.fit_gp and make_gp_state do
    y_std, _, _ = T.standardize(T.warp_y(y_buf, config.y_warp), mask)
    base = warm_start if warm_start is not None else G.default_params(dim, config, dtype, device)
    inits = G.GPParams(*(a[None] for a in base))
    if r > 1:
        rand = G.sample_restart_params(dim, config, r - 1, generator, dtype, device, restart_uniforms)
        inits = G.GPParams(*(torch.cat([b, rr]) for b, rr in zip(inits, rand)))
    r_loc = r // mesh.size
    mine = G.GPParams(*(a[mesh.rank * r_loc:(mesh.rank + 1) * r_loc] for a in inits))
    fitted, losses = G._fit_one(mine, x_buf, y_std, mask, config)
    losses = torch.where(torch.isfinite(losses), losses, torch.full_like(losses, torch.inf))
    all_losses = gather_rows(losses, mesh)
    all_fitted = G.GPParams(*(gather_rows(a.detach(), mesh) for a in fitted))
    return G.make_gp_state(x_buf, y_buf, mask, G._row(all_fitted, torch.argmin(all_losses)), config)


# --------------------------------------------------------------------------
# Trust-region axis


def gather_carries(carries: TR.TurboCarry, mesh: Mesh) -> TR.TurboCarry:
    """Every rank's regions stacked in rank order: the m regions whole."""
    n = gather_rows(torch.tensor(carries.n, dtype=torch.int64, device=carries.x_buf.device), mesh)
    return TR.TurboCarry(
        x_buf=gather_rows(carries.x_buf, mesh), y_buf=gather_rows(carries.y_buf, mesh), n=tuple(n.tolist()),
        raw=G.GPParams(*(gather_rows(a, mesh) for a in carries.raw)),
        tr=TR.TRState(*(gather_rows(a, mesh) for a in carries.tr)),
        init_stream=gather_rows(carries.init_stream, mesh), best_x=gather_rows(carries.best_x, mesh),
        best_y=gather_rows(carries.best_y, mesh),
    )


def sharded_turbom_step(
    carries: TR.TurboCarry, fn: Callable[[Tensor], Tensor], lb: Tensor, ub: Tensor, cfg: TR.TurboConfig,
    config: GPConfig, mesh: Mesh, n_cand: int, fail_tol: int, generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[TM.Draws]] = None, restart_streams: Optional[Tensor] = None,
) -> Tuple[TR.TurboCarry, Tensor, List[int], List[int]]:
    """One TuRBO-m iteration with the m trust regions sharded across the
    mesh; ``carries`` holds this rank's m/D regions (regions
    rank·m/D, ...). Each rank fits its regions and draws their Thompson
    values (``turbo_m.region_values``, on the rung views of
    ``turbo_m.fit_capacities``); the (m, q, n_cand) values and (m, n_cand,
    d) candidates are all-gathered and every rank runs the same
    ``global_allocate``; rank 0 evaluates ``fn`` on the q points in the box
    [lb, ub] and broadcasts the values; failures are imputed against the
    all-gathered history of every region; each rank absorbs the points
    allocated to its regions; the incumbent is the all-reduced minimum.
    ``draws`` (one ``turbo_m.Draws`` per local region) and
    ``restart_streams`` ((m/D, stream_len, d)) replace the generator's
    draws. Returns (the rank's carries, the incumbent, tr_idx, cand_idx),
    the allocation as host lists."""
    m_loc, n_buf = carries.y_buf.shape
    cfg = dataclasses.replace(cfg, n_candidates=n_cand)
    cap, cap_b = TM.fit_capacities(carries.n, cfg)
    cap = min(cap, n_buf)
    cap_b = cap_b if cap_b is not None and cap_b < cap else None
    carries, cands_loc, values_loc = TM.region_values(carries, cfg, config, generator, cap, cap_b, draws)
    values = gather_rows(values_loc, mesh)  # (m, q, n_cand)
    cands = gather_rows(cands_loc, mesh)  # (m, n_cand, d)
    tr_idx, cand_idx = TM.global_allocate(values, cfg.alloc_cap)
    x_sel = cands[tr_idx, cand_idx]
    tr_host, cand_host = torch.stack([tr_idx, cand_idx]).tolist()
    y_sel = evaluate_on_rank0(lambda x: fn(T.from_unit_cube(x, lb, ub)), x_sel, mesh)

    # impute failures against the global history, as the unsharded loop does
    device = carries.y_buf.device
    y_all = gather_rows(carries.y_buf, mesh)
    n_all = gather_rows(torch.tensor(carries.n, dtype=torch.int64, device=device), mesh)
    hist_mask = (torch.arange(n_buf, device=device)[None, :] < n_all[:, None]).reshape(-1)
    y_sel = T.impute_failures(y_sel, y_all.reshape(-1), hist_mask)

    local_ids = mesh.rank * m_loc + np.arange(m_loc)
    accept = np.asarray(tr_host)[None, :] == local_ids[:, None]
    in_search = [n >= cfg.n_init for n in carries.n]
    carries = TR.absorb(carries, x_sel, y_sel, accept, in_search, cfg, fail_tol, generator, restart_streams)
    return carries, all_min(carries.best_y.min(), mesh), tr_host, cand_host


def run_turbom_sharded(
    fn: Callable[[Tensor], Tensor], lb: Sequence[float], ub: Sequence[float], cfg: TR.TurboConfig,
    config: GPConfig, mesh: Mesh, m: Optional[int] = None, n_loc: Optional[int] = None,
    on_iteration: Optional[Callable[[int, float], None]] = None, generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
) -> Tuple[TR.TurboCarry, Tensor]:
    """TuRBO-m with the trust regions sharded across the mesh: a host loop of
    ``cfg.n_iters`` ``sharded_turbom_step``s on ``mesh.device``. ``m``
    defaults to the mesh size and must be a multiple of it. Buffers are
    allocated once at ``n_loc`` (default n_init + n_iters·q) rows, as in the
    JAX package. ``generator`` (held in the same state on every rank;
    default: seeded with 0) seeds one generator per rank, so that the
    ranks' regions draw apart, as the JAX package's folded keys do.
    ``on_iteration(it, best)`` gets the incumbent as a float. Returns (this
    rank's carries, the incumbent trace (n_iters,)); ``gather_carries``
    assembles all regions."""
    m = m or mesh.size
    if m % mesh.size:
        raise ValueError(f"m ({m}) must be a multiple of the mesh size ({mesh.size})")
    device = mesh.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dim = len(lb)
    n_cand = cfg.n_candidates or S.n_candidates(dim)
    TM._check_n_cand(cfg, n_cand)
    n_loc = n_loc or cfg.n_init + cfg.n_iters * cfg.batch_size
    fail_tol = cfg.tr.resolved_fail_tol(dim, cfg.batch_size)
    seeds = torch.randint(0, 2**62, (mesh.size,), generator=generator, device=generator.device)
    rank_gen = torch.Generator(device=device).manual_seed(int(seeds[mesh.rank]))
    carries = TR.stack_carries([TR.make_turbo_carry(dim, n_loc, cfg, config, rank_gen, dtype, device)
                                for _ in range(m // mesh.size)])
    lb_t = torch.tensor(tuple(lb), dtype=dtype, device=device)
    ub_t = torch.tensor(tuple(ub), dtype=dtype, device=device)
    trace = []
    for it in range(cfg.n_iters):
        carries, best, _, _ = sharded_turbom_step(carries, fn, lb_t, ub_t, cfg, config, mesh, n_cand, fail_tol,
                                                  rank_gen)
        trace.append(best)
        if on_iteration is not None:
            on_iteration(it, float(best))
    return carries, torch.stack(trace) if trace else torch.empty(0, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# Seeds over processes


def fleet_run(run_fn: Callable[[int], Any], seeds: Sequence[int], process_index: Optional[int] = None,
              process_count: Optional[int] = None) -> Tuple[List[int], List[Any]]:
    """Run ``run_fn(seed)`` for this process's slice of ``seeds``,
    ``seeds[i::count]``, with no communication. ``process_index`` and
    ``process_count`` default to the rank and world size of the initialised
    process group (0 and 1 without one). ``run_fn`` takes the integer seed,
    where the JAX package hands it a key: torch has no key object, and a
    generator belongs to one device, so the function makes its own. Returns
    (this process's seeds, their results)."""
    grouped = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (dist.get_rank() if grouped else 0)
    pc = process_count if process_count is not None else (dist.get_world_size() if grouped else 1)
    mine = list(seeds)[pi::pc]
    return mine, [run_fn(s) for s in mine]
