"""Cases of the port's multi-rank tests (``tests/test_torch_distributed_mesh.py``,
``tests/test_torch_parallel.py``, ``tests/test_torch_bo_mesh.py``), run on gloo
process groups on the CPU.

A job is ``(name, case, kwargs)``: ``case`` names a function below that
takes ``(mesh, **kwargs)`` (numpy arrays and the port's configs) and
returns a dict of numpy values, the sharded results gathered whole. Each
rank runs the jobs with the same arguments (the port's layout contract);
the case functions slice their own rank's block where the contract says
so.

* ``Spawned(world, jobs, tmp_path)``: one process group of ``world``
  processes of this file (``python tests/torch_mesh_cases.py <dir> <rank>
  <world>``) on a ``FileStore`` in ``tmp_path``, started in the background,
  every collective under a 60 s timeout; ``.wait()`` waits with its own
  deadline and fails (killing the ranks) when one of them fails or the
  deadline passes, else returns each rank's {name: outputs}.
* ``world1_group(tmp_path)``: a gloo group of this process alone, for the
  world-size-1 cases, destroyed on the way out.

This module imports neither JAX nor ``turbojax``: the tests compute the
JAX references in their own process and hand the ranks the inputs and
JAX's draws.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.tensor(np.asarray(a))


def _rows(a, mesh):
    rows = a.shape[0] // mesh.size
    return _t(a[mesh.rank * rows:(mesh.rank + 1) * rows])


def _params(p):
    from turbojax_torch.gp import GPParams

    return GPParams(*(_t(a) for a in p))


# --------------------------------------------------------------------------
# distributed_linalg


def linalg(mesh, k, b, k_cross, k_diag, alpha, panel):
    from turbojax_torch import distributed_linalg as DL
    from turbojax_torch.parallel import gather_rows

    l_loc = DL.distributed_cholesky(_rows(k, mesh), mesh, panel)
    b_loc = _rows(b, mesh)
    mu, var = DL.distributed_gp_posterior(l_loc, _rows(alpha, mesh), _rows(k_cross, mesh), _t(k_diag), mesh, panel,
                                          mean=0.25)
    return {
        "chol": _np(gather_rows(l_loc, mesh)),
        "solve_lower": _np(gather_rows(DL.distributed_solve_lower(l_loc, b_loc, mesh, panel), mesh)),
        "solve_upper_t": _np(gather_rows(DL.distributed_solve_upper_t(l_loc, b_loc, mesh, panel), mesh)),
        "cho_solve": _np(gather_rows(DL.distributed_cho_solve(l_loc, b_loc, mesh, panel), mesh)),
        "logdet": _np(DL.distributed_logdet_from_chol(l_loc, mesh)),
        "mu": _np(mu), "var": _np(var),
    }


def kernel_chol(mesh, x, params, jitter, kernel, panel):
    from turbojax_torch import distributed_linalg as DL
    from turbojax_torch.parallel import gather_rows

    p = {k: _t(v) for k, v in params.items()}
    return {"chol": _np(gather_rows(DL.distributed_kernel_chol(p, _t(x), mesh, panel, kernel, jitter=jitter), mesh))}


def mll(mesh, raw, x, y_std, config, panel):
    from turbojax_torch import distributed_linalg as DL
    from turbojax_torch.gp import GPParams

    leaves = [a.requires_grad_(True) for a in _params(raw)]
    xt, yt = _t(x).requires_grad_(True), _t(y_std).requires_grad_(True)
    val = DL.distributed_mll(GPParams(*leaves), xt, yt, mesh, config, panel)
    grads = torch.autograd.grad(val, leaves + [xt, yt])
    out = {"value": _np(val)}
    out.update({f"grad_{name}": _np(g) for name, g in zip(GPParams._fields, grads)})
    out["grad_x"], out["grad_y_std"] = _np(grads[-2]), _np(grads[-1])
    return out


def fit(mesh, x, y, config, panel, steps, xs):
    from turbojax_torch import distributed_linalg as DL

    dgp = DL.fit_distributed_gp(_t(x), _t(y), mesh, config, panel, steps=steps)
    mu, var = dgp.posterior(_t(xs))
    out = {f"raw_{i}": _np(a) for i, a in enumerate(dgp.raw)}
    out.update(mu=_np(mu), var=_np(var), mll=_np(dgp.mll()))
    return out


def rescue(mesh, x, y, config, panel, steps, warm, xs):
    """Duplicated rows at extreme hypers in float32, from a warm start:
    finite hypers, factor and posterior."""
    from turbojax_torch import distributed_linalg as DL
    from turbojax_torch.gp import GPParams

    f32 = dict(dtype=torch.float32)
    warm = GPParams(*(_t(a).to(**f32) for a in warm))
    dgp = DL.fit_distributed_gp(_t(x).to(**f32), _t(y).to(**f32), mesh, config, panel, steps=steps, warm_start=warm)
    mu, var = dgp.posterior(_t(xs).to(**f32))
    return {"finite": np.asarray([bool(torch.isfinite(a).all()) for a in (*dgp.raw, dgp.chol, mu, var)])}


def pathwise(mesh, x, y, raw, config, panel, xs, n_paths, omega, b, w, eps):
    from turbojax_torch import acq as A
    from turbojax_torch import distributed_linalg as DL

    dgp = DL._assemble_distributed_gp(_t(x), _t(y), _params(raw), config, mesh, panel)
    draws = A.Draws(omega=_t(omega), b=_t(b), weights=_t(w), eps=_t(eps))
    paths = DL.distributed_pathwise_paths(dgp, _t(xs), n_paths, omega.shape[0], draws=draws)
    mu, var = dgp.posterior(_t(xs))
    return {"paths": _np(paths), "mu": _np(mu), "var": _np(var), "mll": _np(dgp.mll())}


def route(mesh, x, y, config, panel):
    """The route ``fit_gp_auto`` and ``refactor_gp_auto`` take with
    ``budget_bytes=1`` and with the default budget."""
    from turbojax_torch import distributed_linalg as DL

    xt, yt = _t(x), _t(y)
    fitted = DL.fit_gp_auto(xt, yt, config, mesh, panel, budget_bytes=1)
    refac = DL.refactor_gp_auto(xt, yt, fitted.raw, config, mesh, panel, budget_bytes=1)
    dense = DL.fit_gp_auto(xt, yt, config, mesh, panel, generator=torch.Generator().manual_seed(0))
    kinds = [isinstance(g, DL.DistributedGP) for g in (fitted, refac, dense)]
    return {"distributed": np.asarray(kinds), "mll": _np(refac.mll())}


def padded(mesh, x, y, y_std, raw, config, panel, xs, omega, b, w, eps):
    """The GP level at any N (the padded layout): the factor, α, the
    posterior, the MLL and the distributed MLL's gradient in raw, x and
    y_std, pathwise draws with injected draws; the factor and α gathered
    whole in global row order, padding included."""
    from turbojax_torch import acq as A
    from turbojax_torch import distributed_linalg as DL
    from turbojax_torch.gp import GPParams

    dgp = DL._assemble_distributed_gp(_t(x), _t(y), _params(raw), config, mesh, panel)
    mu, var = dgp.posterior(_t(xs))
    draws = A.Draws(omega=_t(omega), b=_t(b), weights=_t(w), eps=_t(eps))
    paths = DL.distributed_pathwise_paths(dgp, _t(xs), w.shape[0], omega.shape[0], draws=draws)
    leaves = [a.requires_grad_(True) for a in _params(raw)]
    xt, yt = _t(x).requires_grad_(True), _t(y_std).requires_grad_(True)
    val = DL.distributed_mll(GPParams(*leaves), xt, yt, mesh, config, panel)
    grads = torch.autograd.grad(val, leaves + [xt, yt])
    out = {"chol": _np(dgp.layout.gather(dgp.chol, mesh)), "alpha": _np(dgp.layout.gather(dgp.alpha, mesh)[:, 0]),
           "n_pad": np.asarray(dgp.layout.n_pad), "blocks": np.asarray(len(dgp.layout.mine)), "mu": _np(mu), "var": _np(var), "mll": _np(dgp.mll()),
           "paths": _np(paths), "value": _np(val), "grad_x": _np(grads[-2]), "grad_y_std": _np(grads[-1])}
    out.update({f"grad_{name}": _np(g) for name, g in zip(GPParams._fields, grads)})
    return out


def balanced(mesh, **kwargs):
    """``padded`` on the GP level's layout (its blocks dealt out), then on
    one block a rank (``_BLOCKS_PER_RANK`` set to 1 for the call), with
    the second's outputs under "contiguous_<name>"."""
    from turbojax_torch import distributed_linalg as DL

    out = padded(mesh, **kwargs)
    saved, DL._BLOCKS_PER_RANK = DL._BLOCKS_PER_RANK, 1
    try:
        out.update({f"contiguous_{k}": v for k, v in padded(mesh, **kwargs).items()})
    finally:
        DL._BLOCKS_PER_RANK = saved
    return out


def factor_spans(mesh, x, y, raw, config, panel):
    """The spans one ``DistributedGP`` factorization records: their counts
    by name and whether each lies inside the one it belongs to."""
    from torch.profiler import ProfilerActivity, profile

    from turbojax_torch import distributed_linalg as DL

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        DL._assemble_distributed_gp(_t(x), _t(y), _params(raw), config, mesh, panel)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU and e.is_user_annotation]

    def inside(inner, outer):
        outers = [s for s in spans if s[0] == outer]
        return all(any(o[1] <= s[1] and s[2] <= o[2] for o in outers) for s in spans if s[0] == inner)

    names = ("dlinalg.factor", "linalg.cholesky_ladder", "linalg.cholesky_rung", "sync.dlinalg.ladder")
    out = {name: np.asarray(sum(1 for s in spans if s[0] == name)) for name in names}
    out["nested"] = np.asarray([inside("linalg.cholesky_ladder", "dlinalg.factor"),
                                inside("linalg.cholesky_rung", "linalg.cholesky_ladder"),
                                inside("sync.dlinalg.ladder", "linalg.cholesky_ladder")])
    return out


# --------------------------------------------------------------------------
# parallel


def _state(x, y, raw, config):
    from turbojax_torch import gp as G

    n = x.shape[0]
    return G.make_gp_state(_t(x), _t(y), torch.ones(n, dtype=torch.bool), _params(raw), config)


def acq_topq(mesh, x, y, raw, config, cands, q, acq, best):
    from turbojax_torch import parallel as PAR

    pts, scores = PAR.sharded_acq_topq(_state(x, y, raw, config), _rows(cands, mesh), _t(best), q, mesh, config,
                                       acq=acq, kappa=2.0, xi=0.01)
    return {"points": _np(pts), "scores": _np(scores)}


def thompson(mesh, x, y, raw, config, cands, q, normals):
    from turbojax_torch import parallel as PAR

    pts, vals = PAR.sharded_thompson_select(_state(x, y, raw, config), _rows(cands, mesh), q, mesh, config,
                                            normals=_t(normals[mesh.rank]))
    return {"points": _np(pts), "values": _np(vals)}


def sharded_fit(mesh, x, y, config, uniforms):
    from turbojax_torch import parallel as PAR

    n = x.shape[0]
    state = PAR.sharded_fit_gp(_t(x), _t(y), torch.ones(n, dtype=torch.bool), config, mesh,
                               restart_uniforms=_t(uniforms))
    return {f"raw_{i}": _np(a) for i, a in enumerate(state.raw)}


def _slice_tree(tree, idx):
    """A NamedTuple of numpy leaves (nested NamedTuples too) cut along its
    leading axis."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_slice_tree(f, idx) for f in tree))
    return np.asarray(tree)[idx]


def _turbom_fn(x):
    """The step's objective: 50 above a quadratic (no region improves), the
    second point a failure."""
    y = torch.sum((x - 0.3) ** 2, dim=-1) + 50.0
    y[1] = torch.nan
    return y


def turbom_step(mesh, carries, cfg, config, draws, restart_streams, n_cand, fail_tol):
    from turbojax_torch import acq as A
    from turbojax_torch import convert as C
    from turbojax_torch import parallel as PAR
    from turbojax_torch import turbo_m as TM

    m = len(carries.n)
    m_loc = m // mesh.size
    mine = slice(mesh.rank * m_loc, (mesh.rank + 1) * m_loc)
    local = C.turbo_carry_from_numpy(_slice_tree(carries, mine))
    tm_draws = [TM.Draws(cands=_t(d["cands"]), forcing=_t(d["forcing"]),
                         sampler=A.Draws(normals=None if d.get("normals") is None else _t(d["normals"])))
                for d in draws[mine]]
    dim = carries.x_buf.shape[-1]
    lb, ub = torch.zeros(dim, dtype=torch.float64), torch.ones(dim, dtype=torch.float64)
    out, best, tr_idx, cand_idx = PAR.sharded_turbom_step(local, _turbom_fn, lb, ub, cfg, config, mesh, n_cand,
                                                          fail_tol, draws=tm_draws,
                                                          restart_streams=_t(restart_streams[mine]))
    whole = C.turbo_carry_to_numpy(PAR.gather_carries(out, mesh))
    res = {"best": _np(best), "tr_idx": np.asarray(tr_idx), "cand_idx": np.asarray(cand_idx), "n": np.asarray(whole.n)}
    for name in ("x_buf", "y_buf", "best_x", "best_y", "init_stream"):
        res[name] = np.asarray(getattr(whole, name))
    for name in whole.tr._fields:
        res[f"tr_{name}"] = np.asarray(getattr(whole.tr, name))
    for name in whole.raw._fields:
        res[f"raw_{name}"] = np.asarray(getattr(whole.raw, name))
    return res


def _quad(x):
    return torch.sum((x - 0.3) ** 2, dim=-1)


def bo_loop(mesh, bo, config, x_init, sobol, budget_bytes):
    """``run_bo_distributed`` on the mesh, JAX's initial design and Sobol
    candidates replayed; the routes from its run log."""
    from turbojax_torch import bo_distributed as BD
    from turbojax_torch.runlog import RunLog

    f64 = torch.float64
    log = RunLog()
    dim = x_init.shape[1]
    res = BD.run_bo_distributed(_quad, [0.0] * dim, [1.0] * dim, bo, config, mesh, budget_bytes=budget_bytes,
                                runlog=log, generator=torch.Generator().manual_seed(0), dtype=f64,
                                x_init=_t(x_init).to(f64),
                                draws=lambda it: BD.IterationDraws(sobol=_t(sobol[it]).to(f64)))
    return {"x_hist": _np(res.x_hist), "y_hist": _np(res.y_hist), "trace": _np(res.incumbent_trace),
            "distributed": np.asarray([r["route"] == "distributed" for r in log.records])}


def optimize_runs(mesh, tmp_dir):
    """``optimize(mesh=)`` with plain BO (the distributed route forced, then
    the candidate axis sharded) and with TuRBO-m, each checked in the
    test; and a checkpointed BO run resumed."""
    from turbojax_torch import benchmarks as B
    from turbojax_torch import optimize
    from turbojax_torch.config import GPConfig

    b = B.get_benchmark("branin")
    gcfg = GPConfig(fit_optimizer="adam", fit_maxiter=5, fit_restarts=2)
    kw = dict(mesh=mesh, device="cpu", gp_config=gcfg)
    out = {}
    bo = optimize(b.fn, b.lb, b.ub, 16, method="bo", n_init=8, batch_size=2, acq="ei", n_candidates=64,
                  budget_bytes=1, **kw)
    tm = optimize(b.fn, b.lb, b.ub, 24, method="turbom", m=2, n_init=4, batch_size=2, n_candidates=32, **kw)
    ts = optimize(b.fn, b.lb, b.ub, 12, method="bo", n_init=8, batch_size=2, acq="ts", n_candidates=64,
                  budget_bytes=1, **kw)
    path = os.path.join(tmp_dir, "bo_mesh.ckpt")
    ck = dict(method="bo", n_init=8, batch_size=2, n_candidates=64, budget_bytes=1, checkpoint_path=path,
              checkpoint_every=1, **kw)
    first = optimize(b.fn, b.lb, b.ub, 12, **ck)
    again = optimize(b.fn, b.lb, b.ub, 12, resume=True, **ck)
    for label, res in (("bo", bo), ("turbom", tm), ("ts", ts), ("ckpt", first), ("resumed", again)):
        out[f"{label}_y_hist"] = np.asarray(res.y_hist)
        out[f"{label}_trace"] = np.asarray(res.incumbent_trace)
        out[f"{label}_best_y"] = np.asarray(res.best_y)
        out[f"{label}_best_x"] = np.asarray(res.best_x)
    return out


CASES = {f.__name__: f for f in (linalg, kernel_chol, mll, fit, rescue, pathwise, route, padded, balanced,
                                 factor_spans, acq_topq, thompson, sharded_fit, turbom_step, bo_loop, optimize_runs)}


def run_jobs(jobs, mesh):
    return {name: CASES[case](mesh, **kwargs) for name, case, kwargs in jobs}


def same_on_every_rank(ranks, case):
    """Rank 0's outputs of ``case``, after checking that every rank returned
    the same (replicated, or gathered whole)."""
    for r, out in enumerate(ranks[1:], start=1):
        for k, v in ranks[0][case].items():
            np.testing.assert_array_equal(out[case][k], v, err_msg=f"rank {r} differs from rank 0: {case}.{k}")
    return ranks[0][case]


# --------------------------------------------------------------------------
# Process groups


@contextlib.contextmanager
def world1_group(tmp_path):
    """A gloo process group of this process alone, on a ``FileStore`` in
    ``tmp_path``; yields its mesh and destroys the group on the way out."""
    from turbojax_torch import parallel as PAR

    store = dist.FileStore(os.path.join(str(tmp_path), "world1_store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1, timeout=GROUP_TIMEOUT)
    try:
        yield PAR.make_mesh(axis="rows")
    finally:
        dist.destroy_process_group()


class Spawned:
    """A group of ``world`` ranks running ``jobs`` in the background, started
    on construction; ``wait()`` returns each rank's {name: outputs}. Fails
    when a rank fails or the deadline passes (counted from the start), with
    the ranks' output, and kills the ranks still running."""

    def __init__(self, world: int, jobs, tmp_path, deadline_s: float = 150.0):
        self.world = world
        self.work = os.path.join(str(tmp_path), f"world{world}")
        os.makedirs(self.work, exist_ok=True)
        with open(os.path.join(self.work, "jobs.pkl"), "wb") as f:
            pickle.dump(jobs, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([_REPO, os.environ.get("PYTHONPATH", "")]),
                   OMP_NUM_THREADS="1")
        self.deadline_s = deadline_s
        self.end = time.monotonic() + deadline_s
        self.procs = []
        for rank in range(world):
            with open(os.path.join(self.work, f"rank{rank}.log"), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), self.work, str(rank), str(world)],
                    stdout=log, stderr=subprocess.STDOUT, env=env))

    def wait(self):
        try:
            while any(p.poll() is None for p in self.procs):
                if any(p.returncode not in (None, 0) for p in self.procs) or time.monotonic() > self.end:
                    break
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in self.procs]
        if any(codes):
            logs = []
            for rank, code in enumerate(codes):
                with open(os.path.join(self.work, f"rank{rank}.log")) as f:
                    logs.append(f"--- rank {rank} (exit {code}) ---\n{f.read()[-4000:]}")
            raise AssertionError(f"the world-{self.world} group failed or passed its {self.deadline_s} s deadline\n"
                                 + "\n".join(logs))
        outs = []
        for rank in range(self.world):
            with open(os.path.join(self.work, f"out{rank}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs


def _main(work: str, rank: int, world: int) -> int:
    torch.set_num_threads(1)
    from turbojax_torch import parallel as PAR

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), world), rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    try:
        with open(os.path.join(work, "jobs.pkl"), "rb") as f:
            jobs = pickle.load(f)
        out = run_jobs(jobs, PAR.make_mesh(axis="rows"))
        with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except Exception:
        traceback.print_exc()
        return 1
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
