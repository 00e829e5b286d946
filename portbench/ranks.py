"""A cell on D > 1 cards runs as D processes, one per card, joined in one
process group (NCCL on the card, gloo on the CPU), so that
``turbojax_torch.parallel.make_mesh()`` works unchanged inside an entry:

    rank 0: the command's process, cuda:0     ranks 1..D-1: python -m portbench.ranks
    start ranks 1..D-1
    group, set-up                             group, set-up
    barrier --------------------------------- barrier
    window (stop: harness.window_over) ------ window
    gather the readings --------------------- its reading to rank 0
    destroy the group                         release, destroy the group, exit
    wait for every exit code
    the result, the judgement

Rank 0 runs ``run.run_cell`` with a ``Ranks``. Every rank builds the same
inputs from the seed on its own card and the same entry; the entry decides
what each rank does. ``setup_s`` is rank 0's clock from process start, the
ranks' start and the group included. A thread of rank 0 watches the
others: a rank that exits non-zero, or a stage not passed within its
limit, ends every rank and the run with a result that is not correct
(exit 0), or with exit 3 where a rank's import guard stopped it."""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, List, NoReturn, Optional

from portbench import guard, manifest
from portbench import run as RUN

#: The limit on set-up, from the ranks' start to the barrier before the
#: window: a checkout's first run may take 1200 s in all, most of it the
#: kernels' build; this leaves the window and the judgement the rest.
SETUP_LIMIT_S = 1080.0
#: The limit past ``--seconds`` by which every rank has ended its window
#: and exited: the window ends at the first batch boundary after
#: ``--seconds`` (one batch: ~1 s at N = 16384 with a refit, some seconds on
#: a mesh at N = 65536), then each rank stops its profiler, reduces a traced
#: window's events and tears down its group (tens of seconds for a traced
#: 30 s window). A hung rank is ended this long after the window's end, well
#: inside a run's 360 s.
WINDOW_MARGIN_S = 150.0
_POLL_S = 0.1
#: How long rank 0, when it raised, lets the others exit on their own
#: before it ends them: a rank that failed first breaks rank 0's
#: collective, and its own exit code names it.
_GRACE_S = 2.0
_LOG_TAIL = 4000  # characters of a rank's output that rank 0 passes on


def rank_device(device: str, local_rank: int):
    import torch

    return torch.device("cuda", local_rank) if torch.device(device).type == "cuda" else torch.device("cpu")


def join(device, rank: int, world: int) -> None:
    """Join the group of ``world`` ranks at ``MASTER_ADDR:MASTER_PORT``."""
    import torch
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=SETUP_LIMIT_S))


def barrier(device) -> None:
    import torch.distributed as dist

    if device.type == "cuda":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """Rank 0's hold on ranks 1…D−1: it starts them, watches them from a
    thread against the current stage's deadline, and on the first failure
    ends them all and the run (``fail``)."""

    def __init__(self, world: int, args, device: str, root: str):
        import torch

        self.world, self.device = world, rank_device(device, 0)
        self.dir = tempfile.mkdtemp(prefix="portbench-ranks-")  # the ranks' logs
        group = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "WORLD_SIZE": str(world)}
        os.environ.update(group, RANK="0", LOCAL_RANK="0")
        env = dict(os.environ, **group, PYTHONUNBUFFERED="1",
                   PYTHONPATH=os.pathsep.join(p for p in (manifest.ROOT, os.environ.get("PYTHONPATH")) if p))
        self.children: Dict[int, subprocess.Popen] = {}
        for r in range(1, world):
            cmd = [sys.executable, "-m", "portbench.ranks", "--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", repr(args.seconds), "--trace", str(args.trace), "--device", device, "--root", root]
            with open(self._log(r), "wb") as log:
                self.children[r] = subprocess.Popen(cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                                                    stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT,
                                                    start_new_session=True)
        self.kind = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        self.attempted = 0  # rank 0's batches, once its window has ended
        self._lock = threading.Lock()
        self._stage = ("set-up", time.monotonic() + SETUP_LIMIT_S)  # the stage the watch holds to its limit
        self._watching = True
        threading.Thread(target=self._watch, name="portbench-ranks", daemon=True).start()

    def _log(self, rank: int) -> str:
        return os.path.join(self.dir, f"rank{rank}.log")

    def _watch(self) -> None:
        while self._watching:
            for r, p in self.children.items():
                code = p.poll()
                if code not in (None, 0):
                    self.fail(f"rank {r} exited with code {code}", guard_stopped=code == 3)
            name, deadline = self._stage
            if time.monotonic() > deadline:
                running = [r for r, p in self.children.items() if p.poll() is None]
                self.fail(f"the {name} did not end on every rank within its limit; ranks still running: {running}")
            time.sleep(_POLL_S)

    def _kill(self) -> Dict[int, Optional[int]]:
        """End every rank (and what it started); each one's exit code from
        before, None where it was still running."""
        codes = {r: p.poll() for r, p in self.children.items()}
        for p in self.children.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        return codes

    def _tail(self, rank: int) -> str:
        try:
            with open(self._log(rank), "rb") as f:
                return f.read().decode(errors="replace")[-_LOG_TAIL:]
        except OSError:
            return ""

    def fail(self, reason: str, rank0_failed: bool = False, guard_stopped: bool = False) -> NoReturn:
        """End every rank, pass on each one's output and exit code, then end
        this process: with exit 3 and no result where a rank's import guard
        stopped it, else with a result that is not correct (``failed`` =
        ``attempted``)."""
        with self._lock:  # the first failure ends the run; a second caller waits here for the exit
            end = time.monotonic() + (_GRACE_S if rank0_failed else 0.0)
            while time.monotonic() < end and all(p.poll() in (None, 0) for p in self.children.values()):
                time.sleep(_POLL_S)
            codes = self._kill()
            for r in sorted(codes):
                tail = self._tail(r)
                print(f"portbench: rank {r} exit code {'running, killed' if codes[r] is None else codes[r]}"
                      + (f"; its output ends:\n{tail}" if tail else ""), file=sys.stderr)
            print(f"portbench: {reason}", file=sys.stderr)
            guard_stopped = guard_stopped or 3 in codes.values()
            if not guard_stopped:
                failed = sum(1 for c in codes.values() if c not in (None, 0)) + int(rank0_failed)
                check = {"value": max(failed, 1), "limit": 0}
                result = {"correct": False, "attempted": self.attempted, "failed": self.attempted, "metrics": {},
                          "device": {"platform": "gpu" if self.device.type == "cuda" else "cpu", "kind": self.kind,
                                     "count": self.world,
                                     "memory_peak_bytes": int(RUN.memory_reading(self.device.type == "cuda"))},
                          "checks": {"ranks_failed": check}}
                print(f"portbench check ranks_failed {check['value']!r} limit 0", file=sys.stderr)
                print(json.dumps(result), flush=True)
            sys.stderr.flush()
            shutil.rmtree(self.dir, ignore_errors=True)
            os._exit(3 if guard_stopped else 0)

    def join(self) -> None:
        join(self.device, 0, self.world)

    def window_starts(self, seconds: float) -> None:
        """Meet every rank once all have warmed up; the window's limit
        starts here."""
        barrier(self.device)
        self._stage = ("window", time.monotonic() + seconds + WINDOW_MARGIN_S)

    def readings(self, mine: dict) -> List[dict]:
        """Every rank's reading in rank order, gathered before the group is
        torn down, once every rank has exited with code 0: a rank that
        exits otherwise ends the run (``fail``), also after its reading
        came. Each rank's output is passed on to standard error."""
        import torch.distributed as dist

        self.attempted = mine["batches"]
        out: List[Optional[dict]] = [None] * self.world
        dist.gather_object(mine, out, dst=0)
        # every rank tears its group down after the gather: NCCL's abort
        # has been collective in some versions, so none waits for another
        # that has already exited
        dist.destroy_process_group()
        while True:
            codes = {r: p.poll() for r, p in self.children.items()}
            for r, code in sorted(codes.items()):
                if code not in (None, 0):
                    self.fail(f"rank {r} exited with code {code}", guard_stopped=code == 3)
            if all(code == 0 for code in codes.values()):
                break
            time.sleep(_POLL_S)
        self._watching = False
        for r in sorted(self.children):
            tail = self._tail(r)
            if tail:
                print(f"portbench: rank {r} output ends:\n{tail}", file=sys.stderr)
        return out

    @staticmethod
    def checks(readings: List[dict]) -> Dict[str, dict]:
        """No rank failed (a failure ends the run before this), and every
        rank ended its window after the same batch."""
        seen = [r["batches"] for r in readings]
        return {"ranks_failed": {"value": 0, "limit": 0},
                "batch_spread": {"value": max(seen) - min(seen), "limit": 0}}

    def close(self) -> None:
        self._watching = False
        self._kill()
        shutil.rmtree(self.dir, ignore_errors=True)


def lead(cell: manifest.Cell, args, device: str, root: str, t0: float) -> dict:
    """Run ``cell`` on ``cell.chips`` ranks, this process rank 0; returns
    the result, or ends the process on a rank's failure (``Ranks.fail``)."""
    ranks = Ranks(cell.chips, args, device, root)
    try:
        return RUN.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t0, ranks=ranks)
    except SystemExit as e:  # rank 0's import guard
        ranks.fail(f"rank 0 stopped with exit code {e.code}", rank0_failed=True, guard_stopped=e.code == 3)
    except Exception:
        traceback.print_exc()
        ranks.fail("rank 0 raised", rank0_failed=True)
    finally:
        ranks.close()


def _exit_with(parent: int) -> None:
    """End this rank when rank 0 is gone (killed from outside): its
    collectives would wait for it for ever."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def follow(argv: Optional[List[str]] = None) -> int:
    """Rank r ≥ 1 (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` in the
    environment): set-up, the window, its reading gathered to rank 0,
    exit."""
    ap = RUN.arguments(argparse.ArgumentParser(description=__doc__,
                                               formatter_class=argparse.RawDescriptionHelpFormatter))
    ap.add_argument("--device", required=True)
    ap.add_argument("--root", required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    guard.check("before set-up")
    threading.Thread(target=_exit_with, args=(os.getppid(),), daemon=True).start()
    import torch.distributed as dist

    from portbench import trace as T

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cell = manifest.load_cell(args.workload, args.root)
    dev = rank_device(args.device, int(os.environ["LOCAL_RANK"]))
    join(dev, rank, world)
    entry = RUN.set_up(cell, args.seed, dev)
    barrier(dev)
    w = RUN.measure(entry, args.seconds, bool(args.trace), dev.type == "cuda", t0)
    guard.check("after the window")
    trace = T.collect(w.prof) if args.trace else None
    dist.gather_object(RUN.reading(rank, w, trace), None, dst=0)
    entry.release()
    dist.destroy_process_group()
    guard.check("before the result")
    return 0


def _main() -> NoReturn:
    """Exit without the interpreter's teardown, which may wait on a
    process group that a failed rank left behind; rank 0 reads the code."""
    try:
        code = follow()
    except SystemExit as e:  # the import guard's 3, or argparse's 2
        code = e.code if isinstance(e.code, int) else 1
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    _main()
