"""The control of ``correct``: the reference put in the program's place and
computed one precision below the configuration's (float32 with TF32
matmuls, where the configurations state float32 with TF32 off), on the
cell's own inputs and sizes; its answers are judged as the program's are.
It has to come out not correct.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--batches K]

prints one JSON line per seed with the judged numbers beside the cell's
limits. The benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import torch

from portbench import inputs as I
from portbench import manifest


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def run_control(cell: manifest.Cell, seed: int, count: int, device: str = "cuda") -> dict:
    """The cell's entry with the program's state released, its
    ``control_batches`` in float32 with TF32 matmuls, judged as the
    program's batches are."""
    inputs = I.Inputs(cell.config, seed, device, cell.root)
    entry = manifest.find("entries", cell.traffic["entry"], cell.root).Entry(cell.config, cell.traffic, inputs, device)
    entry.release()
    _tf32(True)
    try:
        batches = entry.control_batches(count)
    finally:
        _tf32(False)
    numbers = entry.judge(batches)
    return {"workload": cell.name, "seed": seed, "batches": len(batches), "limits": cell.limits,
            **{k: numbers[k] for k in ("value_gap", "pick_mismatch", "checked", "per_batch")}}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control runs on the card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    cell = manifest.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(run_control(cell, seed, args.batches)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
