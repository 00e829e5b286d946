"""How an answer of the program is judged against the reference's values.

An answer is the q points of one batch. Each must be one of the batch's
candidates (a point that is none of them is an altered answer), and row j
of the sampler picks, among the candidates no earlier row took, the one
with the lowest value. The reference computes every row's values over the
candidates from the same inputs and draws.

The picks alone rarely tell a sound program from one that computes in a
lower precision: a rounding error moves a pick only where two candidates
nearly tie. So the values the program's sampler handed to its selection are
judged, by their **value gap**: the widest distance between the program's
value and the reference's, over every row and candidate, in units of that
row's spread (standard deviation across the candidates). And the picks are
held to those values exactly: a **pick mismatch** is a row whose pick is
not the lowest of the program's own values among the candidates still free
(or no candidate at all). Values within the value gap's limit and picks
that follow them make answers within twice that limit of the reference's
best."""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

#: A point lies on a candidate when it is this close in the unit cube: the
#: float32 round trip through the box moves it by ~1e-7.
MATCH_TOL = 1e-5


def match(points_unit: Tensor, cands: Tensor) -> Tensor:
    """The candidate index of each point, or −1 where none lies within
    ``MATCH_TOL``."""
    dist = torch.cdist(points_unit.to(torch.float64), cands.to(torch.float64))
    best, idx = dist.min(dim=1)
    return torch.where(best <= MATCH_TOL, idx, torch.full_like(idx, -1))


def value_gap(program: Tensor, reference: Tensor) -> float:
    """The widest |program − reference| over the rows' spreads; inf when
    the program's values are missing, of another shape or not finite."""
    if program is None or tuple(program.shape) != tuple(reference.shape):
        return math.inf
    diff = (program.to(reference.dtype) - reference).abs()
    spread = reference.std(dim=1, keepdim=True)
    worst = float((diff / spread).max())
    return worst if math.isfinite(worst) else math.inf


def pick_mismatch(program: Tensor, picks: Tensor) -> int:
    """Rows whose pick is not the lowest of the program's own values among
    the candidates no earlier row took (every row when the values are
    missing)."""
    q = picks.shape[0]
    if program is None:
        return q
    taken = torch.zeros(program.shape[1], dtype=torch.bool, device=program.device)
    bad = 0
    for j in range(q):
        i = int(picks[j])
        row = program[j]
        free = torch.where(taken | ~torch.isfinite(row), torch.full_like(row, math.inf), row)
        if i < 0 or bool(taken[i]) or not bool(free[i] == free.min()):
            bad += 1
        if i >= 0:
            taken[i] = True
    return bad


def numbers(per_batch) -> dict:
    """A run's numbers from each checked batch's: the widest value gap and
    the pick mismatches summed."""
    return {"value_gap": max((b["value_gap"] for b in per_batch), default=math.inf),
            "pick_mismatch": sum(b["pick_mismatch"] for b in per_batch),
            "checked": len(per_batch), "per_batch": per_batch}


def judge_batch(program_values, points_unit: Tensor, cands: Tensor, reference: Tensor) -> dict:
    """The value gap and the pick mismatches of one batch; the program's
    values and points may sit on another device than the reference's."""
    if program_values is not None:
        program_values = program_values.to(reference.device)
    picks = match(points_unit.to(cands.device), cands)
    return {"value_gap": value_gap(program_values, reference), "pick_mismatch": pick_mismatch(program_values, picks)}
