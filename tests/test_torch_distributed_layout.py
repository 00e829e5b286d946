"""The row-sharded GP's layout (``distributed_linalg._layout``) on the CPU,
without a process group: the padding, the blocks of whole panels dealt out
in snake order, each rank's rows, its active rows first, the gather's
order, and the per-panel critical path of the trailing updates that the
layout exists to shorten."""

import pytest
import torch

from turbojax_torch import distributed_linalg as DL
from turbojax_torch.parallel import Mesh

torch.set_num_threads(1)

# (N, D, P): padded or not, fewer panels a rank than _BLOCKS_PER_RANK, and panels that do not divide evenly
SHAPES = [(30, 1, 4), (30, 2, 4), (30, 4, 4), (17, 2, 4), (17, 4, 4), (1000, 2, 128), (65536, 4, 128),
          (65546, 4, 128)]


def _mesh(size, rank):
    return Mesh(group=None, axis="rows", size=size, rank=rank, device=torch.device("cpu"))


def _layouts(n, size, panel):
    return [DL._layout(n, _mesh(size, r), panel) for r in range(size)]


def _critical_path(lay, size, panel):
    """Σ over panels of the slowest rank's trailing update, 2·P·(rows of a
    block below the panel)·(columns up to its last row) a block, in units
    of N_pad³/(3D): the time the panel loop takes when every panel waits
    for its slowest rank."""
    total = 0.0
    for c0 in range(0, lay.n_pad, panel):
        t0 = c0 + panel
        work = [0.0] * size
        for g0, g1, owner, _ in lay.blocks:
            if g1 > t0:
                work[owner] += 2.0 * panel * (g1 - max(g0, t0)) * (g1 - t0)
        total += max(work)
    return total / (lay.n_pad**3 / (3 * size))


@pytest.mark.parametrize("n,size,panel", SHAPES)
def test_blocks_of_whole_panels_partition_the_padded_rows(n, size, panel):
    """N_pad is the next multiple of D·P; the blocks, the same on every
    rank, cover [0, N_pad) in order in whole panels, widths within one
    panel of each other; each rank holds N_pad/D rows."""
    lays = _layouts(n, size, panel)
    n_pad = -(-n // (size * panel)) * size * panel
    ends = [0]
    for lay in lays:
        assert (lay.n, lay.n_pad, lay.rows) == (n, n_pad, n_pad // size)
        assert lay.blocks == lays[0].blocks
        assert sum(g1 - g0 for g0, g1, _ in lay.mine) == lay.rows
    for g0, g1, _, _ in lays[0].blocks:
        assert g0 == ends[-1] and (g1 - g0) % panel == 0 and g1 > g0
        ends.append(g1)
    assert ends[-1] == n_pad
    widths = [g1 - g0 for g0, g1, _, _ in lays[0].blocks]
    assert max(widths) - min(widths) <= panel


@pytest.mark.parametrize("n,size,panel", SHAPES)
def test_blocks_are_dealt_in_snake_order(n, size, panel):
    """s blocks a rank (1 on D = 1, else ``_BLOCKS_PER_RANK`` or the panels
    a rank holds, if fewer); round k gives ranks 0…D−1 a block (k even) or
    D−1…0 (k odd); each rank stores its blocks one after another in global
    order."""
    lays = _layouts(n, size, panel)
    per_rank = lays[0].rows // panel
    s = 1 if size == 1 else min(DL._BLOCKS_PER_RANK, per_rank)
    owners = [owner for _, _, owner, _ in lays[0].blocks]
    snake = [i if k % 2 == 0 else size - 1 - i for k in range(s) for i in range(size)]
    assert owners == snake
    assert (lays[0].order is None) == (s == 1)
    for rank, lay in enumerate(lays):
        assert len(lay.mine) == s
        local = 0
        for (g0, g1, l0), (b0, b1, owner, on_owner) in zip(lay.mine, [b for b in lay.blocks if b[2] == rank]):
            assert (g0, g1, l0) == (b0, b1, on_owner) and l0 == local
            local += g1 - g0
        assert lay.index.tolist() == [g for g0, g1, _ in lay.mine for g in range(g0, g1)]


@pytest.mark.parametrize("n,size,panel", SHAPES)
def test_padded_rows_are_the_last_global_rows_and_each_ranks_last_rows(n, size, panel):
    """A rank's active rows (global row < N) come first in its storage, the
    padded ones after them; the gather's order puts the ranks' rows,
    stacked in rank order, back in global order."""
    lays = _layouts(n, size, panel)
    for lay in lays:
        assert (lay.index[:lay.active] < n).all() and (lay.index[lay.active:] >= n).all()
    assert sum(lay.active for lay in lays) == n
    stacked = torch.cat([lay.index for lay in lays])
    order = lays[0].order if lays[0].order is not None else torch.arange(lays[0].n_pad)
    assert stacked[order].tolist() == list(range(lays[0].n_pad))


def test_the_primitives_layout_is_one_block_a_rank():
    """``contiguous``: rank r owns rows [r·N/D, (r+1)·N/D), as the sharded
    primitives' contract says."""
    for rank in range(4):
        lay = DL._layout(66048, _mesh(4, rank), 128, contiguous=True)
        assert lay.mine == ((rank * 16512, (rank + 1) * 16512, 0),) and lay.order is None


@pytest.mark.parametrize("n", [65536, 66048])
def test_the_dealt_layout_balances_the_trailing_updates(n):
    """At D = 4, P = 128: the slowest rank's updates summed over the panels
    come to ≤ 1.10 × N³/(3D), where one block a rank gives the last rank
    2.93 × (its rows lie below every panel)."""
    lay = DL._layout(n, _mesh(4, 0), 128)
    assert _critical_path(lay, 4, 128) <= 1.10
    contiguous = DL._layout(n, _mesh(4, 0), 128, contiguous=True)
    assert 2.92 <= _critical_path(contiguous, 4, 128) <= 2.94
