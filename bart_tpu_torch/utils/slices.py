"""Launches of the fused kernels on bin-aligned slices of their tables,
and random tables of any size made on the card: the check that a launch
past the card's old ceilings (a table of 2^31 elements or more, a fine
axis past the 65,535 tiles a grid's y extent holds) reads and writes the
right places.

Each output bin of the four kernels depends only on the table's columns
of its own (fine) points and on the per-chain inputs, and every sum
inside a bin runs in an order set by the bin's place in its tile (the
sub-samples of a tile in fine-point order, a cut bin's partial sums in
tile order).  A slice whose first fine point starts a tile of the whole
launch keeps every bin's place in its tiles, so a launch on such slices,
each under both old ceilings, gives each bin the bits of the whole
launch: an offset past 2^31 or a tile past 65,535 that read the wrong
place would show as a difference.  ``chip_smoke.py --ceilings`` and the
card tests (tests/test_torch_k1_mma.py, tests/test_torch_folded.py) use
these helpers.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from bart_tpu_torch.rt import fused

__all__ = ["TILE", "OLD_MAX_TILES", "OLD_MAX_ELEMS", "slice_edges",
           "table_slice", "launch_by_slices", "random_table", "Problem",
           "problem"]

#: fine points a tile of each wrapper's kernel
TILE = {"fused_eclipse": fused._TILE_W,
        "fused_eclipse_folded": fused._F_MTILE_F,
        "fused_transit": fused._FT_W, "fused_transit_folded": fused._FT_W}
#: the tiles a grid's y extent holds: the fine axis's old ceiling
OLD_MAX_TILES = 65535
#: the table's old ceiling, in elements
OLD_MAX_ELEMS = 2**31


def slice_edges(W: int, K: int, tile: int, per_row: int) -> list[int]:
    """Bin edges [0, b_1, ..., W] of the fewest equal-ish slices of W
    bins (K fine points each) whose tables stay under both old ceilings:
    fewer than 2^31 elements (``per_row``: elements a fine point, the
    table's rows x layers) and at most 65,535 tiles of ``tile`` points.
    Every inner edge starts a tile of the whole launch: a multiple of
    tile / gcd(tile, K) bins."""
    align = tile // math.gcd(tile, K)
    F = W * K
    pieces = max(-(-F * per_row // (OLD_MAX_ELEMS - 1)),
                 -(-F // (tile * OLD_MAX_TILES)), 1)
    while True:
        if pieces > -(-W // align):       # an inner edge a whole tile
            raise ValueError(f"slice_edges: {W} bins do not cut into "
                             f"{pieces} slices of whole tiles")
        edges = [0] + [j * W // pieces // align * align
                       for j in range(1, pieces)] + [W]
        sizes = [(b - a) * K for a, b in zip(edges, edges[1:])]
        if (min(sizes) > 0 and max(sizes) * per_row < OLD_MAX_ELEMS
                and max(-(-s // tile) for s in sizes) <= OLD_MAX_TILES):
            return edges
        pieces += 1


def table_slice(tab, b0: int, b1: int):
    """Output bins b0 .. b1 - 1 of a RowsTable or FoldedTable as a table
    of the same kind (a copy, in the kernels' layout)."""
    if isinstance(tab, fused.RowsTable):
        return fused.rows_table(tab.tab[..., b0:b1])
    return fused.folded_table(tab.tab[..., b0 * tab.K:b1 * tab.K], tab.K)


def launch_by_slices(launch, tab, edges: list[int]) -> torch.Tensor:
    """torch.cat over the slices of ``launch(table_slice(tab, b0, b1), b0,
    b1)`` (each [C, b1 - b0]) along the bin axis: what the whole launch
    must equal bit for bit.  Each slice's table is freed before the next
    is made."""
    outs = []
    for b0, b1 in zip(edges, edges[1:]):
        part = table_slice(tab, b0, b1)
        outs.append(launch(part, b0, b1))
        del part
    return torch.cat(outs, dim=1)


def random_table(shape, dtype: torch.dtype, seed: int,
                 device: torch.device) -> torch.Tensor:
    """[R, L, F] of lognormal(-46, 2) elements (demo.random_rows'
    distribution) in ``dtype``, made on ``device`` a few rows at a time
    from a generator seeded with ``seed``: a table of any size, without
    a host copy."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tab = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, 2**28 // (shape[1] * shape[2]))
    for r0 in range(0, shape[0], step):
        rows = tab[r0:r0 + step]
        chunk = torch.empty(rows.shape, dtype=torch.float32, device=device)
        chunk.log_normal_(-46.0, 2.0, generator=gen)
        rows.copy_(chunk)
    return tab


@dataclasses.dataclass
class Problem:
    """A random problem for one wrapper at any size: ``tab`` its table (a
    RowsTable or FoldedTable over ``raw`` [R, L, W K]), ``inputs`` the
    other tensors (for the bound's bytes), ``launch(t, b0, b1, n)`` the
    wrapper on table ``t`` (the whole table or table_slice(tab, b0, b1))
    for bins b0 .. b1 - 1 and the first ``n`` chains, ``plain`` the same
    through the plain version (slant G as given, not prepared)."""

    tab: object
    raw: torch.Tensor
    inputs: tuple
    launch: object
    plain: object


def problem(name: str, R: int, L: int, W: int, K: int, C: int,
            dtype: torch.dtype, seed: int, device: torch.device) -> Problem:
    """A random problem for the wrapper ``name`` (K = 1 for the K = 1
    pair): the table by random_table; per-chain inputs as
    demo.random_rows makes them (eclipse, expsum quadrature, the weights
    scaled by 27 / R so that tau crosses unity inside the atmosphere at
    any R) or demo.random_transit_rows (transit: weights scaled so that
    the median slant tau of the middle impact parameter is 1)."""
    from bart_tpu_torch.demo import random_rows, random_transit_rows
    from bart_tpu_torch.rt.eclipse import expsum_weights

    f32 = dict(dtype=torch.float32, device=device)
    raw = random_table((R, L, W * K), dtype, seed, device)
    tab = fused.FoldedTable(raw, K, W) if K > 1 else fused.RowsTable(raw, W)
    if name.startswith("fused_transit"):
        _, wrows, G, wgt, _ = (torch.tensor(a, **f32) for a in
                               random_transit_rows(R, L, 64, C, seed=7))
        Gp = fused.prepare_slant(G)

        def launch(t, b0, b1, n=C):
            args = (wrows[:n], Gp if n == C else G[:n], wgt[:n])
            return (fused.fused_transit_folded(t, *args) if K > 1
                    else fused.fused_transit(t, *args))

        def plain(t, b0, b1, n=C):
            args = (wrows[:n], G[:n], wgt[:n])
            return (fused.transit_folded_plain(t, *args) if K > 1
                    else fused.transit_plain(t.plain(), *args))
        return Problem(tab, raw, (wrows, G, wgt), launch, plain)
    _, _, wrows, T, drp = (torch.tensor(a, **f32) for a in
                           random_rows(R, L, 1, C, seed=7))
    wrows *= 27.0 / R
    wn = torch.linspace(2500.0, 5000.0, W, **f32)
    mu, muw = (torch.tensor(a, **f32) for a in expsum_weights(8))

    def args(b0, b1, n):
        return (wn[b0:b1], mu, muw, wrows[:n], T[:n], drp[:n], True)

    def launch(t, b0, b1, n=C):
        return (fused.fused_eclipse_folded(t, *args(b0, b1, n)) if K > 1
                else fused.fused_eclipse(t, *args(b0, b1, n)))

    def plain(t, b0, b1, n=C):
        return (fused.eclipse_folded_plain(t, *args(b0, b1, n)) if K > 1
                else fused.eclipse_plain(t.plain(), *args(b0, b1, n)))
    return Problem(tab, raw, (wn, mu, muw, wrows, T, drp), launch, plain)
