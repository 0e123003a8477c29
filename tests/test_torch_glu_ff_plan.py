"""The GLU feed-forward kernel's launch planner (tone_tpu_torch/ops/glu_ff.py
``plan_glu_ff``), on the CPU.

The CUDA kernel (csrc/glu_ff.cu) walks the plan with these formulas: block
(tile, slice) of the (tiles, split) grid computes rows (tile // col_tiles)
* BM .. + BM - 1 and columns (tile % col_tiles) * BN .. + BN - 1 of y (the
last row and column tiles clipped to M and D) over F rows slice * F / split
.. (slice + 1) * F / split - 1, BK at a time; a tile's slices form one
cluster, whose block of rank q then adds up the float4 vectors q * THREADS
+ t, q * THREADS + t + split * THREADS, ... (thread t) of the tile.  These
tests replay that walk at the main path's widths and the tiny test widths
and check that every output element, every F row and every vector of a
tile is handled exactly once, that the grid fills an H100 wherever it can,
and that the planner reads the header the kernel compiles.
"""

import re

import pytest

from tone_tpu_torch.ops import _build
from tone_tpu_torch.ops.glu_ff import PLAN_HEADER, kernel_constants, plan_glu_ff, tile_shape

C = kernel_constants()
H100_SMS = 132
# 8448: no split at F = 1536; 16640 and 33280: the bulk full-sequence forward
# of 16 utterances of 60 s (16 x 1040 reduced and 16 x 2080 full-rate rows);
# 5120, 6400, 10240 and 12800: the streaming step at B = 512 ... 1280 and the
# 1,024-slot tick (5 B reduced and 10 B full-rate rows)
MS = (1, 10, 37, 80, 160, 320, 640, 1280, 2560, 5120, 6400, 8448, 10240, 12800, 16640,
      33280)
WIDTHS = ((1536, 384), (128, 64), (256, 128))  # (F, D): the main path's, then the tiny tests'
SMEM_PER_BLOCK = 232448  # the most dynamic shared memory an H100 block may use


def _spans(count, tile, limit):
    """[start, end) of each tile along one axis, clipped to ``limit``."""
    return [(i * tile, min(limit, (i + 1) * tile)) for i in range(count)]


@pytest.mark.parametrize("f, d", WIDTHS)
@pytest.mark.parametrize("m", MS)
def test_every_output_and_depth_row_is_owned_once(m, f, d):
    plan = plan_glu_ff(m, f, d, H100_SMS)
    tiles, split = plan.grid
    assert tiles == plan.row_tiles * plan.col_tiles
    # Tiles are (row span) x (column span) products: every element is owned
    # once when each pair of spans is taken once and the spans of each axis
    # cut it into disjoint, non-empty, adjacent pieces.
    assert sorted(divmod(tile, plan.col_tiles) for tile in range(tiles)) == [
        (rt, ct) for rt in range(plan.row_tiles) for ct in range(plan.col_tiles)]
    for spans, limit in ((_spans(plan.row_tiles, plan.bm, m), m),
                         (_spans(plan.col_tiles, plan.bn, d), d)):
        assert spans[0][0] == 0 and spans[-1][1] == limit
        assert all(a < b for a, b in spans)
        assert all(s0[1] == s1[0] for s0, s1 in zip(spans, spans[1:]))
    depth = []
    for s in range(split):
        k0, k1 = s * f // split, (s + 1) * f // split
        assert (k1 - k0) % plan.bk == 0 and k1 > k0  # whole stages
        depth.extend(range(k0, k1))
    assert depth == list(range(f))


@pytest.mark.parametrize("f, d", WIDTHS)
@pytest.mark.parametrize("m", MS)
def test_cluster_reduction_adds_each_vector_once(m, f, d):
    plan = plan_glu_ff(m, f, d, H100_SMS)
    split, threads = plan.split, plan.threads
    vecs = plan.bm * plan.bn // 4
    taken = sorted(v for q in range(split) for t in range(threads)
                   for v in range(q * threads + t, vecs, split * threads))
    assert taken == list(range(vecs))


@pytest.mark.parametrize("f, d", WIDTHS)
@pytest.mark.parametrize("m", MS)
def test_grid_fills_the_card_where_it_can(m, f, d):
    plan = plan_glu_ff(m, f, d, H100_SMS)
    tiles, split = plan.grid
    max_split = max(s for s in (1, 2, 4, 8) if s <= C["GF_MAX_SPLIT"] and f % (s * plan.bk) == 0)
    assert split & (split - 1) == 0 and 1 <= split <= max_split
    if tiles * max_split >= H100_SMS:
        assert tiles * split >= H100_SMS
        # the fewest slices that do: half as many would not
        assert split == 1 or tiles * (split // 2) < H100_SMS
    else:
        assert split == max_split
    assert plan.big == (m >= C["GF_BIG_MIN_ROWS"])


def test_main_path_plans():
    """The serving and step shapes (F = 1536, D = 384) on an H100."""
    got = {m: (plan_glu_ff(m, 1536, 384, H100_SMS).big, plan_glu_ff(m, 1536, 384, H100_SMS).grid)
           for m in (80, 160, 320, 640, 1280, 2560)}
    assert got == {80: (False, (9, 8)), 160: (False, (15, 8)), 320: (False, (30, 8)),
                   640: (False, (60, 4)), 1280: (True, (60, 4)), 2560: (True, (120, 2))}
    assert plan_glu_ff(8448, 1536, 384, H100_SMS).grid == (396, 1)


def test_bulk_forward_plans():
    """The bulk full-sequence forward's row counts take the big tile with no
    depth split: 260 x 3 and 520 x 3 tiles, each M a whole number of
    64-row tiles (no ragged row tile)."""
    for m, row_tiles in ((16640, 260), (33280, 520)):
        plan = plan_glu_ff(m, 1536, 384, H100_SMS)
        assert plan.big and (plan.row_tiles, plan.col_tiles, plan.split) == (row_tiles, 3, 1)
        assert plan.grid == (row_tiles * 3, 1) and m % plan.bm == 0


def test_step_sweep_plans():
    """The step at the bench's batch sizes (B = 128, 512, 1024, 1280: M = 10·B
    full-rate and 5·B reduced rows) and the 1,024-slot tick: the big tile,
    whole 64-row tiles, a depth split only while the tiles fill fewer than
    the SMs."""
    got = {m: (plan_glu_ff(m, 1536, 384, H100_SMS).grid, plan_glu_ff(m, 1536, 384, H100_SMS).bm)
           for m in (640, 1280, 2560, 5120, 6400, 10240, 12800)}
    assert got == {640: ((60, 4), 32), 1280: ((60, 4), 64), 2560: ((120, 2), 64),
                   5120: ((240, 1), 64), 6400: ((300, 1), 64), 10240: ((480, 1), 64),
                   12800: ((600, 1), 64)}
    assert all(m % bm == 0 for m, (_, bm) in got.items())


def test_planner_reads_the_kernel_header():
    text = (_build.SOURCE_DIR / PLAN_HEADER).read_text()
    assert '#include "glu_ff_plan.cuh"' in (_build.SOURCE_DIR / "glu_ff.cu").read_text()
    for name, value in re.findall(r"^constexpr int (GF_\w+) = (\d+);", text, re.M):
        assert C[name] == int(value)
    assert len(C) == 14
    assert tile_shape(False) == tuple(C[f"GF_SMALL_{k}"] for k in ("BM", "BN", "BK", "WN", "MT"))
    assert tile_shape(True) == tuple(C[f"GF_BIG_{k}"] for k in ("BM", "BN", "BK", "WN", "MT"))


@pytest.mark.parametrize("big", [False, True])
def test_tile_shapes_fit_the_card(big):
    bm, bn, bk, wn, mt = tile_shape(big)
    stages = C["GF_BIG_STAGES" if big else "GF_SMALL_STAGES"]
    warps = bm // (16 * mt) * wn
    assert bm % (16 * mt) == 0 and (bn // wn) % 16 == 0 and bk % 16 == 0
    assert 1 <= warps <= 32
    smem = stages * (bm * (2 * bk + 8) + bk * (bn + 8)) * 2  # the ring, padded rows, bf16
    assert stages >= 3 and smem <= SMEM_PER_BLOCK
    assert bm * (bn + 4) * 4 <= smem  # the fp32 partial tile reuses the ring
    assert plan_glu_ff(2560 if big else 160, 1536, 384, H100_SMS).threads == warps * 32


@pytest.mark.parametrize("f, d", [(48, 64), (1536, 100), (100, 384)])
def test_widths_the_kernel_cannot_take_are_refused(f, d):
    with pytest.raises(ValueError):
        plan_glu_ff(10, f, d, H100_SMS)
