"""The fused layer's launch planner (tone_tpu_torch/ops/fused_layer.py
``plan_launch``) and the kernel build's cache key, on the CPU.

The CUDA kernel (csrc/fused_layer.cu) walks its stages with the planner's
formulas: grid-stride over the stage's rows (one warp each), tiles or
items (one block each), tiles numbered row tile major within each product
and on from the previous product's last.  These tests replay that walk for
every layer kind of the full model and check that each row, each
(row, column) of every product and each (stream, head) is handled exactly
once, whatever the batch and the grid, and that the scratch buffers the
kernel carves are disjoint, aligned and as large as it writes.
"""

import math
import shutil

import pytest

from tone_tpu_torch.ops import _build
from tone_tpu_torch.ops.fused_layer import (
    SCRATCH_NAMES,
    FusedLayerArgs,
    ff_split,
    kernel_constants,
    plan_launch,
)

C = kernel_constants()
WARPS = C["FL_THREADS"] // 32
# Layer kinds of ToneConfig(): (t, window, recompute)
KINDS = {"recompute_t10": (10, 0, 1), "reuse_t10": (10, 0, 0), "recompute_t5": (5, 0, 1),
         "reuse_t5": (5, 0, 0), "w15": (5, 15, 1), "w30": (10, 30, 1)}
BATCHES = (1, 3, 16, 64, 100, 256)
H100_BLOCKS = 132 * C["FL_MAX_BLOCKS_PER_SM"]


def _args(kind, d=384, f=1536, heads=8):
    t, window, recompute = KINDS[kind]
    return FusedLayerArgs(t=t, window=window, d=d, f=f, n_heads=heads, rope_dim=32,
                          conv_k=31, recompute=recompute)


def _walk(stage, grid):
    """Indices of the stage's units in the order the grid's blocks (or
    warps) take them."""
    if stage.unit == "row":
        lanes = grid * WARPS
        return [i for g in range(lanes) for i in range(g, stage.count, lanes)]
    return [i for g in range(grid) for i in range(g, stage.count, grid)]


def _tile_of(stage, tile):
    """(product, row tile, column tile) of one tile of a tile stage."""
    for p, (rows, n, bn) in enumerate(stage.products):
        ntn = n // bn
        count = -(-rows // C["FL_BM"]) * ntn
        if tile < count:
            return (p, *divmod(tile, ntn))
        tile -= count
    raise AssertionError(f"tile beyond stage {stage.name}")


def _assert_tiles_cover(stage, taken):
    """Each (row, column) of every product lies in exactly one taken tile:
    the taken tiles are each product's row tiles x column tiles once, and
    the row tiles (the last one ragged) partition the product's rows."""
    bm = C["FL_BM"]
    tiles = [_tile_of(stage, tile) for tile in taken]
    assert len(tiles) == len(set(tiles)), stage.name
    for p, (rows, n, bn) in enumerate(stage.products):
        ntm = -(-rows // bm)
        got = {(tm, tn) for q, tm, tn in tiles if q == p}
        assert got == {(tm, tn) for tm in range(ntm) for tn in range(n // bn)}, stage.name
        spans = [(tm * bm, min(rows, (tm + 1) * bm)) for tm in range(ntm)]
        assert spans[0][0] == 0 and spans[-1][1] == rows
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(spans, spans[1:])), stage.name


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_row_tile_and_head_is_covered_once(kind, batch):
    args = _args(kind)
    t, window = args.t, args.window
    m, mkv = batch * t, batch * (window + t)
    for grid in (plan_launch(args, batch, H100_BLOCKS).grid, 7):
        plan = plan_launch(args, batch, grid)
        assert plan.grid <= grid
        names = [s.name for s in plan.stages]
        assert len([n for n in names if not n.startswith("+")]) == 15  # 14 grid barriers
        for stage in plan.stages:
            taken = _walk(stage, plan.grid)
            assert sorted(taken) == list(range(stage.count)), stage.name
            if stage.name == "+window_shift":
                assert stage.count == (batch * (window - t) if window else 0)
            elif stage.unit == "row":
                assert stage.count == m, stage.name
            elif stage.unit == "tile":
                _assert_tiles_cover(stage, taken)
        products = {s.name: s.products for s in plan.stages if s.unit == "tile"}
        # q, then k and v sharing their tiles
        assert [p[0] for p in products["qkv"]] == ([m, mkv] if args.recompute else [mkv])
        assert products["ff1_up"] == ((m, args.f, C["FL_BN_FF"]),)
        # FF down: d_ff = 1536 in 4 depth slices of 384, one product each
        assert plan.ff_split == 4
        assert products["ff2_down"] == ((m, args.d, C["FL_BN_FF"]),) * 4
        attention = next(s for s in plan.stages if s.name == "attention")
        heads = {divmod(item, args.n_heads) for item in _walk(attention, plan.grid)}
        assert heads == {(b, h) for b in range(batch) for h in range(args.n_heads)}
        conv = next(s for s in plan.stages if s.name == "conv")
        assert conv.count == batch * math.ceil(args.d / C["FL_CONV_COLS"])


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("kind", ["recompute_t10", "reuse_t5", "w30"])
def test_scratch_buffers_are_disjoint_aligned_and_sized(kind, batch):
    args = _args(kind)
    plan = plan_launch(args, batch, H100_BLOCKS)
    m, mkv, d, f = batch * args.t, batch * (args.window + args.t), args.d, args.f
    want = {"res": m * d * 4, "act": m * d * 2, "hid": m * f * 2,
            "qf": m * d * 4 * args.recompute, "kf": mkv * d * 4 * args.recompute,
            "v": mkv * d * 2, "part": 4 * m * d * 4}
    assert {n: size for n, (_, size) in plan.scratch.items()} == want
    spans = sorted(plan.scratch[n] for n in SCRATCH_NAMES)
    for (off, size), (next_off, _) in zip(spans, spans[1:]):
        assert off + size <= next_off
    assert all(off % C["FL_SCRATCH_ALIGN"] == 0 for off, _ in spans)
    assert spans[-1][0] + spans[-1][1] <= plan.scratch_bytes
    assert plan.scratch_bytes < spans[-1][0] + spans[-1][1] + C["FL_SCRATCH_ALIGN"]
    s = plan.scratch_struct()
    assert [getattr(s, n) for n in SCRATCH_NAMES] == [plan.scratch[n][0] for n in SCRATCH_NAMES]
    assert s.total == plan.scratch_bytes


def test_grid_follows_the_card_not_the_batch():
    args = _args("w30")
    assert plan_launch(args, 64, H100_BLOCKS).grid == H100_BLOCKS
    assert plan_launch(args, 256, H100_BLOCKS).grid == H100_BLOCKS
    # B = 1: the widest stage is FF up, one row tile x d_ff / 64 column tiles.
    assert plan_launch(args, 1, H100_BLOCKS).grid == 1536 // C["FL_BN_FF"]
    assert plan_launch(args, 64, 10).grid == 10


def test_constants_match_the_kernel_header():
    # The dual-product ring of FF up (A tile and two weight tiles, padded
    # rows, bf16) is the kernel's whole dynamic shared memory.
    ring = C["FL_STAGES"] * (C["FL_BM"] * (C["FL_BK"] + 8)
                             + 2 * C["FL_BK"] * (C["FL_BN_FF"] + 8)) * 2
    assert C["FL_SMEM"] == ring
    assert C["FL_THREADS"] == 256 and C["FL_BM"] == 64
    # two resident blocks fit the H100's 227 KB of shared memory per SM
    assert C["FL_MAX_BLOCKS_PER_SM"] * C["FL_SMEM"] <= 232448
    # the main path's widths divide into the tiles
    assert 384 % C["FL_BK"] == 0 and 384 % C["FL_BN_FF"] == 0 and 1536 % C["FL_BN_FF"] == 0


@pytest.mark.parametrize("f, split", [(1536, 4), (128, 2), (64, 1), (192, 3), (320, 1)])
def test_ff_down_split_cuts_d_ff_into_whole_steps(f, split):
    assert ff_split(f) == split
    assert f % (split * C["FL_BK"]) == 0 and split <= C["FL_FF_SPLIT"]


def test_library_path_changes_with_an_included_header(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.SOURCE_DIR, src)
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    before = _build.library_path("fused_layer")
    glu_before = _build.library_path("glu_ff")
    header = src / "fused_layer_plan.cuh"
    text = header.read_text()
    header.write_text(text.replace("FL_BK = 64;", "FL_BK = 32;"))
    assert _build.library_path("fused_layer") != before
    assert _build.library_path("glu_ff") != glu_before  # any header may be included
    header.write_text(text)
    assert _build.library_path("fused_layer") == before
