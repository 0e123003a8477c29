"""The relative-position attention kernel's launch plan
(tone_tpu_torch/ops/rel_attention.py ``plan_rel_attention``) and its walk,
on the CPU.

The CUDA kernel (csrc/rel_attention.cu) runs one block per (item, head):
item = (row, query tile, row length), the query tile RA_BM queries, and the
block walks the key tiles of RA_BN keys below the row's length.  A warp of
16 queries takes its position scores from a window of RA_BN + 16 position
rows held in a ring of RA_BM + RA_BN rows, each key tile bringing RA_BN new
ones.  These tests replay that walk with the kernel's formulas: every
(row, head, valid query) is covered once, every valid key visited, no tile
lies wholly past a row's length, the ring holds each window's rows when it
is read, the staged diagonal is the position i - j, and the walk (its
tiles, ring, diagonal and online softmax, in float64) gives the plain
version's attention.
"""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch

from tone_tpu_torch import profiling
from tone_tpu_torch.core import layers as L
from tone_tpu_torch.ops import _build
from tone_tpu_torch.ops import rel_attention as RA

C = RA.kernel_constants()
BM, BN = C["RA_BM"], C["RA_BN"]
WARPS = BM // 16
RING = BM + BN
WIN = BN + 16

BATCHES = {
    "ragged": [1, 7, 63, 64, 65, 129],
    "unsorted": [65, 3, 200, 64, 1, 129, 128],
    "one_row": [97],
    "cell_longest": [3551, 2900, 1200, 17],
    "with_empty_row": [0, 40, 5],
}


def _blocks(plan, n_heads):
    """(row, head, first query, length) of each block in launch order."""
    return [(int(r), x % n_heads, int(tile) * BM, int(n))
            for x in range(len(plan.items) * n_heads)
            for r, tile, n, _ in [plan.items[x // n_heads]]]


def test_kernel_and_planner_share_the_tile_sizes():
    assert C == {"RA_BM": 64, "RA_BN": 64}
    assert RING & (RING - 1) == 0
    assert "rel_attention" in {p.stem for p in _build.SOURCE_DIR.glob("*.cu")}


@pytest.mark.parametrize("lengths", BATCHES.values(), ids=BATCHES.keys())
@pytest.mark.parametrize("n_heads", [1, 8])
def test_grid_covers_every_valid_query_once(lengths, n_heads):
    plan = RA.plan_rel_attention(lengths)
    covered: dict[tuple[int, int, int], int] = {}
    for row, head, i0, n in _blocks(plan, n_heads):
        assert n == lengths[row]
        assert i0 < n, "a query tile wholly past the row's length"
        for i in range(i0, min(i0 + BM, n)):     # the kernel stores rows below the length
            covered[row, head, i] = covered.get((row, head, i), 0) + 1
    expect = {(r, h, i) for r, n in enumerate(lengths) for h in range(n_heads)
              for i in range(n)}
    assert set(covered) == expect
    assert set(covered.values()) <= {1}


@pytest.mark.parametrize("lengths", BATCHES.values(), ids=BATCHES.keys())
def test_key_tiles_reach_every_valid_key_and_stop_at_the_length(lengths):
    plan = RA.plan_rel_attention(lengths)
    walked_pairs = 0
    for _, _, _, n in _blocks(plan, 1):
        n_kt = -(-n // BN)                       # the kernel's key tile count
        assert n_kt * BN >= n                    # every valid key
        assert (n_kt - 1) * BN < n               # the last tile starts below the length
        walked_pairs += BM * n_kt * BN
    assert walked_pairs == plan.pairs
    assert plan.tile_pairs * BM * BN == plan.pairs
    # at least the useful pairs, at most a tile's edge more of each
    assert sum(n * n for n in lengths) <= plan.pairs
    assert plan.pairs <= sum((n + BM - 1) * (n + BN - 1) for n in lengths if n)


@pytest.mark.parametrize("lengths", BATCHES.values(), ids=BATCHES.keys())
def test_longest_rows_first(lengths):
    items = RA.plan_rel_attention(lengths).items
    assert items.dtype == np.int32 and items.shape[1] == 4
    assert list(items[:, 2]) == sorted(items[:, 2], reverse=True)
    assert not items[:, 3].any()


def test_plan_refuses_bad_lengths():
    with pytest.raises(ValueError):
        RA.plan_rel_attention([])
    with pytest.raises(ValueError):
        RA.plan_rel_attention([3, -1])


@pytest.mark.parametrize("tq", [1, 63, 64, 65, 200])
def test_ring_holds_each_window_and_the_diagonal_is_i_minus_j(tq):
    """Replays the position ring of every block of a row of ``tq`` frames:
    the rows each warp reads are in their slots, and window column
    (15 - r) + c of warp w is position (i0 + 16 w + r) - (j0 + c)."""
    for i0 in range(0, tq, BM):
        p_first = tq - BM - i0
        ring = {}                                 # slot -> position row held
        for r in range(p_first, p_first + RING):
            ring[r & (RING - 1)] = r
        for kt in range(-(-tq // BN)):
            j0 = kt * BN
            for w in range(WARPS):
                pw = p_first + j0 + BM - 16 * (w + 1)
                for col in range(WIN):
                    assert ring[(pw + col) & (RING - 1)] == pw + col
                for r in range(16):
                    for c in range(BN):
                        row = pw + (15 - r) + c   # position tq - 1 - row
                        assert tq - 1 - row == (i0 + 16 * w + r) - (j0 + c)
            for r in range(p_first + j0 + RING, p_first + j0 + RING + BN):
                ring[r & (RING - 1)] = r          # the next tile's new rows


def _walk(q, k, v, pe, bias_u, bias_v, lengths, n_heads):
    """The kernel's walk in float64: blocks, key tiles, the ring's window,
    the staged diagonal, the key mask and the online softmax."""
    b, tq, d = q.shape
    dh = d // n_heads
    out = np.zeros((b, tq, d))
    plan = RA.plan_rel_attention(lengths)
    for row, head, i0, n in _blocks(plan, n_heads):
        cols = slice(head * dh, (head + 1) * dh)
        qt = np.zeros((BM, dh))
        rows = min(BM, n - i0)
        qt[:rows] = q[row, i0:i0 + rows, cols]
        qu = (qt + bias_u[head]) / math.sqrt(dh)
        qv = (qt + bias_v[head]) / math.sqrt(dh)
        m = np.full(BM, -np.inf)
        l_sum = np.zeros(BM)
        o = np.zeros((BM, dh))
        for kt in range(-(-n // BN)):
            j0 = kt * BN
            kk, vv = np.zeros((BN, dh)), np.zeros((BN, dh))
            valid = min(BN, n - j0)
            kk[:valid] = k[row, j0:j0 + valid, cols]
            vv[:valid] = v[row, j0:j0 + valid, cols]
            s = qu @ kk.T
            for w in range(WARPS):
                pw = tq - 16 - i0 - 16 * w + j0
                window = np.zeros((WIN, dh))
                for c in range(WIN):
                    if 0 <= pw + c < 2 * tq - 1:
                        window[c] = pe[pw + c, cols]
                raw = qv[16 * w:16 * w + 16] @ window.T       # the warp's staging
                for r in range(16):
                    s[16 * w + r] += raw[r, 15 - r:15 - r + BN]
            s[:, valid:] = -np.inf
            mx = np.maximum(m, s.max(axis=1))
            corr = np.exp(m - mx)
            p = np.exp(s - mx[:, None])
            l_sum = l_sum * corr + p.sum(axis=1)
            o = o * corr[:, None] + p @ vv
            m = mx
        out[row, i0:i0 + rows, cols] = (o / l_sum[:, None])[:rows]
    return out


@pytest.mark.parametrize("lengths, n_heads, d_head", [
    ([1, 7, 63, 64, 65, 129], 2, 32),
    ([65, 3, 130], 1, 64),
    ([70], 2, 16),
])
def test_the_walk_is_the_plain_attention(lengths, n_heads, d_head):
    gen = torch.Generator().manual_seed(sum(lengths))
    b, tq, d = len(lengths), max(lengths), n_heads * d_head
    q, k, v = (torch.randn(b, tq, d, generator=gen) for _ in range(3))
    pe = torch.randn(2 * tq - 1, d, generator=gen)
    bias_u, bias_v = (torch.randn(n_heads, d_head, generator=gen) * 0.3 for _ in range(2))
    plain = L.rel_attention_plain(q, k, v, pe, bias_u, bias_v, n_heads=n_heads,
                                  lengths=torch.tensor(lengths), host_lengths=lengths,
                                  compute_dtype=torch.float32)
    walked = _walk(*(t.double().numpy() for t in (q, k, v, pe, bias_u, bias_v)), lengths,
                   n_heads)
    for row, n in enumerate(lengths):
        # float32 sums against float64 ones over at most 129 keys
        np.testing.assert_allclose(walked[row, :n], plain[row, :n].double().numpy(),
                                   rtol=0, atol=2e-5)
        assert not walked[row, n:].any()


def test_kernel_counts_its_multiply_adds():
    plan = RA.plan_rel_attention([65, 3])
    # (2 x 2 + 1 x 1) tile pairs of 64 x 64, each 64 x dh x (3 x 64 + 16)
    assert plan.tile_pairs == 5
    assert RA.kernel_macs(plan, n_heads=8, d_head=128) == 8 * 5 * 64 * 128 * (3 * 64 + 16)


def test_the_cpu_runs_the_plain_version_and_counts_its_pairs():
    host = [37, 50, 13]
    gen = torch.Generator().manual_seed(3)
    d, n_heads = 64, 2
    p = {name: L.init_linear(gen, d, d) for name in ("linear_q", "linear_k", "linear_v",
                                                       "linear_out")}
    p.update(linear_pos=L.init_linear(gen, d, d, bias=False),
             pos_bias_u=torch.zeros(n_heads, d // n_heads),
             pos_bias_v=torch.zeros(n_heads, d // n_heads))
    x = torch.randn(3, 55, d, generator=gen)
    pos = torch.randn(2 * max(host) - 1, d, generator=gen)
    launches = RA.rel_attention.launches
    t0 = time.monotonic_ns()
    with profiling.record():
        L.rel_mhsa_blocked(p, x, pos, n_heads=n_heads, lengths=torch.tensor(host),
                           host_lengths=host)
    counts = [e.n for e in profiling.events(t0)
              if e.name == "fastconformer.attention_pairs_computed"]
    keys, blocks = L.rel_blocks(host, n_heads)
    assert counts == [keys * sum((hi - lo) * (i1 - i0) for i0, i1, lo, hi in blocks)]
    assert RA.rel_attention.launches == launches


def test_the_kernel_refuses_cpu_tensors_and_autograd():
    q = torch.zeros(1, 4, 64, dtype=torch.bfloat16)
    pe = torch.zeros(7, 64, dtype=torch.bfloat16)
    b = torch.zeros(2, 32)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        RA.rel_attention(q, q, q, pe, b, b, [4], 2)
    with pytest.raises(RuntimeError, match="autograd"):
        RA.rel_attention(q, q, q, pe, b, b, [4], 2)
    with torch.no_grad(), pytest.raises(ValueError, match="d_head"):
        RA.rel_attention(q, q, q, pe, b, b, [4], 4)
