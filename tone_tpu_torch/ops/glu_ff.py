"""Fused GLU gate -> output projection of the serving feed-forward (port of
``tone_tpu/ops/glu_ff.py``).

``glu_ff2(av, p2)`` computes ``lin2(silu(a) * v)`` for ``av = [a | v]``, the
output of the merged in-projection (``lin12``, acoustic.cast_params_for_inference),
without writing the gated product to device memory.  On a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/glu_ff.cu`` or raises; on a
CPU tensor it runs ``glu_ff2_plain``, the same numerics in plain PyTorch:

* sigmoid in float32, the gate ``silu(a)`` rounded to bf16;
* the gate times ``v`` in bf16;
* the product with ``W2`` on bf16 operands, summed in float32;
* the float32 bias added, then one rounding to bf16.

``plan_glu_ff`` works out a launch (tile, depth split, grid) from
the tile sizes in ``csrc/glu_ff_plan.cuh``, which the kernel compiles, and
the card's SM count.

``glu_ff2.launches`` counts kernel launches (only launches, not plain runs).
"""

from __future__ import annotations

import ctypes
import functools
import re
from dataclasses import dataclass

import torch

from tone_tpu_torch.ops import _build

__all__ = ["GluPlan", "glu_ff2", "glu_ff2_plain", "kernel_constants", "plan_glu_ff"]


def glu_ff2_plain(av: torch.Tensor, p2, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``av`` (..., 2F), ``p2`` =
    ``{"w": (F, D), "b": (D,)}``; returns (..., D) in ``compute_dtype``."""
    f = p2["w"].shape[0]
    av = av.to(compute_dtype)
    a32 = av[..., :f].float()
    g = (a32 * torch.sigmoid(a32)).to(compute_dtype) * av[..., f:]
    y = torch.matmul(g.float(), p2["w"].to(compute_dtype).float()) + p2["b"].float()
    return y.to(compute_dtype)


# ---------------------------------------------------------------------------
# The launch plan.
# ---------------------------------------------------------------------------

PLAN_HEADER = "glu_ff_plan.cuh"


@functools.cache
def kernel_constants() -> dict[str, int]:
    """The ``constexpr int GF_*`` tile sizes of ``csrc/glu_ff_plan.cuh``."""
    text = (_build.SOURCE_DIR / PLAN_HEADER).read_text()
    return {name: int(value)
            for name, value in re.findall(r"^constexpr int (GF_\w+) = (\d+);", text, re.M)}


@dataclass(frozen=True)
class GluPlan:
    big: bool        # the GF_BIG_* tile, else GF_SMALL_*
    bm: int          # rows of an output tile
    bn: int          # columns of an output tile
    bk: int          # depth of one cp.async stage
    threads: int     # (BM / (16 MT)) x WN warps
    row_tiles: int
    col_tiles: int
    split: int       # depth slices of F, one cluster of blocks per tile: block
                     # (tile, s) sums F rows s * F / split .. (s + 1) * F / split - 1

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def grid(self) -> tuple[int, int]:
        """(tiles, split): tile = row tile * col_tiles + column tile."""
        return self.tiles, self.split


def tile_shape(big: bool) -> tuple[int, int, int, int, int]:
    """(BM, BN, BK, warps across the columns, 16-row mma tiles per warp)
    of the big or small tile."""
    c = kernel_constants()
    p = "GF_BIG_" if big else "GF_SMALL_"
    return tuple(c[p + k] for k in ("BM", "BN", "BK", "WN", "MT"))


def plan_glu_ff(m: int, f: int, d: int, sms: int) -> GluPlan:
    """The launch at ``m`` rows on a card of ``sms`` SMs.  The big tile from
    GF_BIG_MIN_ROWS rows (where its stages divide F), else the small one;
    then the fewest depth slices (a power of two, each a whole number of
    stages, at most GF_MAX_SPLIT) that give at least one block per SM, or
    the most there are.  (Clusters of 3 or 6 blocks ran slower than those
    of 2, 4 and 8 on the H100.)"""
    c = kernel_constants()
    bm, bn, bk, wn, mt = tile_shape(True)
    big = m >= c["GF_BIG_MIN_ROWS"] and f % bk == 0
    if not big:
        bm, bn, bk, wn, mt = tile_shape(False)
    if f % bk or d % 8:
        raise ValueError(f"glu_ff kernel: F={f} must be a multiple of {bk} "
                         f"and D={d} a multiple of 8")
    row_tiles, col_tiles = -(-m // bm), -(-d // bn)  # the last tiles may be ragged
    splits = [1 << i for i in range(c["GF_MAX_SPLIT"].bit_length())
              if f % ((1 << i) * bk) == 0]
    split = next((s for s in splits if row_tiles * col_tiles * s >= sms), splits[-1])
    return GluPlan(big=big, bm=bm, bn=bn, bk=bk, threads=bm // (16 * mt) * wn * 32,
                   row_tiles=row_tiles, col_tiles=col_tiles, split=split)


# ---------------------------------------------------------------------------
# The kernel wrapper.
# ---------------------------------------------------------------------------


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("glu_ff")
    fn = lib.tone_glu_ff2
    if fn.argtypes is None:  # declare once: ctypes would pass ints as 32-bit
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


_SMS: dict[int, int] = {}


def _sm_count(index: int) -> int:
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


@functools.lru_cache(maxsize=1024)
def _plan(m: int, f: int, d: int, sms: int) -> GluPlan:
    return plan_glu_ff(m, f, d, sms)


def glu_ff2(av: torch.Tensor, p2, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``lin2(silu(av[..., :F]) * av[..., F:])``; ``av`` (..., 2F),
    ``p2`` = ``{"w": (F, D) bf16, "b": (D,) float32}``."""
    *lead, two_f = av.shape
    f, d = p2["w"].shape
    if two_f != 2 * f:
        raise ValueError(f"av has {two_f} features, W2 expects 2 x {f}")
    if av.device.type == "cpu":
        return glu_ff2_plain(av, p2, compute_dtype)
    if av.device.type != "cuda":
        raise ValueError(f"glu_ff2 runs on CUDA or CPU tensors, not {av.device}")

    w, b = p2["w"], p2["b"]
    if compute_dtype != torch.bfloat16 or av.dtype != torch.bfloat16 \
            or w.dtype != torch.bfloat16 or b.dtype != torch.float32:
        raise TypeError("the glu_ff kernel takes bf16 av and W2, a float32 bias "
                        f"and bf16 compute (got {av.dtype}, {w.dtype}, {b.dtype}, "
                        f"{compute_dtype})")
    av2 = av.reshape(-1, two_f)
    for name, t in (("av", av2), ("W2", w), ("b", b)):
        if t.device != av.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"glu_ff kernel: {name} must be a contiguous, "
                             f"16-byte aligned tensor on {av.device}")
    dev = av.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    m = av2.shape[0]
    plan = _plan(max(m, 1), f, d, _sm_count(index))  # raises on widths the tiles refuse
    y = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    if m:
        with torch.cuda.device(index):  # the kernel launches on the current device
            err = _kernel_lib().tone_glu_ff2(
                av2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), m, f, d,
                int(plan.big), plan.split, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"glu_ff kernel launch failed (cudaError {err})")
        glu_ff2.launches += 1
    return y.reshape(*lead, d)


glu_ff2.launches = 0
