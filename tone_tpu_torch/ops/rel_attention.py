"""The FastConformer's relative-position attention as one hand-written
Hopper kernel (``csrc/rel_attention.cu``), for ``core/layers.py
rel_mhsa_blocked`` on the card.

``rel_attention(q, k, v, pe, bias_u, bias_v, host_lengths, n_heads)`` takes
the projections as ``rel_mhsa_blocked`` makes them (q, k, v (B, T, H * dh)
bf16 with T the longest row, pe (2T - 1, H * dh) bf16: position T - 1 - r
at row r; the position biases (H, dh)) and returns the context (B, T,
H * dh) bf16, the input of the output projection.  One launch per call:
the scores, the relative shift, the key mask and the online softmax stay
on chip.  It takes CUDA tensors with autograd off and raises on anything
else; its plain version, the same mathematics in blocked PyTorch
(``layers.rel_attention_plain``), is what the CPU runs.

``plan_rel_attention`` builds the launch's grid on the host from the rows'
lengths (the tile sizes are the kernel's, ``RA_*`` in the source):
one item per (row, query tile below the row's length), longest rows first,
each run for every head.  The kernel walks a row's key tiles below its
length only, so what it computes is ``pairs``.

``rel_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from tone_tpu_torch import profiling
from tone_tpu_torch.ops import _build

__all__ = ["D_HEADS", "RelAttentionPlan", "kernel_constants", "plan_rel_attention",
           "rel_attention"]

SOURCE = "rel_attention"
D_HEADS = (32, 64, 128)   # the kernel's template instances


@functools.cache
def kernel_constants() -> dict[str, int]:
    """The ``constexpr int RA_*`` tile sizes of ``csrc/rel_attention.cu``."""
    text = (_build.SOURCE_DIR / f"{SOURCE}.cu").read_text()
    return {name: int(value)
            for name, value in re.findall(r"^constexpr int (RA_\w+) = (\d+);", text, re.M)}


@dataclass(frozen=True)
class RelAttentionPlan:
    bm: int                 # queries of a block
    bn: int                 # keys of a tile
    items: np.ndarray       # (n, 4) int32: row, query tile, row length, 0
    pairs: int              # query-key pairs computed per head: over rows,
                            # (query tiles x bm) x (key tiles x bn)
    tile_pairs: int         # (query tile, key tile) pairs per head


@functools.lru_cache(maxsize=64)
def _plan(lengths: tuple[int, ...]) -> RelAttentionPlan:
    c = kernel_constants()
    bm, bn = c["RA_BM"], c["RA_BN"]
    order = sorted(range(len(lengths)), key=lambda r: -lengths[r])   # stable: ties by row
    items = np.array([(r, tile, lengths[r], 0) for r in order
                      for tile in range(-(-lengths[r] // bm))], dtype=np.int32).reshape(-1, 4)
    items.setflags(write=False)
    tiles = [(-(-n // bm), -(-n // bn)) for n in lengths]
    return RelAttentionPlan(bm=bm, bn=bn, items=items,
                            pairs=sum(nq * bm * nk * bn for nq, nk in tiles),
                            tile_pairs=sum(nq * nk for nq, nk in tiles))


def plan_rel_attention(host_lengths: Sequence[int]) -> RelAttentionPlan:
    """The launch for rows of ``host_lengths`` valid frames (module
    docstring); rows of no frame take no block."""
    lengths = tuple(int(n) for n in host_lengths)
    if not lengths or min(lengths) < 0 or max(lengths) >= 1 << 30:
        raise ValueError(f"rel_attention: row lengths out of range: {lengths[:8]}")
    return _plan(lengths)


def kernel_macs(plan: RelAttentionPlan, n_heads: int, d_head: int) -> int:
    """Multiply-adds the launch runs: per head and (query tile, key tile),
    bm x bn x dh for the content scores and again for the weights times V,
    and bm x (bn + 16) x dh for the position scores over a warp's window."""
    return n_heads * plan.tile_pairs * plan.bm * d_head * (3 * plan.bn + 16)


@functools.lru_cache(maxsize=16)
def _device_items(lengths: tuple[int, ...], index: int) -> torch.Tensor:
    """The plan's items on card ``index``, queued without waiting for its
    queue (pinned, non-blocking); one upload per batch's lengths."""
    items = torch.from_numpy(_plan(lengths).items.copy())
    return items.pin_memory().to(torch.device("cuda", index), non_blocking=True)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.tone_rel_attention
    if fn.argtypes is None:  # declare once: ctypes would pass pointers as 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pe: torch.Tensor,
                  bias_u: torch.Tensor, bias_v: torch.Tensor, host_lengths: Sequence[int],
                  n_heads: int) -> torch.Tensor:
    """One launch of the kernel (counted): the context (B, T, H * dh) bf16,
    zero in the rows at and past each row's length."""
    if torch.is_grad_enabled():
        raise RuntimeError("rel_attention: the kernel has no backward; call it with "
                           "autograd off (torch.no_grad())")
    b, tq, d = q.shape
    d_head = d // n_heads
    if d_head not in D_HEADS or d_head * n_heads != d:
        raise ValueError(f"rel_attention kernel: d_head {d} / {n_heads} is not one of {D_HEADS}")
    lengths = tuple(int(n) for n in host_lengths)
    if len(lengths) != b or max(lengths) != tq:
        raise ValueError(f"rel_attention: {len(lengths)} lengths, the longest "
                         f"{max(lengths)}, for q of {b} rows of {tq} frames")
    dev = q.device
    expect = {"q": (q, (b, tq, d), torch.bfloat16), "k": (k, (b, tq, d), torch.bfloat16),
              "v": (v, (b, tq, d), torch.bfloat16), "pe": (pe, (2 * tq - 1, d), torch.bfloat16),
              "bias_u": (bias_u, (n_heads, d_head), torch.float32),
              "bias_v": (bias_v, (n_heads, d_head), torch.float32)}
    for name, (t, shape, dtype) in expect.items():
        if t.device != dev or dev.type != "cuda" or tuple(t.shape) != shape \
                or t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rel_attention kernel: {name} must be a contiguous, 16-byte "
                             f"aligned {dtype} tensor of shape {shape} on a CUDA device "
                             f"(got {t.dtype} {tuple(t.shape)} on {t.device})")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    plan = plan_rel_attention(lengths)
    out = torch.zeros_like(q)
    if len(plan.items):
        items = _device_items(lengths, index)
        with torch.cuda.device(index):  # the kernel launches on the current device
            err = _kernel_lib().tone_rel_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pe.data_ptr(), bias_u.data_ptr(),
                bias_v.data_ptr(), items.data_ptr(), out.data_ptr(), len(plan.items), tq,
                n_heads, d_head, math.sqrt(d_head), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"rel_attention kernel launch failed (cudaError {err})")
        rel_attention.launches += 1
        if profiling.recording():
            profiling.count("layers.tc_macs", kernel_macs(plan, n_heads, d_head))
    return out


rel_attention.launches = 0
