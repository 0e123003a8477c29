"""Neural-net primitives of the streaming step and the offline forward (port
of ``tone_tpu/core/layers.py``).

Plain functions over parameter dictionaries with the reference's layout:

* linear:      ``{"w": (in, out), "b": (out,)}``          applied as ``x @ w + b``
* conv (any):  ``{"w": torch layout (O, I/groups, *K), "b": (O,)}``
* rmsnorm:     ``{"weight": (d,)}``                        eps = 1e-8, fp32 compute
* layernorm:   ``{"scale": (d,), "bias": (d,)}``           eps = 1e-5, fp32 compute
* batchnorm:   params ``{"scale", "bias"}`` + stats ``{"mean", "var"}``, eps = 1e-5

Rounding policy (where port and reference could silently part):

* ``linear`` rounds ONCE, as the reference does: the operands are rounded
  to the compute dtype, their product is summed in float32, the float32
  bias is added, and only then is the result rounded to the compute dtype.
  ``torch.matmul`` on bf16 tensors would round to bf16 before the bias (a
  second rounding), so the port widens the bf16 operands to float32 first:
  products of two bf16 values are exact in float32, so this is the
  reference's bf16 x bf16 -> float32 product.
* Convolutions round TWICE, as the reference does: the convolution output
  is rounded to the compute dtype before the float32 bias is added
  (``tone_tpu/core/layers.py:171-173, :208-211``).  The convolution itself
  runs on float32 copies of the rounded operands.
* Norms, softmax and the score product run in float32.

The bf16 step therefore differs from the reference's only by summation
order and by where bf16 elementwise chains are rounded; the tolerance that
results is stated in tests/test_torch_model.py.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers (torch-default-compatible: kaiming-uniform fan_in bounds),
# drawn from an explicit torch.Generator.
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


def init_linear(gen, d_in: int, d_out: int, bias: bool = True) -> Params:
    bound = 1.0 / math.sqrt(d_in)
    p = {"w": _uniform(gen, (d_in, d_out), bound)}
    if bias:
        p["b"] = _uniform(gen, (d_out,), bound)
    return p


def init_conv(gen, out_ch: int, in_ch_per_group: int, kernel: tuple[int, ...]) -> Params:
    bound = 1.0 / math.sqrt(in_ch_per_group * math.prod(kernel))
    return {"w": _uniform(gen, (out_ch, in_ch_per_group, *kernel), bound),
            "b": _uniform(gen, (out_ch,), bound)}


def init_rmsnorm(d: int) -> Params:
    return {"weight": torch.ones(d)}


def init_layernorm(d: int) -> Params:
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def init_batchnorm(c: int) -> tuple[Params, Params]:
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def init_mhsa(gen, d_model: int, n_heads: int, recompute_scores: bool) -> Params:
    d_head = d_model // n_heads
    p: Params = {
        "linear_v": init_linear(gen, d_model, d_model),
        "linear_out": init_linear(gen, d_model, d_model),
    }
    if recompute_scores:
        p["linear_q"] = init_linear(gen, d_model, d_model)
        p["linear_k"] = init_linear(gen, d_model, d_model)
        p["q_ln"] = init_layernorm(d_head)
        p["k_ln"] = init_layernorm(d_head)
    return p


# ---------------------------------------------------------------------------
# Primitive applications.
# ---------------------------------------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of two compute-dtype tensors, summed and returned in float32."""
    return torch.matmul(a.float(), b.float())


def linear(p: Params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    y = _mm(x.to(compute_dtype), p["w"].to(compute_dtype))
    if "b" in p:
        y = y + p["b"].float()
    return y.to(compute_dtype)


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """RMSNorm with fp32 compute; divides by ``rms + eps`` (not
    ``sqrt(ms + eps)``), as the reference does."""
    dtype = x.dtype
    x32 = x.float()
    d = x.shape[-1]
    rms = x32.square().sum(dim=-1, keepdim=True).sqrt() / math.sqrt(d)
    normed = x32 / (rms + eps)
    return (p["weight"].float() * normed).to(dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dtype)


def batchnorm(p: Params, stats: Params, x: torch.Tensor, *, channel_axis: int,
              eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm (running statistics) over ``channel_axis``."""
    dtype = x.dtype
    shape = [1] * x.ndim
    shape[channel_axis] = x.shape[channel_axis]
    scale = p["scale"].float() * torch.rsqrt(stats["var"].float() + eps)
    shift = p["bias"].float() - stats["mean"].float() * scale
    y = x.float() * scale.reshape(shape) + shift.reshape(shape)
    return y.to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def glu(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``a * sigmoid(b)`` for the two halves of ``x`` (the conv-module GLU;
    the feed-forward gate is ``silu(a) * v``, ops/glu_ff.py)."""
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def _conv_bias(y: torch.Tensor, p: Params, shape: tuple[int, ...],
               compute_dtype) -> torch.Tensor:
    y = y.to(compute_dtype).float()  # the reference rounds before the bias
    if "b" in p:
        y = y + p["b"].float().reshape(shape)
    return y.to(compute_dtype)


def conv2d(p: Params, x: torch.Tensor, stride: tuple[int, int],
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Valid 2D convolution, NCHW input / OIHW weights."""
    y = F.conv2d(x.to(compute_dtype).float(), p["w"].to(compute_dtype).float(),
                 stride=stride)
    return _conv_bias(y, p, (1, -1, 1, 1), compute_dtype)


def conv1d_nhc(p: Params, x: torch.Tensor, stride: int = 1, groups: int = 1,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Valid 1D convolution in the reference's feature-last layout: (B, T, C)
    in and out, (O, I/groups, K) weights.  Output channel ``o`` of a grouped
    convolution reads input channels of group ``o // (O / groups)``."""
    y = F.conv1d(x.to(compute_dtype).float().transpose(1, 2),
                 p["w"].to(compute_dtype).float(), stride=stride, groups=groups)
    return _conv_bias(y.transpose(1, 2), p, (-1,), compute_dtype)


@functools.lru_cache(maxsize=64)
def _rope_tables(t: int, rope_dim: int, offset: int, base: float,
                 dtype: torch.dtype, device: torch.device):
    inv_freq = 1.0 / (base ** (np.arange(0, rope_dim, 2, dtype=np.float64) / rope_dim))
    positions = np.arange(-offset, t - offset, dtype=np.float64)
    freqs = positions[:, None] * inv_freq[None, :]  # (T, half)
    emb = np.concatenate([freqs, freqs], axis=-1)  # (T, rope_dim)
    cos = torch.from_numpy(np.cos(emb)).to(device=device, dtype=dtype)
    sin = torch.from_numpy(np.sin(emb)).to(device=device, dtype=dtype)
    return cos, sin


def apply_rope(x: torch.Tensor, rope_dim: int, offset: int,
               base: float = 10_000.0) -> torch.Tensor:
    """Rotate-half RoPE on the first ``rope_dim`` features of each head.

    Positions run from ``-offset`` to ``T - offset - 1``, so cached keys
    (which precede the chunk) take negative positions.  ``cos``/``sin`` are
    computed in float64 and cast to the activation dtype.

    Args:
        x: (B, H, T, d_head).
    """
    t = x.shape[2]
    half = rope_dim // 2
    cos, sin = _rope_tables(t, rope_dim, offset, base, x.dtype, x.device)
    x_rope, x_pass = x[..., :rope_dim], x[..., rope_dim:]
    x1, x2 = x_rope[..., :half], x_rope[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    x_rope = x_rope * cos + rotated * sin
    return torch.cat([x_rope, x_pass], dim=-1)


def mhsa(
    p: Params,
    query: torch.Tensor,
    kv: torch.Tensor,
    *,
    n_heads: int,
    rope_dim: int,
    k_offset: int,
    mask: torch.Tensor | None,
    cached_scores: torch.Tensor | None,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary multi-head attention with optional score reuse.

    Per-head LayerNorm on q/k, RoPE on the leading ``rope_dim`` features
    (keys offset by the cache length), masked scores set to -1e4 before the
    float32 softmax and the masked weights zeroed after it; the weights are
    rounded to the compute dtype before the product with V.

    Args:
        query: (B, Tq, D) pre-projection activations.
        kv: (B, Tkv, D) pre-projection activations (window ‖ chunk).
        k_offset: cache length, for the key RoPE positions.
        mask: optional boolean (B, Tq, Tkv); True = masked.
        cached_scores: if given, reuse these (B, H, Tq, Tkv) float32 scores
            and skip the q/k path (score-sharing layers have no q/k weights).

    Returns:
        (output (B, Tq, D), scores (B, H, Tq, Tkv) float32).
    """
    b, tq, d = query.shape
    tkv = kv.shape[1]
    d_head = d // n_heads

    if cached_scores is None:
        q = linear(p["linear_q"], query, compute_dtype).reshape(b, tq, n_heads, d_head)
        k = linear(p["linear_k"], kv, compute_dtype).reshape(b, tkv, n_heads, d_head)
        q = layernorm(p["q_ln"], q).transpose(1, 2)  # (B, H, Tq, dh)
        k = layernorm(p["k_ln"], k).transpose(1, 2)
        q = apply_rope(q, rope_dim, 0)
        k = apply_rope(k, rope_dim, k_offset)
        scores = _mm(q, k.transpose(-1, -2)) / math.sqrt(d_head)
    else:
        scores = cached_scores

    v = linear(p["linear_v"], kv, compute_dtype).reshape(b, tkv, n_heads, d_head)
    v = v.transpose(1, 2)  # (B, H, Tkv, dh)

    s = scores.float()
    if mask is not None:
        m = mask[:, None, :, :]  # (B, 1, Tq, Tkv)
        attn = torch.softmax(s.masked_fill(m, -10000.0), dim=-1).masked_fill(m, 0.0)
    else:
        attn = torch.softmax(s, dim=-1)

    ctx = _mm(attn.to(compute_dtype), v).to(compute_dtype)
    ctx = ctx.transpose(1, 2).reshape(b, tq, d)
    out = linear(p["linear_out"], ctx, compute_dtype)
    return out, scores


def _block_window(xb: torch.Tensor, n_window_chunks: int) -> torch.Tensor:
    """(B, H, n, c, d) chunked tensor -> (B, H, n, (nw+1)*c, d) where chunk
    i's window is chunks [i-nw .. i] (zeros shifted in before the sequence)."""
    if n_window_chunks == 0:
        return xb
    n = xb.shape[2]
    parts = [F.pad(xb, (0, 0, 0, 0, j, 0))[:, :, :n]
             for j in range(n_window_chunks, 0, -1)]
    return torch.cat(parts + [xb], dim=3)


def mhsa_blocked(
    p: Params,
    x: torch.Tensor,
    *,
    n_heads: int,
    rope_dim: int,
    chunk: int,
    left_context: int,
    lengths: torch.Tensor,
    cached_scores: torch.Tensor | None,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-local attention as dense per-chunk blocks (the offline path).

    The same function as ``mhsa`` under the offline chunk-simulating mask
    (each query chunk attends to itself plus ``left_context`` preceding
    frames): every key that mask allows is inside the block window, and
    every key outside it would take -1e4 and vanish in the float32
    softmax.  Computes (B, H, n_chunks, c, w+c) score blocks instead of
    (B, H, T, T).  ``left_context`` must be a whole number of chunks.

    Returns (output (B, T, D), scores (B, H, n, c, w+c) float32); the scores
    are reusable as ``cached_scores`` by the score-sharing layers of the
    same mask group, as ``mhsa``'s are.
    """
    b, t, d = x.shape
    d_head = d // n_heads
    if left_context % chunk:
        raise ValueError(f"left_context {left_context} is not a multiple of chunk {chunk}")
    nw = left_context // chunk
    n = -(-t // chunk)
    tp = n * chunk

    def blocked(proj):  # (B, T, H, dh) -> (B, H, n, c, dh)
        proj = F.pad(proj.transpose(1, 2), (0, 0, 0, tp - t))
        return proj.reshape(b, n_heads, n, chunk, d_head)

    def rope(xb):  # RoPE positions are absolute: applied on the padded (B, H, Tp, dh)
        return apply_rope(xb.reshape(b, n_heads, tp, d_head), rope_dim, 0).reshape(
            b, n_heads, n, chunk, d_head)

    if cached_scores is None:
        q = linear(p["linear_q"], x, compute_dtype).reshape(b, t, n_heads, d_head)
        k = linear(p["linear_k"], x, compute_dtype).reshape(b, t, n_heads, d_head)
        qb = rope(blocked(layernorm(p["q_ln"], q)))
        kwin = _block_window(rope(blocked(layernorm(p["k_ln"], k))), nw)
        scores = _mm(qb, kwin.transpose(-1, -2)) / math.sqrt(d_head)
    else:
        scores = cached_scores

    v = linear(p["linear_v"], x, compute_dtype).reshape(b, t, n_heads, d_head)
    vwin = _block_window(blocked(v), nw)

    # Mask (True = masked): window slot s of chunk i is global column
    # (i - nw) * chunk + s, masked before the sequence start or at/past the
    # valid length; rows at/past the valid length are masked whole.
    dev = x.device
    cols = ((torch.arange(n, device=dev)[:, None] - nw) * chunk
            + torch.arange((nw + 1) * chunk, device=dev))                  # (n, w+c)
    rows = torch.arange(tp, device=dev).reshape(n, chunk)                 # (n, c)
    lens = lengths.to(dev)[:, None, None]
    col_ok = (cols[None] >= 0) & (cols[None] < lens)                      # (B, n, w+c)
    row_ok = rows[None] < lens                                            # (B, n, c)
    m = ~(row_ok[:, :, :, None] & col_ok[:, :, None, :])[:, None]         # (B, 1, n, c, w+c)

    attn = torch.softmax(scores.float().masked_fill(m, -10000.0), dim=-1).masked_fill(m, 0.0)
    ctx = _mm(attn.to(compute_dtype), vwin).to(compute_dtype)             # (B, H, n, c, dh)
    ctx = ctx.reshape(b, n_heads, tp, d_head).transpose(1, 2)[:, :t].reshape(b, t, d)
    return linear(p["linear_out"], ctx, compute_dtype), scores
