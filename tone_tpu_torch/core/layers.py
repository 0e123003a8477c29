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
  second rounding), so no product here returns in the compute dtype.
* Convolutions round TWICE, as the reference does: the convolution output
  is rounded to the compute dtype before the float32 bias is added
  (``tone_tpu/core/layers.py:171-173, :208-211``).
* Norms, softmax and the score product run in float32.

Every product and convolution of bf16 operands is the reference's:
products of two bf16 values summed in float32.  Where it runs:

* On the tensor cores, on a CUDA device when both operands are bf16 and
  autograd is not recording (serving, bulk, alignment, the exported step).
  Products are ``torch.mm`` / ``torch.bmm`` with ``out_dtype=torch.float32``
  (bf16 operands, float32 accumulators and result; PyTorch 2.8 or later),
  and ``linear`` adds its bias to that float32 result in the pass that
  rounds it.  Convolutions run on the bf16 operands (cuDNN, or PyTorch's
  depthwise kernel), whose float32 accumulators are rounded once to the
  compute dtype, the rounding the reference makes before the bias.  A
  float32 compute dtype over bf16 operands (the CTC head on bf16 serving
  weights) is the same product: the widening is exact.
* Widened, everywhere else: the operands are copied to float32 first, whose
  products of two bf16 values are exact, and the float32 product or
  convolution runs on the copies.  That is the CPU (which has no bf16
  product with a float32 result), float32 compute configs, autograd
  recording (``Trainer``, ``apply_offline(training=True)``: the training
  backward and the remat policy's saved ``aten.mm`` outputs are the
  widened ones), the products under a torch older than 2.8 (no
  ``aten::mm.dtype``), and the convolution of one input channel (``conv2d``:
  cuDNN's bf16 kernel for it is the slower).  No process-wide precision
  flag is read or set here (``device.py`` keeps TF32 off for the float32
  products).

The two differ only in summation order.  While ``profiling.recording()``,
each product and convolution counts its multiply-adds as
``layers.tc_macs`` or ``layers.widened_macs``.

The bf16 step therefore differs from the reference's only by summation
order and by where bf16 elementwise chains are rounded; the tolerance that
results is stated in tests/test_torch_model.py.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tone_tpu_torch import profiling
from tone_tpu_torch.ops.rel_attention import plan_rel_attention, rel_attention

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


# ``torch.mm`` / ``torch.bmm`` with ``out_dtype`` (``aten::mm.dtype``): a
# float32 result of bf16 operands, from PyTorch 2.8.  An older torch runs
# every product widened (module docstring).
_PRODUCTS_TO_FLOAT32 = all("dtype" in op.overloads()
                           for op in (torch.ops.aten.mm, torch.ops.aten.bmm))


def _on_tensor_cores(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a product or convolution of ``a`` and ``b`` can run on their
    bf16 values (module docstring): autograd not recording, a CUDA device,
    both bf16."""
    return (not torch.is_grad_enabled() and a.is_cuda
            and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16)


def _products_on_tensor_cores(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the product ``a @ b`` runs on their bf16 values."""
    return _PRODUCTS_TO_FLOAT32 and _on_tensor_cores(a, b)


def _count_macs(tensor_cores: bool, macs: int) -> None:
    profiling.count("layers.tc_macs" if tensor_cores else "layers.widened_macs", macs)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed and returned in float32.  ``b`` is a matrix, or has
    ``a``'s leading (batch) dimensions."""
    return _product(a, b, _products_on_tensor_cores(a, b))


def _product(a: torch.Tensor, b: torch.Tensor, tensor_cores: bool) -> torch.Tensor:
    if profiling.recording():
        _count_macs(tensor_cores, math.prod(a.shape) * b.shape[-1])
    if not tensor_cores:
        return torch.matmul(a.float(), b.float())
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    if b.ndim == 2:
        y = torch.mm(a.reshape(-1, k), b, out_dtype=torch.float32)
    else:
        y = torch.bmm(a.reshape(-1, m, k), b.reshape(-1, k, n), out_dtype=torch.float32)
    return y.reshape(*a.shape[:-1], n)


def linear(p: Params, x: torch.Tensor, compute_dtype=torch.bfloat16,
           reduce=None) -> torch.Tensor:
    """``x @ w + b``.  ``reduce`` (a row-split product under tensor
    parallelism) sums the float32 partial products over the model ranks
    before the bias is added, once.  A float32 compute dtype takes the
    operands as they are: the product widens bf16 ones exactly."""
    w = p["w"]
    if compute_dtype != torch.float32:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    tc = _products_on_tensor_cores(x, w)
    y = _product(x, w, tc)
    if reduce is not None:
        y = reduce(y)
    if "b" not in p:
        return y.to(compute_dtype)
    return _add_bias(y, p["b"].float(), compute_dtype, tc)


def linear_product(p: Params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w`` in float32, the product ``linear`` adds its bias to, for a
    caller that adds the bias in a later pass of its own
    (``ops/norm_junction.py``)."""
    w = p["w"]
    if compute_dtype != torch.float32:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    return _product(x, w, _products_on_tensor_cores(x, w))


def _add_bias(y: torch.Tensor, b: torch.Tensor, compute_dtype,
              tensor_cores: bool) -> torch.Tensor:
    """``y + b`` in float32, rounded once to the compute dtype: on the
    tensor-core path (no autograd) as the sum is stored, in one pass."""
    if tensor_cores:
        return torch.add(y, b, out=torch.empty_like(y, dtype=compute_dtype))
    return (y + b).to(compute_dtype)


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
              training: bool = False, momentum: float = 0.1,
              eps: float = 1e-5, mesh=None) -> tuple[torch.Tensor, Params]:
    """BatchNorm over every axis except ``channel_axis``, in float32.

    Eval mode reads the running statistics (a scale and shift).  Training
    mode normalizes with the batch mean and biased variance (autograd runs
    through both) and returns running statistics updated with torch's
    momentum, ``(1 - m) * running + m * batch``, from the unbiased variance
    ``var * n / (n - 1)``; they are detached.  Padded frames count as the
    reference counts them (ROADMAP §C).

    ``mesh`` (a ``parallel.collectives.ProcessMesh`` with more than one data
    rank) makes the batch statistics those of the global batch, every data
    rank holding an equal share of its rows: the per-channel sum, then the
    sum of squares about the global mean, each summed over the data ranks
    inside autograd.

    Returns (output in ``x``'s dtype, statistics: updated or the ones given).
    """
    dtype = x.dtype
    x32 = x.float()
    shape = [1] * x.ndim
    shape[channel_axis] = x.shape[channel_axis]
    if training:
        axes = tuple(i for i in range(x.ndim) if i != channel_axis)
        n = math.prod(x.shape[i] for i in axes)
        if mesh is None or mesh.n_data == 1:
            mean = x32.mean(dim=axes)
            var = x32.var(dim=axes, correction=0)
        else:
            n *= mesh.n_data
            mean = mesh.sum_over_data(x32.sum(dim=axes)) / n
            centered = x32 - mean.reshape(shape)
            var = mesh.sum_over_data(centered.square().sum(dim=axes)) / n
        unbiased = var.detach() * (n / max(n - 1, 1))
        new_stats = {"mean": (1 - momentum) * stats["mean"] + momentum * mean.detach(),
                     "var": (1 - momentum) * stats["var"] + momentum * unbiased}
    else:
        mean, var = stats["mean"], stats["var"]
        new_stats = stats
    scale = p["scale"].float() * torch.rsqrt(var.float() + eps)
    shift = p["bias"].float() - mean.float() * scale
    y = x32 * scale.reshape(shape) + shift.reshape(shape)
    return y.to(dtype), new_stats


_MASK64 = (1 << 64) - 1


def mix_seed(*values: int) -> int:
    """A 63-bit seed that is a pure function of ``values`` (splitmix64 over
    each in turn): the port's stand-in for splitting a JAX key, so that a
    dropout mask depends only on the seed, the layer and the site."""
    z = 0x9E3779B97F4A7C15
    for v in values:
        z = (z ^ (int(v) & _MASK64)) + 0x9E3779B97F4A7C15 & _MASK64
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
        z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK64
        z ^= z >> 31
    return z >> 1


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None, shards: tuple = ()) -> torch.Tensor:
    """Inverted dropout: keeps each element with probability ``1 - rate``
    and scales it by ``1 / (1 - rate)``.  The mask is drawn from
    ``generator`` (on ``x``'s device), never from the global RNG, so that a
    recomputed forward that seeds it alike draws the same mask.  The
    identity when not training, at rate 0 or without a generator (as the
    reference skips dropout without a key).

    ``shards``: ``(dim, index, count)`` for each dimension of which ``x``
    is the ``index``-th of ``count`` equal parts (a rank's rows or heads):
    the mask is drawn for the whole and this part is cut from it, so every
    mesh applies the one-device mask."""
    if not training or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    for dim, _, count in shards:
        shape[dim] *= count
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    for dim, index, _ in shards:
        mask = mask.narrow(dim, index * x.shape[dim], x.shape[dim])
    return torch.where(mask, x / keep, torch.zeros_like(x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def glu(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``a * sigmoid(b)`` for the two halves of ``x`` (the conv-module GLU;
    the feed-forward gate is ``silu(a) * v``, ops/glu_ff.py)."""
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def _conv_bias(y: torch.Tensor, p: Params, w: torch.Tensor, shape: tuple[int, ...],
               compute_dtype, tensor_cores: bool) -> torch.Tensor:
    """The convolution ``y`` of weights ``w`` rounded to the compute dtype
    (as the reference rounds it before the bias), plus the float32 bias,
    rounded again."""
    if profiling.recording():
        _count_macs(tensor_cores, y.numel() * math.prod(w.shape[1:]))
    if tensor_cores:  # y is already rounded
        if "b" not in p:
            return y
        return _add_bias(y, p["b"].float().reshape(shape), compute_dtype, True)
    y = y.to(compute_dtype).float()
    if "b" in p:
        y = y + p["b"].float().reshape(shape)
    return y.to(compute_dtype)


def conv2d(p: Params, x: torch.Tensor, stride: tuple[int, int],
           compute_dtype=torch.bfloat16, padding: int | tuple[int, int] = 0,
           groups: int = 1) -> torch.Tensor:
    """2D convolution, NCHW input / OIHW weights: valid, or with ``padding``
    zeros on both sides of each spatial axis; ``groups`` as in
    ``F.conv2d`` (a depthwise convolution has as many as channels)."""
    x, w = x.to(compute_dtype), p["w"].to(compute_dtype)
    # One input channel (the subsampling's first convolution) stays widened:
    # cuDNN's bf16 kernel for it took 7.17 ms on the H100 at the bulk batch's
    # 16 x 6,250 frames of 64 mels, the float32 one 3.03 ms.
    tc = x.shape[1] > 1 and _on_tensor_cores(x, w)
    if not tc:
        x, w = x.float(), w.float()
    y = F.conv2d(x, w, stride=stride, padding=padding, groups=groups)
    return _conv_bias(y, p, w, (1, -1, 1, 1), compute_dtype, tc)


def conv1d_nhc(p: Params, x: torch.Tensor, stride: int = 1, groups: int = 1,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Valid 1D convolution in the reference's feature-last layout: (B, T, C)
    in and out, (O, I/groups, K) weights.  Output channel ``o`` of a grouped
    convolution reads input channels of group ``o // (O / groups)``."""
    x, w = x.to(compute_dtype), p["w"].to(compute_dtype)
    tc = _on_tensor_cores(x, w)
    if not tc:
        x, w = x.float(), w.float()
    y = F.conv1d(x.transpose(1, 2), w, stride=stride, groups=groups)
    return _conv_bias(y.transpose(1, 2), p, w, (-1,), compute_dtype, tc)


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
    dropout_generator: torch.Generator | None = None,
    dropout_rate: float = 0.0,
    training: bool = False,
    tp=None,
    dropout_shards: tuple = (),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary multi-head attention with optional score reuse.

    Per-head LayerNorm on q/k, RoPE on the leading ``rope_dim`` features
    (keys offset by the cache length), masked scores set to -1e4 before the
    float32 softmax and the masked weights zeroed after it; the weights are
    rounded to the compute dtype before the product with V.  In training,
    dropout (``dropout_rate``, masks from ``dropout_generator``) applies to
    the float32 attention weights.

    Args:
        query: (B, Tq, D) pre-projection activations.
        kv: (B, Tkv, D) pre-projection activations (window ‖ chunk).
        k_offset: cache length, for the key RoPE positions.
        mask: optional boolean (B, Tq, Tkv); True = masked.
        cached_scores: if given, reuse these (B, H, Tq, Tkv) float32 scores
            and skip the q/k path (score-sharing layers have no q/k weights).
        tp: tensor parallelism (``_tp_heads``): the q/k/v weights hold this
            rank's heads and ``linear_out`` their input rows.
        dropout_shards: this rank's part of the weights' rows and heads
            (``dropout``).

    Returns:
        (output (B, Tq, D), scores (B, H, Tq, Tkv) float32; H is this
        rank's heads under ``tp``).
    """
    b, tq, d = query.shape
    tkv = kv.shape[1]
    d_head = d // n_heads
    p, query, kv, n_heads, reduce = _tp_heads(tp, p, query, kv, n_heads)

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
    attn = dropout(attn, dropout_rate, training, dropout_generator, dropout_shards)

    ctx = _mm(attn.to(compute_dtype), v).to(compute_dtype)
    ctx = ctx.transpose(1, 2).reshape(b, tq, n_heads * d_head)
    out = linear(p["linear_out"], ctx, compute_dtype, reduce)
    return out, scores


def _tp_heads(tp, p: Params, query, kv, n_heads: int):
    """Megatron's split of the attention: ``(p, query, kv, local heads,
    reduce)``.  Under tensor parallelism (``tp``, a ``ProcessMesh`` with
    more than one model rank) the inputs pass through ``copy_to_model``
    (its backward sums their gradients over the model ranks), each rank
    computes ``n_heads / n_model`` heads, and ``linear_out``'s row-split
    product is summed over the ranks (``reduce``).  The per-head q/k
    LayerNorm parameters are replicated but see only this rank's heads, so
    they pass through ``copy_to_model`` too: their gradient is the sum over
    the ranks' heads, the same on every rank."""
    if tp is None:
        return p, query, kv, n_heads, None
    if n_heads % tp.n_model:
        raise ValueError(f"{n_heads} heads do not split over {tp.n_model} model ranks")
    same = kv is query
    query = tp.copy_to_model(query)
    kv = query if same else tp.copy_to_model(kv)
    p = {k: ({n: tp.copy_to_model(t) for n, t in v.items()} if k in ("q_ln", "k_ln") else v)
         for k, v in p.items()}
    return p, query, kv, n_heads // tp.n_model, tp.reduce_from_model


def _block_window(xb: torch.Tensor, n_window_chunks: int, skip: int) -> torch.Tensor:
    """(B, H, n, c, d) chunked tensor -> (B, H, n, (nw+1)*c - skip, d) where
    chunk i's window is chunks [i-nw .. i] (zeros shifted in before the
    sequence) less the first ``skip`` frames of chunk i-nw."""
    if n_window_chunks == 0:
        return xb
    n = xb.shape[2]
    parts = [F.pad(xb, (0, 0, 0, 0, j, 0))[:, :, :n]
             for j in range(n_window_chunks, 0, -1)]
    if skip:
        parts[0] = parts[0][:, :, :, skip:]
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
    dropout_generator: torch.Generator | None = None,
    dropout_rate: float = 0.0,
    training: bool = False,
    tp=None,
    dropout_shards: tuple = (),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-local attention as dense per-chunk blocks (the offline path).

    The same function as ``mhsa`` under the offline chunk-simulating mask
    (each query chunk attends to itself plus ``left_context`` preceding
    frames): every key that mask allows is inside the block window, and
    every key outside it would take -1e4 and vanish in the float32
    softmax.  Computes (B, H, n_chunks, c, w+c) score blocks, w =
    ``left_context``, instead of (B, H, T, T).  A window that is not a whole
    number of chunks is cut from the ceil(w / c) chunks before the query's.

    Returns (output (B, T, D), scores (B, H, n, c, w+c) float32); the scores
    are reusable as ``cached_scores`` by the score-sharing layers of the
    same mask group, as ``mhsa``'s are.  Training dropout on the attention
    weights, and tensor parallelism, as in ``mhsa``.
    """
    b, t, d = x.shape
    d_head = d // n_heads
    p, x, _, n_heads, reduce = _tp_heads(tp, p, x, x, n_heads)
    nw = -(-left_context // chunk)
    skip = nw * chunk - left_context        # window frames before the left context
    n = -(-t // chunk)
    tp_len = n * chunk

    def blocked(proj):  # (B, T, H, dh) -> (B, H, n, c, dh)
        proj = F.pad(proj.transpose(1, 2), (0, 0, 0, tp_len - t))
        return proj.reshape(b, n_heads, n, chunk, d_head)

    def rope(xb):  # RoPE positions are absolute: applied on the padded (B, H, Tp, dh)
        return apply_rope(xb.reshape(b, n_heads, tp_len, d_head), rope_dim, 0).reshape(
            b, n_heads, n, chunk, d_head)

    if cached_scores is None:
        q = linear(p["linear_q"], x, compute_dtype).reshape(b, t, n_heads, d_head)
        k = linear(p["linear_k"], x, compute_dtype).reshape(b, t, n_heads, d_head)
        qb = rope(blocked(layernorm(p["q_ln"], q)))
        kwin = _block_window(rope(blocked(layernorm(p["k_ln"], k))), nw, skip)
        scores = _mm(qb, kwin.transpose(-1, -2)) / math.sqrt(d_head)
    else:
        scores = cached_scores

    v = linear(p["linear_v"], x, compute_dtype).reshape(b, t, n_heads, d_head)
    vwin = _block_window(blocked(v), nw, skip)

    # Mask (True = masked): window slot s of chunk i is global column
    # (i - nw) * chunk + skip + s, masked before the sequence start or at/past
    # the valid length; rows at/past the valid length are masked whole.
    dev = x.device
    cols = ((torch.arange(n, device=dev)[:, None] - nw) * chunk
            + torch.arange(skip, (nw + 1) * chunk, device=dev))            # (n, w+c)
    rows = torch.arange(tp_len, device=dev).reshape(n, chunk)             # (n, c)
    lens = lengths.to(dev)[:, None, None]
    col_ok = (cols[None] >= 0) & (cols[None] < lens)                      # (B, n, w+c)
    row_ok = rows[None] < lens                                            # (B, n, c)
    m = ~(row_ok[:, :, :, None] & col_ok[:, :, None, :])[:, None]         # (B, 1, n, c, w+c)

    attn = torch.softmax(scores.float().masked_fill(m, -10000.0), dim=-1).masked_fill(m, 0.0)
    attn = dropout(attn, dropout_rate, training, dropout_generator, dropout_shards)
    ctx = _mm(attn.to(compute_dtype), vwin).to(compute_dtype)             # (B, H, n, c, dh)
    ctx = ctx.reshape(b, n_heads, tp_len, d_head).transpose(1, 2)[:, :t]
    return linear(p["linear_out"], ctx.reshape(b, t, n_heads * d_head), compute_dtype,
                  reduce), scores


# Score elements (float32) of one query block of the relative-position
# attention's plain version: ``rel_attention_plain`` cuts its queries so
# that a block's (B, H, Q, Q + T - 1) position scores stay near this
# (512 MB).
REL_SCORE_BLOCK_ELEMENTS = 1 << 27


def rel_blocks(lengths: Sequence[int], n_heads: int) -> tuple[int, list[tuple[int, int, int, int]]]:
    """How ``rel_attention_plain`` cuts a batch whose rows hold ``lengths``
    valid frames: (keys, [(i0, i1, lo, hi)]).  Keys are the longest row's
    frames rounded up to a multiple of 8 (every product then has aligned
    rows; the extra keys are masked).  Queries ``i0 .. i1 - 1`` of each
    block are computed for rows ``lo .. hi - 1``, the rows that hold a frame
    there (a row whose frames end before the block is skipped; rows sorted
    by length skip exactly those).  A block has the most queries, a power of
    two from 16, whose position scores fit ``REL_SCORE_BLOCK_ELEMENTS``."""
    b, longest = len(lengths), max(lengths)
    keys = -(-longest // 8) * 8
    step = 16
    while step < longest and b * n_heads * 2 * step * (2 * step + keys + 7) <= \
            REL_SCORE_BLOCK_ELEMENTS:
        step *= 2
    blocks = []
    for i0 in range(0, longest, step):
        rows = [r for r, n in enumerate(lengths) if n > i0]
        blocks.append((i0, min(i0 + step, longest), rows[0], rows[-1] + 1))
    return keys, blocks


def rel_mhsa_blocked(
    p: Params,
    x: torch.Tensor,
    pos: torch.Tensor,
    *,
    n_heads: int,
    lengths: torch.Tensor,
    host_lengths: Sequence[int],
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Transformer-XL relative-position attention over the full context
    (NeMo's ``RelPositionMultiHeadAttention``, the FastConformer's):
    ``rel_attention_context``, then the output projection, its frames past
    the longest row zero.

    Args:
        x: (B, T, D) the layer's normed input.
        pos, lengths, host_lengths: as ``rel_attention_context`` takes them.

    Returns:
        (B, T, D) in the compute dtype.
    """
    ctx = rel_attention_context(p, x, pos, n_heads=n_heads, lengths=lengths,
                                host_lengths=host_lengths, compute_dtype=compute_dtype)
    return F.pad(linear(p["linear_out"], ctx, compute_dtype), (0, 0, 0, x.shape[1] - ctx.shape[1]))


def rel_attention_context(
    p: Params,
    x: torch.Tensor,
    pos: torch.Tensor,
    *,
    n_heads: int,
    lengths: torch.Tensor,
    host_lengths: Sequence[int],
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """The relative-position attention of ``rel_mhsa_blocked`` up to the
    input of its output projection.

    The score of query ``i`` and key ``j`` is
    ``((q_i + u) . k_j + (q_i + v) . p_{i-j}) / sqrt(d_head)`` with
    ``p_r = linear_pos(PE(r))`` (no bias) and the per-layer biases ``u`` =
    ``pos_bias_u``, ``v`` = ``pos_bias_v`` (H, d_head); ``q + u`` and
    ``q + v`` are summed in float32, divided by ``sqrt(d_head)`` there and
    rounded once to the compute dtype, so the float32 products are the
    scores.  Keys at or past a row's length are masked before the float32
    softmax; the weights are rounded to the compute dtype before the
    product with V.  The projections run on ``_product``.

    Between the projections, on the card the hand-written kernel
    (``ops/rel_attention.py``: one launch, autograd off, bf16) and on the
    CPU its plain version ``rel_attention_plain``.  Under
    ``profiling.recording()`` each call counts the query-key pairs the
    path computed, per row, as ``fastconformer.attention_pairs_computed``.

    Args:
        x: (B, T, D) the layer's normed input.
        pos: (2 * max(host_lengths) - 1, D) the encodings of the relative
            positions ``max - 1`` down to ``-(max - 1)``.
        lengths: (B,) valid frames, on ``x``'s device.
        host_lengths: the same on the host.

    Returns:
        the context (B, max(host_lengths), D) in the compute dtype.
    """
    tq = max(host_lengths)
    xs = x[:, :tq]
    q = linear(p["linear_q"], xs, compute_dtype)
    k = linear(p["linear_k"], xs, compute_dtype)
    v = linear(p["linear_v"], xs, compute_dtype)
    pe = linear(p["linear_pos"], pos.to(compute_dtype), compute_dtype)   # (2 tq - 1, D)
    if x.is_cuda:
        ctx = rel_attention(q, k, v, pe, p["pos_bias_u"].float().contiguous(),
                            p["pos_bias_v"].float().contiguous(), host_lengths, n_heads)
        pairs = plan_rel_attention(host_lengths).pairs
    else:
        ctx = rel_attention_plain(q, k, v, pe, p["pos_bias_u"], p["pos_bias_v"], n_heads=n_heads,
                                  lengths=lengths, host_lengths=host_lengths,
                                  compute_dtype=compute_dtype)
        keys, blocks = rel_blocks(host_lengths, n_heads)
        pairs = keys * sum((hi - lo) * (i1 - i0) for i0, i1, lo, hi in blocks)
    if profiling.recording():
        profiling.count("fastconformer.attention_pairs_computed", pairs)
    return ctx


def rel_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pe: torch.Tensor,
    bias_u: torch.Tensor,
    bias_v: torch.Tensor,
    *,
    n_heads: int,
    lengths: torch.Tensor,
    host_lengths: Sequence[int],
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """The kernel's function (``ops/rel_attention.py``) in blocked PyTorch:
    q, k, v (B, Tq, D) and pe (2 Tq - 1, D) in the compute dtype (position
    ``Tq - 1 - r`` at row ``r``), the biases (H, d_head); returns the
    context (B, Tq, D) in the compute dtype.

    Queries are cut in blocks (``rel_blocks``).  A block of queries ``i0 ..
    i1 - 1`` takes the positions it needs, ``i1 - 1`` down to ``i0 - (keys -
    1)``; its product with them is shifted into (queries, keys) by a strided
    view (``(q_i + v) . p_{i-j}`` sits at column ``(i1 - 1 - i) + j``), not
    copied.  Keys at or past a row's length take -1e4 before the float32
    softmax.  Queries past the longest row, and the rows that ``rel_blocks``
    skips in a block, are not computed: those output rows are zero.
    Products run on ``_product``.
    """
    b, tq, d = q.shape
    d_head = d // n_heads
    tk, blocks = rel_blocks(host_lengths, n_heads)

    def heads(proj):  # (B, Tq, D) -> (B, H, Tk, dh), the keys past Tq zero
        proj = proj.reshape(b, tq, n_heads, d_head).transpose(1, 2)
        return F.pad(proj, (0, 0, 0, tk - tq)).contiguous()

    qf = q.reshape(b, tq, n_heads, d_head).float()
    k_t = heads(k).transpose(-1, -2)                                         # (B, H, dh, Tk)
    v = heads(v)
    # Positions tq - 1 down to -(tq - 1), then zeros for the padded keys and
    # the aligned rows of each block's position product.
    pe = F.pad(pe, (0, 0, 0, tk - tq + 7)).reshape(tq + tk + 6, n_heads, d_head).transpose(0, 1)
    scale = math.sqrt(d_head)
    q_u = ((qf + bias_u.float()) / scale).to(compute_dtype).transpose(1, 2)
    q_v = ((qf + bias_v.float()) / scale).to(compute_dtype).permute(2, 0, 1, 3)
    masked = (torch.arange(tk, device=q.device)[None] >= lengths[:, None])[:, None, None]
    out = []
    for i0, i1, lo, hi in blocks:
        nq, rows = i1 - i0, hi - lo
        w = -(-(nq + tk - 1) // 8) * 8                                      # aligned rows
        scores = _mm(q_u[lo:hi, :, i0:i1], k_t[lo:hi])                       # (rows, H, nq, Tk)
        raw = _mm(q_v[:, lo:hi, i0:i1].reshape(n_heads, rows * nq, d_head),
                  pe[:, tq - i1:tq - i1 + w].transpose(-1, -2))              # (H, rows*nq, w)
        bd = raw.as_strided((rows, n_heads, nq, tk), (nq * w, rows * nq * w, w - 1, 1),
                            raw.storage_offset() + nq - 1)
        scores = scores.add_(bd).masked_fill_(masked[lo:hi], -10000.0)
        attn = torch.softmax(scores, dim=-1).to(compute_dtype)
        ctx = _mm(attn, v[lo:hi]).to(compute_dtype)                          # (rows, H, nq, dh)
        out.append(F.pad(ctx, (0, 0, 0, 0, 0, 0, lo, b - hi)))
    return torch.cat(out, dim=2).transpose(1, 2).reshape(b, tq, d)
