"""Plain reference of the T-one streaming Conformer CTC model, in float32.

The published T-one (reference ``tone/training/model_wrapper.py:27-121``):
a log-mel frontend, a convolutional subsampling by 3 in time, 16 Macaron
Conformer layers (GLU feed-forward halves, rotary attention with per-head
q/k LayerNorm, causal depthwise convolution, RMSNorm), a temporal
reduction by 2 after layer 6 and an upsampling after layer 14, attention
scores computed at some layers and reused by the layers after them, and
a CTC head.  Layers below ``mhsa_stateless_layers`` attend within their
chunk; the others also to a carried window of earlier frames.

Written out once more in plain PyTorch, with no kernel, no rounding to a
lower precision and no batching trick: every product runs in float32
(TF32 off, ``float32_exactly``) unless a ``Precision`` of a lower kind is
given, which is how the benchmark's control is computed.  It imports
nothing of the program it judges.  Inputs and weights are the ones the
benchmark hands to both sides: a tree ``{"params", "batch_stats"}`` in
the published layout (``param_layout``).

Two forwards with one function:

* ``streaming_step``: one chunk of audio with carried state;
* ``offline_forward``: whole utterances, chunk-local attention written as
  per-chunk blocks, in inference or in training (batch statistics and
  dropout whose masks are drawn per layer and site from ``mix_seed``).
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Configuration: the sizes of the configuration file's "model" object.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Sizes:
    sample_rate: int
    win: int
    hop: int
    n_fft: int
    n_mels: int
    preemph: float
    log_guard: float
    feat_in: int
    n_layers: int
    d_model: int
    d_ff: int
    n_heads: int
    rope_dim: int
    conv_kernel: int
    dropout: float
    dropout_att: float
    sub_channels: tuple
    sub_kernels: tuple
    sub_strides: tuple
    stateless: int
    window: int
    chunk: int
    red_pos: int
    red_factor: int
    red_kernel: int
    up_pos: int
    recompute: tuple
    vocab: int          # labels + blank
    chunk_samples: int
    padding: int

    @property
    def carry(self) -> int:
        """Samples of audio carried into the next chunk's frames."""
        return self.n_fft - self.hop

    @property
    def sub_tails(self) -> tuple:
        return tuple(k[0] - s[0] for k, s in zip(self.sub_kernels, self.sub_strides))

    @property
    def sub_widths(self) -> tuple:
        out, f = [], self.feat_in
        for k, s in zip(self.sub_kernels, self.sub_strides):
            f = (f - k[1]) // s[1] + 1
            out.append(f)
        return tuple(out)

    @property
    def stateful(self) -> int:
        return self.n_layers - self.stateless

    def reduced(self, layer: int) -> bool:
        return self.red_pos < layer <= self.up_pos


def sizes(model: dict) -> Sizes:
    fe, enc = model["frontend"], model["encoder"]
    return Sizes(
        sample_rate=fe["sample_rate"], win=int(fe["window_size"] * fe["sample_rate"]),
        hop=int(fe["window_stride"] * fe["sample_rate"]), n_fft=fe["n_fft"],
        n_mels=fe["n_mels"], preemph=fe["preemphasis_coefficient"],
        log_guard=fe["log_zero_guard_value"], feat_in=enc["feat_in"],
        n_layers=enc["n_layers"], d_model=enc["d_model"],
        d_ff=enc["d_model"] * enc["ff_expansion_factor"], n_heads=enc["n_heads"],
        rope_dim=enc["rope_dim"], conv_kernel=enc["conv_kernel_size"],
        dropout=enc["dropout"], dropout_att=enc["dropout_att"],
        sub_channels=tuple(enc["subsampling_conv_channels"]),
        sub_kernels=tuple(tuple(k) for k in enc["subsampling_kernel_size"]),
        sub_strides=tuple(tuple(s) for s in enc["subsampling_strides"]),
        stateless=enc["mhsa_stateless_layers"], window=enc["mhsa_state_size"],
        chunk=enc["chunk_size"], red_pos=enc["reduction_position"],
        red_factor=enc["reduction_factor"], red_kernel=enc["reduction_kernel_size"],
        up_pos=enc["upsample_position"],
        recompute=tuple(enc["should_recompute_att_scores"]),
        vocab=len(model["labels"]) + 1, chunk_samples=model["audio_chunk_samples"],
        padding=model["padding"])


# ---------------------------------------------------------------------------
# The parameter tree: shapes and how the benchmark draws each leaf.
# ---------------------------------------------------------------------------


class Leaf(NamedTuple):
    shape: tuple
    kind: str
    scale: float


def param_layout(s: Sizes) -> dict:
    """``{"params", "batch_stats"}`` with a ``Leaf(shape, kind, scale)`` at
    each leaf: ``uniform`` in [-scale, scale] (a weight: 1/sqrt(fan-in)),
    ``one`` in [1 - scale, 1 + scale] (a norm's scale, a running variance)
    or ``zero`` in [-scale, scale] (a norm's shift, a running mean)."""
    def lin(d_in, d_out, bias=True):
        b = 1.0 / math.sqrt(d_in)
        p = {"w": Leaf((d_in, d_out), "uniform", b)}
        if bias:
            p["b"] = Leaf((d_out,), "uniform", b)
        return p

    def conv(out_ch, in_per_group, kernel):
        b = 1.0 / math.sqrt(in_per_group * math.prod(kernel))
        return {"w": Leaf((out_ch, in_per_group, *kernel), "uniform", b),
                "b": Leaf((out_ch,), "uniform", b)}

    def rms(d):
        return {"weight": Leaf((d,), "one", 0.1)}

    def ln(d):
        return {"scale": Leaf((d,), "one", 0.1), "bias": Leaf((d,), "zero", 0.05)}

    def bn(c):
        return ({"scale": Leaf((c,), "one", 0.1), "bias": Leaf((c,), "zero", 0.05)},
                {"mean": Leaf((c,), "zero", 0.1), "var": Leaf((c,), "one", 0.2)})

    def ff():
        return {"lin1": lin(s.d_model, s.d_ff), "linv": lin(s.d_model, s.d_ff),
                "lin2": lin(s.d_ff, s.d_model)}

    ch, ks, w = s.sub_channels, s.sub_kernels, s.sub_widths
    bn1, bn1s = bn(ch[0])
    bn2, bn2s = bn(ch[1])
    pre = {"pre_norm": rms(s.feat_in), "conv1": conv(ch[0], 1, ks[0]), "bn1": bn1,
           "conv2": conv(ch[1], ch[0], ks[1]), "bn2": bn2,
           "out": lin(ch[1] * w[1], s.d_model, bias=False), "out_norm": rms(s.d_model)}
    layers, stats = [], []
    dh = s.d_model // s.n_heads
    for i in range(s.n_layers):
        bnp, bns = bn(s.d_model)
        att = {"linear_v": lin(s.d_model, s.d_model), "linear_out": lin(s.d_model, s.d_model)}
        if s.recompute[i]:
            att.update(linear_q=lin(s.d_model, s.d_model), linear_k=lin(s.d_model, s.d_model),
                       q_ln=ln(dh), k_ln=ln(dh))
        layers.append({
            "norm_ff1": rms(s.d_model), "ff1": ff(), "norm_att": rms(s.d_model), "att": att,
            "norm_conv": rms(s.d_model),
            "conv": {"pw1": lin(s.d_model, 2 * s.d_model), "dw": conv(s.d_model, 1, (s.conv_kernel,)),
                     "bn": bnp, "pw2": lin(s.d_model, s.d_model)},
            "norm_ff2": rms(s.d_model), "ff2": ff(), "norm_out": rms(s.d_model)})
        stats.append({"conv_bn": bns})
    reduction = {"dw": conv(4 * s.d_model, 1, (s.red_kernel,)), "pw": lin(4 * s.d_model, s.d_model)}
    params = {"encoder": {"pre_encode": pre, "layers": tuple(layers), "reduction": reduction},
              "head": lin(s.d_model, s.vocab)}
    batch_stats = {"pre_encode": {"bn1": bn1s, "bn2": bn2s}, "layers": tuple(stats)}
    return {"params": params, "batch_stats": batch_stats}


def tree_items(tree, prefix: str = ""):
    """``(path, leaf)`` of a tree of dicts and tuples, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Leaf):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# Precision: float32, or the control's lower precision.
# ---------------------------------------------------------------------------


class Precision:
    """Where the configuration computes in bf16 (the operands of every
    product and convolution, the attention weights before their product
    with V), ``float32`` keeps float32 and ``fp8`` rounds to float8 e4m3
    with one scale per tensor (its largest magnitude to 448)."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))


FLOAT32 = Precision("float32")


@contextlib.contextmanager
def float32_exactly():
    """Products in float32 without TF32 for the block's duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Primitives.
# ---------------------------------------------------------------------------


def linear(p, x, pr: Precision):
    y = pr.mm(x, p["w"])
    return y + p["b"] if "b" in p else y


def rmsnorm(p, x, eps=1e-8):
    rms = x.square().sum(-1, keepdim=True).sqrt() / math.sqrt(x.shape[-1])
    return p["weight"] * (x / (rms + eps))


def layernorm(p, x, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def batchnorm(p, stats, x, channel_axis, training, momentum=0.1, eps=1e-5):
    """Eval: running statistics.  Training: batch mean and biased variance
    over every axis but the channel's (padding included), and running
    statistics updated from the unbiased variance."""
    shape = [1] * x.ndim
    shape[channel_axis] = x.shape[channel_axis]
    if training:
        axes = tuple(i for i in range(x.ndim) if i != channel_axis)
        n = math.prod(x.shape[i] for i in axes)
        mean, var = x.mean(dim=axes), x.var(dim=axes, correction=0)
        new = {"mean": (1 - momentum) * stats["mean"] + momentum * mean.detach(),
               "var": (1 - momentum) * stats["var"] + momentum * var.detach() * (n / max(n - 1, 1))}
    else:
        mean, var, new = stats["mean"], stats["var"], stats
    scale = p["scale"] * torch.rsqrt(var + eps)
    return x * scale.reshape(shape) + (p["bias"] - mean * scale).reshape(shape), new


def silu(x):
    return x * torch.sigmoid(x)


def conv2d(p, x, stride, pr: Precision):
    return F.conv2d(pr.q(x), pr.q(p["w"]), stride=stride) + p["b"].reshape(1, -1, 1, 1)


def conv1d_nhc(p, x, stride, groups, pr: Precision):
    """(B, T, C) in and out."""
    y = F.conv1d(pr.q(x).transpose(1, 2), pr.q(p["w"]), stride=stride, groups=groups)
    return y.transpose(1, 2) + p["b"]


_MASK64 = (1 << 64) - 1


def mix_seed(*values: int) -> int:
    """splitmix64 over each value in turn, as 63 bits: the seed of the
    dropout generator of one (step, layer, site)."""
    z = 0x9E3779B97F4A7C15
    for v in values:
        z = (z ^ (int(v) & _MASK64)) + 0x9E3779B97F4A7C15 & _MASK64
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
        z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK64
        z ^= z >> 31
    return z >> 1


DROPOUT_SITES = ("ff1", "att", "att_out", "conv", "ff2")


def dropout(x, rate, gen):
    """Inverted dropout, its mask drawn from ``gen`` (on ``x``'s device)."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


@functools.lru_cache(maxsize=64)
def _rope(t, rope_dim, offset, device):
    inv = 1.0 / (10_000.0 ** (np.arange(0, rope_dim, 2, dtype=np.float64) / rope_dim))
    freqs = np.arange(-offset, t - offset, dtype=np.float64)[:, None] * inv[None, :]
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.tensor(np.sin(emb), dtype=torch.float32, device=device))


def rope(x, rope_dim, offset):
    """Rotate-half rotary embedding of the first ``rope_dim`` features of
    (B, H, T, dh), positions ``-offset .. T - offset - 1``."""
    cos, sin = _rope(x.shape[2], rope_dim, offset, x.device)
    half = rope_dim // 2
    xr, xp = x[..., :rope_dim], x[..., rope_dim:]
    rot = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    return torch.cat([xr * cos + rot * sin, xp], dim=-1)


# ---------------------------------------------------------------------------
# Frontend.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _frontend_matrices(s: Sizes, device):
    """The windowed, pre-emphasized DFT (win, 2 * n_freqs) and the
    Slaney mel filterbank (n_freqs, n_mels), computed in float64."""
    n = np.arange(s.win, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (s.win - 1)))
    fourier = np.fft.fft(np.eye(s.n_fft))[: s.n_fft // 2 + 1]
    basis = np.concatenate([fourier.real, fourier.imag], axis=0).T * window[:, None]
    pre = np.eye(s.win) - s.preemph * np.diag(np.ones(s.win - 1), k=1)
    pre[0, 0] -= s.preemph
    basis = pre @ basis

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0)
                        / (np.log(6.4) / 27.0), f * 3.0 / 200.0)

    def mel_to_hz(m):
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        m * 200.0 / 3.0)

    n_freqs = s.n_fft // 2 + 1
    freqs = np.linspace(0.0, s.sample_rate / 2.0, n_freqs)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(s.sample_rate / 2.0), s.n_mels + 2))
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]))
    fb = fb * (2.0 / (pts[2: s.n_mels + 2] - pts[: s.n_mels]))[None, :]
    return (torch.tensor(basis, dtype=torch.float32, device=device),
            torch.tensor(fb, dtype=torch.float32, device=device))


def log_mel(s: Sizes, wav: torch.Tensor) -> torch.Tensor:
    """(B, samples) float32 in [-1, 1] (already preceded by the carry) ->
    (B, frames, n_mels); a float32 computation at any precision."""
    basis, fb = _frontend_matrices(s, wav.device)
    frames = wav.unfold(-1, s.win, s.hop)
    spec = torch.matmul(frames, basis)
    b, t, _ = spec.shape
    power = spec.reshape(b, t, 2, -1).square().sum(2)
    return torch.log(torch.matmul(power, fb) + s.log_guard)


# ---------------------------------------------------------------------------
# Encoder blocks.
# ---------------------------------------------------------------------------


def subsampling(p, stats, s: Sizes, feats, tails, pr: Precision, training=False):
    """feats (B, T, feat_in) -> ((B, T/3, D), new tails or None, stats).
    ``tails`` None prepends zero tails (the offline forward)."""
    x = rmsnorm(p["pre_norm"], feats)[:, None]
    new_tails, new_stats = [], dict(stats)
    for i, (c, b) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
        if tails is None:
            x = F.pad(x, (0, 0, s.sub_tails[i], 0))
        else:
            x = torch.cat([tails[i], x], dim=2)
            new_tails.append(x[:, :, -s.sub_tails[i]:, :])
        x = conv2d(p[c], x, s.sub_strides[i], pr)
        x, new_stats[b] = batchnorm(p[b], stats[b], x, 1, training)
        x = silu(x)
    b_, c_, t, f = x.shape
    x = x.transpose(1, 2).reshape(b_, t, c_ * f)
    return rmsnorm(p["out_norm"], linear(p["out"], x, pr)), (new_tails if tails is not None else None), new_stats


def feed_forward(p, x, pr: Precision):
    """lin2(silu(lin1 x) * linv x); the feed-forward of kernel B1."""
    return linear(p["lin2"], silu(linear(p["lin1"], x, pr)) * linear(p["linv"], x, pr), pr)


def attention(p, q_in, kv_in, s: Sizes, k_offset, mask, cached, pr: Precision):
    """Streaming attention of (B, Tq, D) over (B, Tkv, D) with a (B, Tq,
    Tkv) mask (True = masked) or None; ``cached`` scores are reused."""
    b, tq, d = q_in.shape
    tkv = kv_in.shape[1]
    h, dh = s.n_heads, d // s.n_heads
    if cached is None:
        q = layernorm(p["q_ln"], linear(p["linear_q"], q_in, pr).reshape(b, tq, h, dh)).transpose(1, 2)
        k = layernorm(p["k_ln"], linear(p["linear_k"], kv_in, pr).reshape(b, tkv, h, dh)).transpose(1, 2)
        scores = pr.mm(rope(q, s.rope_dim, 0), rope(k, s.rope_dim, k_offset).transpose(-1, -2)) / math.sqrt(dh)
    else:
        scores = cached
    v = linear(p["linear_v"], kv_in, pr).reshape(b, tkv, h, dh).transpose(1, 2)
    if mask is not None:
        m = mask[:, None]
        att = torch.softmax(scores.masked_fill(m, -10000.0), -1).masked_fill(m, 0.0)
    else:
        att = torch.softmax(scores, -1)
    ctx = pr.mm(att, v).transpose(1, 2).reshape(b, tq, d)
    return linear(p["linear_out"], ctx, pr), scores


def _window(xb, nw):
    """(B, H, n, c, dh) -> (B, H, n, (nw + 1) c, dh): each chunk with the
    nw chunks before it (zeros before the start)."""
    if nw == 0:
        return xb
    n = xb.shape[2]
    parts = [F.pad(xb, (0, 0, 0, 0, j, 0))[:, :, :n] for j in range(nw, 0, -1)]
    return torch.cat(parts + [xb], dim=3)


def blocked_attention(p, x, s: Sizes, chunk, left, lengths, cached, pr: Precision, gen=None,
                      rate=0.0):
    """Chunk-local attention of the whole sequence as per-chunk blocks:
    each chunk attends to itself and ``left`` frames before it, within
    ``lengths``.  Dropout (``gen``) on the float32 attention weights."""
    b, t, d = x.shape
    h, dh = s.n_heads, d // s.n_heads
    nw, n = left // chunk, -(-t // chunk)
    tp = n * chunk

    def blocks(y):
        return F.pad(y.transpose(1, 2), (0, 0, 0, tp - t)).reshape(b, h, n, chunk, dh)

    def rot(yb):
        return rope(yb.reshape(b, h, tp, dh), s.rope_dim, 0).reshape(b, h, n, chunk, dh)

    if cached is None:
        q = layernorm(p["q_ln"], linear(p["linear_q"], x, pr).reshape(b, t, h, dh))
        k = layernorm(p["k_ln"], linear(p["linear_k"], x, pr).reshape(b, t, h, dh))
        kwin = _window(rot(blocks(k)), nw)
        scores = pr.mm(rot(blocks(q)), kwin.transpose(-1, -2)) / math.sqrt(dh)
    else:
        scores = cached
    vwin = _window(blocks(linear(p["linear_v"], x, pr).reshape(b, t, h, dh)), nw)
    dev = x.device
    cols = (torch.arange(n, device=dev)[:, None] - nw) * chunk + torch.arange((nw + 1) * chunk, device=dev)
    rows = torch.arange(tp, device=dev).reshape(n, chunk)
    lens = lengths[:, None, None]
    ok = ((rows[None] < lens)[:, :, :, None] & ((cols[None] >= 0) & (cols[None] < lens))[:, :, None, :])
    m = ~ok[:, None]
    att = torch.softmax(scores.masked_fill(m, -10000.0), -1).masked_fill(m, 0.0)
    att = dropout(att, rate, gen)
    ctx = pr.mm(att, vwin).reshape(b, h, tp, dh).transpose(1, 2)[:, :t]
    return linear(p["linear_out"], ctx.reshape(b, t, d), pr), scores


def conv_module(p, stats, x, state, s: Sizes, pr: Precision, pad_mask=None, training=False):
    y = linear(p["pw1"], x, pr)
    a, g = torch.chunk(y, 2, dim=-1)
    y = a * torch.sigmoid(g)
    if pad_mask is not None:
        y = y.masked_fill(pad_mask[:, :, None], 0.0)
    k = s.conv_kernel
    if state is None:
        padded, new_state = F.pad(y, (0, 0, k - 1, 0)), None
    else:
        padded = torch.cat([state, y], dim=1)
        new_state = padded[:, -(k - 1):]
    y = conv1d_nhc(p["dw"], padded, 1, s.d_model, pr)
    y, new_stats = batchnorm(p["bn"], stats, y, 2, training)
    return linear(p["pw2"], silu(y), pr), new_state, new_stats


def reduce_time(p, x, state, s: Sizes, pr: Precision):
    k, r = s.red_kernel, s.red_factor
    if state is None:
        padded, new_state = F.pad(x, (0, 0, k - r, (r - x.shape[1] % r) % r)), None
    else:
        padded = torch.cat([state, x], dim=1)
        new_state = padded[:, -(k - r):]
    return linear(p["pw"], conv1d_nhc(p["dw"], padded, r, s.d_model, pr), pr), new_state


def upsample(x, residual, r):
    y = torch.repeat_interleave(x, r, dim=1)
    t = residual.shape[1]
    if y.shape[1] < t:
        y = torch.cat([y, y.new_zeros(y.shape[0], t - y.shape[1], y.shape[2])], dim=1)
    return y[:, :t] + residual


def head(p, x, pr: Precision):
    return torch.log_softmax(linear(p, x, pr), dim=-1)


# ---------------------------------------------------------------------------
# The streaming step.
# ---------------------------------------------------------------------------


def zero_state(s: Sizes, batch: int, device) -> dict:
    z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    return {"audio": z(batch, s.carry),
            "sub1": z(batch, 1, s.sub_tails[0], s.feat_in),
            "sub2": z(batch, s.sub_channels[0], s.sub_tails[1], s.sub_widths[0]),
            "mhsa": z(s.stateful, batch, s.window, s.d_model),
            "mhsa_len": torch.zeros(batch, dtype=torch.int64, device=device),
            "conv": z(s.n_layers, batch, s.conv_kernel - 1, s.d_model),
            "reduction": z(batch, s.red_kernel - s.red_factor, s.d_model)}


def _state_mask(window, tq, offset):
    cols = torch.arange(window + tq, device=offset.device)[None, :]
    return (cols < offset[:, None])[:, None, :].expand(offset.shape[0], tq, window + tq)


def streaming_step(variables, s: Sizes, chunk: torch.Tensor, state: dict,
                   pr: Precision = FLOAT32) -> tuple[torch.Tensor, dict]:
    """One chunk: ``chunk`` (B, chunk_samples) in the int16 range; returns
    (logprobs (B, chunk frames, vocab), the next state).  ``state`` is not
    changed."""
    params, stats = variables["params"]["encoder"], variables["batch_stats"]
    wav = torch.cat([state["audio"], chunk.to(torch.float32) / 32767.0], dim=1)
    feats = log_mel(s, wav)
    new = {"audio": wav[:, -s.carry:]}
    x, tails, _ = subsampling(params["pre_encode"], stats["pre_encode"], s, feats,
                              (state["sub1"], state["sub2"]), pr)
    new["sub1"], new["sub2"] = tails
    if x.shape[1] != s.chunk:
        raise ValueError(f"a chunk gives {x.shape[1]} frames, the configuration {s.chunk}")
    win_red, r = s.window // s.red_factor, s.red_factor
    offset = s.window - state["mhsa_len"]
    masks = {False: _state_mask(s.window, s.chunk, offset)}
    mhsa, conv = state["mhsa"].clone(), state["conv"].clone()
    red_state, residual, cached = state["reduction"], None, None
    for i in range(s.n_layers):
        p = params["layers"][i]
        if s.recompute[i]:
            cached = None
        y = x + 0.5 * feed_forward(p["ff1"], rmsnorm(p["norm_ff1"], x), pr)
        a = rmsnorm(p["norm_att"], y)
        if i >= s.stateless:
            w = win_red if s.reduced(i) else s.window
            j = i - s.stateless
            window = state["mhsa"][j][:, -w:]
            if s.reduced(i) not in masks:
                masks[True] = _state_mask(win_red, a.shape[1], torch.div(offset, r, rounding_mode="floor"))
            kv = torch.cat([window, a], dim=1)
            att, cached = attention(p["att"], a, kv, s, w, masks[s.reduced(i)], cached, pr)
            kept = torch.cat([window[:, a.shape[1]:], a], dim=1)
            mhsa[j] = F.pad(kept, (0, 0, s.window - kept.shape[1], 0))
        else:
            att, cached = attention(p["att"], a, a, s, 0, None, cached, pr)
        y = y + att
        c, conv[i], _ = conv_module(p["conv"], stats["layers"][i]["conv_bn"],
                                    rmsnorm(p["norm_conv"], y), state["conv"][i], s, pr)
        y = y + c
        y = y + 0.5 * feed_forward(p["ff2"], rmsnorm(p["norm_ff2"], y), pr)
        x = rmsnorm(p["norm_out"], y)
        if i == s.red_pos:
            residual = x
            x, red_state = reduce_time(params["reduction"], x, state["reduction"], s, pr)
        if i == s.up_pos:
            x = upsample(x, residual, r)
    new.update(mhsa=mhsa, conv=conv, reduction=red_state,
               mhsa_len=torch.clamp(state["mhsa_len"] + s.chunk, max=s.window))
    return head(variables["params"]["head"], x, pr), new


# ---------------------------------------------------------------------------
# The offline forward (inference and training).
# ---------------------------------------------------------------------------


def offline_forward(variables, s: Sizes, wav: torch.Tensor, lengths: torch.Tensor | None = None,
                    pr: Precision = FLOAT32, training: bool = False,
                    dropout_seed: int | None = None):
    """Whole utterances: ``wav`` (B, samples) float32 in [-1, 1]; returns
    (logprobs (B, frames, vocab), output lengths, new batch statistics).
    Its function is the streaming step's over the utterance cut into
    chunks from a zero state.  In training the BatchNorms use batch
    statistics and, with ``dropout_seed``, dropout applies with the masks
    of generator ``mix_seed(dropout_seed, layer, site)``."""
    params, stats = variables["params"]["encoder"], variables["batch_stats"]
    b = wav.shape[0]
    dev = wav.device
    feats = log_mel(s, F.pad(wav, (s.carry, 0)))
    if lengths is None:
        lengths = torch.full((b,), wav.shape[1], dtype=torch.int64, device=dev)
    n = torch.div(lengths, s.hop, rounding_mode="floor")
    for k, tail, st in zip(s.sub_kernels, s.sub_tails, s.sub_strides):
        n = torch.div(n - k[0] + tail, st[0], rounding_mode="floor") + 1
    x, _, pre_stats = subsampling(params["pre_encode"], stats["pre_encode"], s, feats, None, pr,
                                  training)
    r = s.red_factor
    t = x.shape[1]
    len_full, len_red = n, torch.div(n, r, rounding_mode="floor")
    pad_full = torch.arange(t, device=dev)[None] >= len_full[:, None]
    pad_red = torch.arange(-(-t // r), device=dev)[None] >= len_red[:, None]
    residual, cached, layer_stats = None, None, []
    for i in range(s.n_layers):
        p = params["layers"][i]
        red = s.reduced(i)
        gens = {}
        if training and dropout_seed is not None:
            gens = {site: torch.Generator(device=dev).manual_seed(mix_seed(dropout_seed, i, k))
                    for k, site in enumerate(DROPOUT_SITES)}
        rate = s.dropout if training else 0.0
        if s.recompute[i]:
            cached = None
        y = x + 0.5 * dropout(feed_forward(p["ff1"], rmsnorm(p["norm_ff1"], x), pr), rate, gens.get("ff1"))
        chunk = s.chunk // r if red else s.chunk
        left = (s.window // r if red else s.window) if i >= s.stateless else 0
        att, cached = blocked_attention(p["att"], rmsnorm(p["norm_att"], y), s, chunk, left,
                                        len_red if red else len_full, cached, pr,
                                        gens.get("att"), s.dropout_att if training else 0.0)
        y = y + dropout(att, rate, gens.get("att_out"))
        c, _, bn = conv_module(p["conv"], stats["layers"][i]["conv_bn"], rmsnorm(p["norm_conv"], y),
                               None, s, pr, pad_red if red else pad_full, training)
        layer_stats.append({"conv_bn": bn})
        y = y + dropout(c, rate, gens.get("conv"))
        y = y + 0.5 * dropout(feed_forward(p["ff2"], rmsnorm(p["norm_ff2"], y), pr), rate,
                              gens.get("ff2"))
        x = rmsnorm(p["norm_out"], y)
        if i == s.red_pos:
            residual = x
            x, _ = reduce_time(params["reduction"], x, None, s, pr)
        if i == s.up_pos:
            x = upsample(x, residual, r)
    new_stats = {"pre_encode": pre_stats, "layers": tuple(layer_stats)} if training else stats
    return (head(variables["params"]["head"], x, pr), torch.clamp(len_red * r, max=t),
            new_stats)
