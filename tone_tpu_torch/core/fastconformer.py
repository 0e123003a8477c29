"""The FastConformer CTC model (NeMo's ``EncDecCTCModelBPE`` with a
FastConformer encoder, e.g. Parakeet-CTC-1.1B): an offline forward over
whole calls, built on the port's shared primitives (``core/layers.py``).

Per call: the centred log-mel frontend with per-feature normalization
(``frontend.log_mel_centered``), the ``dw_striding`` subsampling (a k3 s2
convolution of one input channel and ReLU, then depthwise k3 s2 ->
pointwise -> ReLU stages, then a linear of the channels x remaining mels to
``d_model``), the inputs scaled by sqrt(d_model), and Macaron Conformer
layers in NeMo's order::

    x <- x + 1/2 FF1(LN(x));  x <- x + RelMHSA(LN(x));  x <- x + Conv(LN(x))
    x <- x + 1/2 FF2(LN(x));  x <- LN_out(x)

with FF = Linear -> Swish -> Linear, RelMHSA the relative-position
attention over the full context (``layers.rel_mhsa_blocked``) and Conv =
pointwise d -> 2d, GLU, padded frames set to 0, depthwise k (centred),
BatchNorm, Swish, pointwise d -> d; then the CTC head (a linear to the
vocabulary and the blank, the last class) and a float32 log-softmax.

Each row is computed as if it were alone: the forward takes every row's
length, the frontend normalizes over the row's own frames, the
subsampling zeroes each stage's frames past the row's before the next
convolution reads them, the attention masks keys past the row's length
and the convolution module zeroes padded frames.

Precision: the port's policy (``core/layers.py``): matrices and
convolution operands in the compute dtype (bf16) with float32 sums, the
residual stream in the compute dtype, LayerNorm, BatchNorm, the softmax
and the log-softmax in float32, the frontend in float32.

Traced (``profiling``), the forward records the spans
``fastconformer.frontend``, ``fastconformer.subsampling``,
``fastconformer.layer`` (id: the layer's index) and ``fastconformer.head``
around their dispatch, and the counts ``fastconformer.frames`` (the rows'
valid output frames) and ``fastconformer.attention_pairs`` (the sum over
rows and layers of valid frames squared); each layer's attention counts
``fastconformer.attention_pairs_computed``, the query-key pairs its path
computed (``layers.rel_mhsa_blocked``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tone_tpu_torch import profiling
from tone_tpu_torch.config import FastConformerConfig
from tone_tpu_torch.core import layers as L
from tone_tpu_torch.core.frontend import get_frontend_constants, log_mel_centered

__all__ = ["apply_fastconformer", "init_fastconformer_params", "parameter_count",
           "positional_encoding"]

Params = L.Params
INT16_MAX = 32767.0


def init_fastconformer_params(gen: torch.Generator, config: FastConformerConfig) -> dict:
    """All variables ``{"params", "batch_stats"}`` in float32, drawn from
    ``gen`` (torch-default bounds: uniform in 1/sqrt(fan-in)); LayerNorms
    and BatchNorms at their initial values, the position biases at 0."""
    e = config.encoder
    d, c, h = e.d_model, e.subsampling_conv_channels, e.n_heads
    stages = tuple({"dw": L.init_conv(gen, c, 1, (3, 3)), "pw": L.init_conv(gen, c, c, (1, 1))}
                   for _ in range(e.n_subsampling_convs - 1))
    pre = {"conv0": L.init_conv(gen, c, 1, (3, 3)), "stages": stages,
           "out": L.init_linear(gen, c * e.subsampled_feat, d)}

    def ff():
        return {"linear1": L.init_linear(gen, d, e.d_ff), "linear2": L.init_linear(gen, e.d_ff, d)}

    layers, stats = [], []
    for _ in range(e.n_layers):
        bn, bn_stats = L.init_batchnorm(d)
        att = {name: L.init_linear(gen, d, d)
               for name in ("linear_q", "linear_k", "linear_v", "linear_out")}
        att.update(linear_pos=L.init_linear(gen, d, d, bias=False),
                   pos_bias_u=torch.zeros(h, e.d_head), pos_bias_v=torch.zeros(h, e.d_head))
        layers.append({
            "norm_ff1": L.init_layernorm(d), "ff1": ff(), "norm_att": L.init_layernorm(d),
            "att": att, "norm_conv": L.init_layernorm(d),
            "conv": {"pw1": L.init_linear(gen, d, 2 * d),
                     "dw": L.init_conv(gen, d, 1, (e.conv_kernel_size,)), "bn": bn,
                     "pw2": L.init_linear(gen, d, d)},
            "norm_ff2": L.init_layernorm(d), "ff2": ff(), "norm_out": L.init_layernorm(d)})
        stats.append({"conv_bn": bn_stats})
    head = L.init_linear(gen, d, config.vocab_size_with_blank)
    return {"params": {"encoder": {"pre_encode": pre, "layers": tuple(layers)}, "head": head},
            "batch_stats": {"layers": tuple(stats)}}


def parameter_count(config: FastConformerConfig) -> int:
    """The model's parameters as NeMo counts them: every weight, bias, norm
    scale and shift and position bias; BatchNorm's running statistics are
    not parameters."""
    e = config.encoder
    d, c, f = e.d_model, e.subsampling_conv_channels, e.d_ff
    pre = (9 * c + c) + (e.n_subsampling_convs - 1) * ((9 * c + c) + (c * c + c)) \
        + (c * e.subsampled_feat * d + d)
    layer = (5 * 2 * d                                  # five LayerNorms
             + 2 * (d * f + f + f * d + d)              # two feed-forwards
             + 4 * (d * d + d) + d * d + 2 * d          # q, k, v, out, pos, u and v
             + (d * 2 * d + 2 * d) + (d * e.conv_kernel_size + d) + 2 * d + (d * d + d))
    head = (d + 1) * config.vocab_size_with_blank
    return pre + e.n_layers * layer + head


def positional_encoding(t: int, d: int, device) -> torch.Tensor:
    """(2t - 1, d) float32 sinusoidal encodings of the relative positions
    ``t - 1`` down to ``-(t - 1)``, NeMo's ``RelPositionalEncoding``: even
    features ``sin(r * w_k)``, odd ``cos(r * w_k)``, ``w_k = 10000^(-2k/d)``,
    computed in float32 as NeMo computes them."""
    positions = torch.arange(t - 1, -t, -1, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(2 * t - 1, d, device=device)
    pe[:, 0::2] = torch.sin(positions * div)
    pe[:, 1::2] = torch.cos(positions * div)
    return pe


def _padding(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B, t) True at and past each row's length."""
    return torch.arange(t, device=lengths.device)[None] >= lengths[:, None]


def _subsampling(p: Params, config: FastConformerConfig, feats: torch.Tensor,
                 frame_lens: torch.Tensor, dtype) -> torch.Tensor:
    """``dw_striding``: (B, T, n_mels) features -> (B, T_out, d_model); each
    stage's frames past the row's length are zeroed before the next
    convolution reads them, as a row alone reads zero padding there."""
    x = L.conv2d(p["conv0"], feats[:, None], (2, 2), dtype, padding=1).relu_()
    lens = torch.div(frame_lens - 1, 2, rounding_mode="floor") + 1
    for stage in p["stages"]:
        x = x.masked_fill_(_padding(lens, x.shape[2])[:, None, :, None], 0.0)
        x = L.conv2d(stage["dw"], x, (2, 2), dtype, padding=1, groups=x.shape[1])
        x = L.conv2d(stage["pw"], x, (1, 1), dtype).relu_()
        lens = torch.div(lens - 1, 2, rounding_mode="floor") + 1
    b, c, t, f = x.shape
    return L.linear(p["out"], x.transpose(1, 2).reshape(b, t, c * f), dtype)


def _feed_forward(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    return L.linear(p["linear2"], L.silu(L.linear(p["linear1"], x, dtype)), dtype)


def _conv_module(p: Params, stats: Params, x: torch.Tensor, pad: torch.Tensor,
                 kernel: int, dtype) -> torch.Tensor:
    y = L.glu(L.linear(p["pw1"], x, dtype), dim=-1).masked_fill_(pad[:, :, None], 0.0)
    y = F.pad(y, (0, 0, (kernel - 1) // 2, (kernel - 1) // 2))
    y = L.conv1d_nhc(p["dw"], y, stride=1, groups=y.shape[-1], compute_dtype=dtype)
    y, _ = L.batchnorm(p["bn"], stats, y, channel_axis=2)
    return L.linear(p["pw2"], L.silu(y), dtype)


def _layer(p: Params, stats: Params, x: torch.Tensor, pos: torch.Tensor,
           lengths: torch.Tensor, pad: torch.Tensor, host_lengths: list[int],
           config: FastConformerConfig, dtype) -> torch.Tensor:
    e = config.encoder
    x = x + _feed_forward(p["ff1"], L.layernorm(p["norm_ff1"], x), dtype) * 0.5
    x = x + L.rel_mhsa_blocked(p["att"], L.layernorm(p["norm_att"], x), pos,
                               n_heads=e.n_heads, lengths=lengths, host_lengths=host_lengths,
                               compute_dtype=dtype)
    x = x + _conv_module(p["conv"], stats["conv_bn"], L.layernorm(p["norm_conv"], x), pad,
                         e.conv_kernel_size, dtype)
    x = x + _feed_forward(p["ff2"], L.layernorm(p["norm_ff2"], x), dtype) * 0.5
    return L.layernorm(p["norm_out"], x)


def _to_device(lengths: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The host lengths on ``device``, queued without waiting for the
    device's queue (pinned, non-blocking on a card)."""
    if device.type == "cuda":
        return lengths.pin_memory().to(device, non_blocking=True)
    return lengths.to(device)


@torch.no_grad()
def apply_fastconformer(variables: dict, config: FastConformerConfig, audio: torch.Tensor,
                        lengths: Sequence[int] | np.ndarray | torch.Tensor,
                        ) -> tuple[torch.Tensor, list[int]]:
    """Whole calls through the FastConformer CTC model, each row as if alone.

    Args:
        audio: (B, T_samples) on the device of ``variables``: an integer
            dtype is in the int16 range (scaled by 1/32767), a float dtype
            is taken as it is (in [-1, 1]).
        lengths: (B,) valid samples of each row, on the host.

    Returns:
        (logprobs (B, T_out, vocab + 1) float32, each row's valid output
        frames).  Frames past a row's are not the row's.

    Raises:
        ValueError: ``config.compute_dtype`` other than bfloat16 on a CUDA
            device (the attention kernel computes in bf16), before any work.
    """
    dev = audio.device
    dtype = getattr(torch, config.compute_dtype)
    if dev.type == "cuda" and dtype != torch.bfloat16:
        raise ValueError(f"apply_fastconformer: on a CUDA device the attention kernel computes "
                         f"in bf16; compute_dtype {config.compute_dtype!r} runs on the CPU only")
    host = torch.as_tensor(np.asarray(lengths), dtype=torch.int64).cpu()
    out_lens = [config.output_frames(int(n)) for n in host]
    longest = max(out_lens)
    e = config.encoder
    enc = variables["params"]["encoder"]

    with profiling.span("fastconformer.frontend"):
        wav = (audio.to(torch.float32) if audio.dtype.is_floating_point
               else audio.to(torch.float32) / INT16_MAX)
        dev_lengths = _to_device(host, dev)
        feats, frame_lens = log_mel_centered(wav, dev_lengths,
                                             get_frontend_constants(config.frontend, dev))
    with profiling.span("fastconformer.subsampling"):
        x = _subsampling(enc["pre_encode"], config, feats, frame_lens, dtype)
        x = x * math.sqrt(e.d_model)
        out_dev = _to_device(torch.tensor(out_lens, dtype=torch.int64), dev)
        pad = _padding(out_dev, x.shape[1])
        pos = positional_encoding(longest, e.d_model, dev)
    for i, (p, stats) in enumerate(zip(enc["layers"], variables["batch_stats"]["layers"])):
        with profiling.span("fastconformer.layer", i):
            x = _layer(p, stats, x, pos, out_dev, pad, out_lens, config, dtype)
    with profiling.span("fastconformer.head"):
        logits = L.linear(variables["params"]["head"], x, torch.float32)
        logprobs = torch.log_softmax(logits.float(), dim=-1)
    if profiling.recording():
        profiling.count("fastconformer.frames", sum(out_lens))
        profiling.count("fastconformer.attention_pairs",
                        e.n_layers * sum(n * n for n in out_lens))
    return logprobs, out_lens
