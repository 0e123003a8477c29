"""The FastConformer encoder and its CTC head (NeMo's ``EncDecCTCModelBPE``
with a FastConformer encoder, e.g. Parakeet-CTC-1.1B): an offline forward
over whole calls, built on the port's shared primitives
(``core/layers.py``).  ``encode_fastconformer`` ends at the encoder's
output, which ``apply_fastconformer`` gives the CTC head,
``core/transducer.py`` a token-and-duration transducer and ``core/aed.py``
a Transformer decoder.

Per call: the centred log-mel frontend with per-feature normalization
(``frontend.log_mel_centered``), the ``dw_striding`` subsampling (a k3 s2
convolution of one input channel and ReLU, then depthwise k3 s2 ->
pointwise -> ReLU stages, then a linear of the channels x remaining mels to
``d_model``), the inputs scaled by sqrt(d_model), and Macaron Conformer
layers in NeMo's order::

    x <- x + 1/2 FF1(LN(x));  x <- x + RelMHSA(LN(x));  x <- x + Conv(LN(x))
    x <- x + 1/2 FF2(LN(x));  x <- LN_out(x)

with FF = Linear -> Swish -> Linear, RelMHSA the relative-position
attention over the full context (``layers.rel_attention_context`` and its
output projection) and Conv = pointwise d -> 2d, GLU, padded frames set to
0, depthwise k (centred), BatchNorm, Swish, pointwise d -> d; then the CTC
head (a linear to the vocabulary and the blank, the last class) and a
float32 log-softmax.

Between sublayers the junction (``ops/norm_junction.py``) takes the
sublayer's last product without its bias and does the bias, the 1/2, the
residual add and the next LayerNorm (after FF2: ``LN_out``, then the next
layer's ``LN_ff1``) in one pass: one kernel launch on the card, the eager
composition on the CPU.  Inside the feed-forwards and the convolution
module the activation passes (``ops/activation_pass.py``) take each
product without its bias and write the next product's input: SiLU after
``linear1``; GLU, the length mask and the edge zeros after ``pw1``, as the
depthwise convolution's input; the convolution's bias, BatchNorm and SiLU
as ``pw2``'s input.

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
rows and layers of valid frames squared), and ``fastconformer.junction_bytes``
(the bytes the junctions must move for the rows' valid frames,
``norm_junction.layer_bytes`` per element of d_model) and
``fastconformer.activation_bytes`` (the bytes the activation passes must
move for them, ``activation_pass.layer_bytes`` per frame and layer); each layer's
attention counts ``fastconformer.attention_pairs_computed``, the
query-key pairs its path computed (``layers.rel_attention_context``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from tone_tpu_torch import profiling
from tone_tpu_torch.config import FASTCONFORMER_CTC, FASTCONFORMER_TDT, FastConformerConfig
from tone_tpu_torch.core import aed
from tone_tpu_torch.core import layers as L
from tone_tpu_torch.core.frontend import get_frontend_constants, log_mel_centered
from tone_tpu_torch.core.transducer import init_transducer_params
from tone_tpu_torch.ops import activation_pass
from tone_tpu_torch.ops.norm_junction import layer_bytes, layer_norm, norm_junction

__all__ = ["apply_fastconformer", "encode_fastconformer", "init_fastconformer_params",
           "parameter_count", "positional_encoding"]

Params = L.Params
INT16_MAX = 32767.0


def init_fastconformer_params(gen: torch.Generator, config: FastConformerConfig) -> dict:
    """All variables ``{"params", "batch_stats"}`` in float32, drawn from
    ``gen`` (torch-default bounds: uniform in 1/sqrt(fan-in)); LayerNorms
    and BatchNorms at their initial values, the position biases at 0.  A
    transducer config gets the prediction network and joint
    (``transducer.init_transducer_params``), an AED config the decoder
    (``aed.init_aed_params``), in the CTC head's place."""
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
    params = {"encoder": {"pre_encode": pre, "layers": tuple(layers)}}
    if config.architecture == FASTCONFORMER_CTC:
        params["head"] = L.init_linear(gen, d, config.vocab_size_with_blank)
    elif config.architecture == FASTCONFORMER_TDT:
        params.update(init_transducer_params(gen, config))
    else:
        params.update(aed.init_aed_params(gen, config))
    return {"params": params, "batch_stats": {"layers": tuple(stats)}}


def parameter_count(config: FastConformerConfig) -> int:
    """The model's parameters as NeMo counts them: every weight, bias, norm
    scale and shift and position bias (and a transducer's embedding, LSTMs
    and joint, or an AED's decoder and head); BatchNorm's running
    statistics are not parameters."""
    e = config.encoder
    d, c, f = e.d_model, e.subsampling_conv_channels, e.d_ff
    pre = (9 * c + c) + (e.n_subsampling_convs - 1) * ((9 * c + c) + (c * c + c)) \
        + (c * e.subsampled_feat * d + d)
    layer = (5 * 2 * d                                  # five LayerNorms
             + 2 * (d * f + f + f * d + d)              # two feed-forwards
             + 4 * (d * d + d) + d * d + 2 * d          # q, k, v, out, pos, u and v
             + (d * 2 * d + 2 * d) + (d * e.conv_kernel_size + d) + 2 * d + (d * d + d))
    t = config.transducer
    if config.architecture == FASTCONFORMER_CTC:
        head = (d + 1) * config.vocab_size_with_blank
    elif config.architecture == FASTCONFORMER_TDT:
        p, j, v = t.pred_hidden, t.joint_hidden, config.vocab_size_with_blank
        head = (v * p + t.pred_rnn_layers * (4 * p * 2 * p + 2 * 4 * p)    # embedding, LSTMs
                + (d + 1) * j + (p + 1) * j + (j + 1) * (v + len(t.durations)))   # joint
    else:
        head = aed.parameter_count(config)
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
    """The feed-forward up to its last product, without that product's
    bias (float32): the activation pass adds linear1's bias and applies
    SiLU, the junction after it adds linear2's bias."""
    h = activation_pass.silu(L.linear_product(p["linear1"], x, dtype), p["linear1"]["b"], dtype)
    return L.linear_product(p["linear2"], h, dtype)


def _conv_module(p: Params, stats: Params, x: torch.Tensor, lengths: torch.Tensor,
                 kernel: int, dtype) -> torch.Tensor:
    """The convolution module up to its last product, without that
    product's bias (float32).  The activation passes write the depthwise
    convolution's (B, d, frames) input (GLU, the length mask, the edge
    zeros) and pw2's (B, T, d) input (the convolution's bias, batch norm,
    SiLU); the convolution runs without its bias."""
    d = x.shape[-1]
    y = activation_pass.glu(L.linear_product(p["pw1"], x, dtype), p["pw1"]["b"], lengths,
                            kernel, dtype)
    y = L.conv1d_nhc({"w": p["dw"]["w"]}, y.transpose(1, 2), stride=1, groups=d,
                     compute_dtype=dtype).transpose(1, 2)
    y = activation_pass.bn_silu(y, p["dw"]["b"], p["bn"], stats, x.shape[1])
    return L.linear_product(p["pw2"], y, dtype)


def _layer(p: Params, stats: Params, x: torch.Tensor, h: torch.Tensor, pos: torch.Tensor,
           lengths: torch.Tensor, host_lengths: list[int], config: FastConformerConfig,
           dtype, next_norm: Params | None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer on the residual stream ``x`` and ``h``, its first input
    (``LN_ff1(x)``, which the junction before made).  Each sublayer ends in
    its bias-less product; the junction (``ops/norm_junction.py``) adds the
    bias, scales, adds the residual and norms for the next sublayer.  The
    last junction ends the layer with ``norm_out`` and norms the output by
    ``next_norm``, the next layer's ``norm_ff1``.  Returns (the layer's
    output, the next layer's first input; None without ``next_norm``)."""
    e = config.encoder
    x, h = norm_junction(_feed_forward(p["ff1"], h, dtype), p["ff1"]["linear2"]["b"], x, 0.5,
                         p["norm_att"])
    ctx = L.rel_attention_context(p["att"], h, pos, n_heads=e.n_heads, lengths=lengths,
                                  host_lengths=host_lengths, compute_dtype=dtype)
    x, h = norm_junction(L.linear_product(p["att"]["linear_out"], ctx, dtype),
                         p["att"]["linear_out"]["b"], x, 1.0, p["norm_conv"])
    x, h = norm_junction(_conv_module(p["conv"], stats["conv_bn"], h, lengths,
                                      e.conv_kernel_size, dtype),
                         p["conv"]["pw2"]["b"], x, 1.0, p["norm_ff2"])
    return norm_junction(_feed_forward(p["ff2"], h, dtype), p["ff2"]["linear2"]["b"], x, 0.5,
                         p["norm_out"], next_norm, layer_end=True)


def _to_device(lengths: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The host lengths on ``device``, queued without waiting for the
    device's queue (pinned, non-blocking on a card)."""
    if device.type == "cuda":
        return lengths.pin_memory().to(device, non_blocking=True)
    return lengths.to(device)


@torch.no_grad()
def encode_fastconformer(variables: dict, config: FastConformerConfig, audio: torch.Tensor,
                         lengths: Sequence[int] | np.ndarray | torch.Tensor,
                         ) -> tuple[torch.Tensor, list[int]]:
    """Whole calls through the FastConformer encoder, each row as if alone.

    Args:
        audio: (B, T_samples) on the device of ``variables``: an integer
            dtype is in the int16 range (scaled by 1/32767), a float dtype
            is taken as it is (in [-1, 1]).
        lengths: (B,) valid samples of each row, on the host.

    Returns:
        (the encoder's output (B, T_out, d_model) in the compute dtype, each
        row's valid output frames).  Frames past a row's are not the row's.

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
        pos = positional_encoding(longest, e.d_model, dev)
        layers = enc["layers"]
        h = layer_norm(x, layers[0]["norm_ff1"])
    for i, (p, stats) in enumerate(zip(layers, variables["batch_stats"]["layers"])):
        with profiling.span("fastconformer.layer", i):
            next_norm = layers[i + 1]["norm_ff1"] if i + 1 < len(layers) else None
            x, h = _layer(p, stats, x, h, pos, out_dev, out_lens, config, dtype, next_norm)
    if profiling.recording():
        profiling.count("fastconformer.frames", sum(out_lens))
        profiling.count("fastconformer.attention_pairs",
                        e.n_layers * sum(n * n for n in out_lens))
        profiling.count("fastconformer.junction_bytes",
                        sum(out_lens) * e.d_model * layer_bytes(len(layers)))
        profiling.count("fastconformer.activation_bytes",
                        sum(out_lens) * e.n_layers * activation_pass.layer_bytes(e.d_model, e.d_ff))
    return x, out_lens


@torch.no_grad()
def apply_fastconformer(variables: dict, config: FastConformerConfig, audio: torch.Tensor,
                        lengths: Sequence[int] | np.ndarray | torch.Tensor,
                        ) -> tuple[torch.Tensor, list[int]]:
    """Whole calls through the FastConformer CTC model
    (``encode_fastconformer``, then the head), each row as if alone.

    Returns:
        (logprobs (B, T_out, vocab + 1) float32, each row's valid output
        frames).  Frames past a row's are not the row's.
    """
    x, out_lens = encode_fastconformer(variables, config, audio, lengths)
    with profiling.span("fastconformer.head"):
        logits = L.linear(variables["params"]["head"], x, torch.float32)
        logprobs = torch.log_softmax(logits.float(), dim=-1)
    return logprobs, out_lens
