"""Streaming Conformer encoder (port of ``tone_tpu/core/encoder.py``,
streaming half; the offline/training half waits for the training slice).

Architecture (the reference's ToneConfig contract):
  * conv subsampling x3 in time with carried input tails;
  * 16 Macaron Conformer layers (GLU feed-forward halves, rotary MHSA with
    per-head q/k LayerNorm, causal depthwise conv k=31, RMSNorm);
  * temporal reduction x2 after layer 6, upsample + residual after layer 14;
  * layers 0..13 attend only within the chunk; layers 14..15 carry a
    sliding window of 30 (15 when reduced) pre-projection frames;
  * attention scores computed at layers {0, 7, 14, 15} and reused between.

State tensors keep the reference's layouts: ``mhsa`` and ``conv`` stacked
with the layer axis first (batch axis 1), conv and reduction tails
time-major.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tone_tpu_torch.config import EncoderConfig
from tone_tpu_torch.core import layers as L
from tone_tpu_torch.ops.glu_ff import glu_ff2

Params = L.Params


@dataclass
class EncoderStreamState:
    """Per-stream recurrent state for one streaming step.

    ``mhsa`` windows are stored padded to ``mhsa_state_size`` rows with
    zeros in front; ``mhsa_len`` counts the valid trailing rows, for the
    masks of the first chunks.
    """

    sub1: torch.Tensor  # (B, 1, sub_state0, feat_in)
    sub2: torch.Tensor  # (B, C0, sub_state1, hidden_feat0)
    mhsa: torch.Tensor  # (n_stateful, B, mhsa_state_size, d_model)
    conv: torch.Tensor  # (n_layers, B, conv_kernel - 1, d_model) — time-major
    mhsa_len: torch.Tensor  # (B,) int32
    reduction: torch.Tensor  # (B, reduction_state, d_model) — time-major

    # Index of the stream (batch) axis of each field.
    BATCH_AXES = {"sub1": 0, "sub2": 0, "mhsa": 1, "conv": 1, "mhsa_len": 0,
                  "reduction": 0}

    def map(self, fn, *others: "EncoderStreamState") -> "EncoderStreamState":
        """A new state of ``fn(tensor, *other_tensors, batch_axis)`` for each
        field, with ``other_tensors`` the same field of each of ``others``."""
        return EncoderStreamState(**{
            f.name: fn(getattr(self, f.name), *(getattr(o, f.name) for o in others),
                       self.BATCH_AXES[f.name])
            for f in dataclasses.fields(self)})


def init_encoder_state(cfg: EncoderConfig, batch_size: int, dtype=torch.float32,
                       device: torch.device | str = "cpu") -> EncoderStreamState:
    """Zero streaming state."""
    sub_lens = cfg.subsampling_state_lens
    sub_h = cfg.subsampling_hidden_features

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return EncoderStreamState(
        sub1=zeros(batch_size, 1, sub_lens[0], cfg.feat_in),
        sub2=zeros(batch_size, cfg.subsampling_conv_channels[0], sub_lens[1], sub_h[0]),
        mhsa=zeros(cfg.n_stateful_mhsa_layers, batch_size, cfg.mhsa_state_size, cfg.d_model),
        conv=zeros(cfg.n_layers, batch_size, cfg.conv_state_size, cfg.d_model),
        mhsa_len=zeros(batch_size, dt=torch.int32),
        reduction=zeros(batch_size, cfg.reduction_state_size, cfg.d_model),
    )


# ---------------------------------------------------------------------------
# Parameter init (the reference's layout).
# ---------------------------------------------------------------------------


def _init_ff(gen, d_model: int, d_ff: int) -> Params:
    return {
        "lin1": L.init_linear(gen, d_model, d_ff),
        "linv": L.init_linear(gen, d_model, d_ff),
        "lin2": L.init_linear(gen, d_ff, d_model),
    }


def init_encoder_params(gen: torch.Generator, cfg: EncoderConfig) -> tuple[Params, Params]:
    """Returns (params, batch_stats) with the reference's tree layout
    (``tone_tpu/core/encoder.py:81-145``), float32 on the generator's device."""
    ch = cfg.subsampling_conv_channels
    ks = cfg.subsampling_kernel_size
    sub_h = cfg.subsampling_hidden_features

    bn1_p, bn1_s = L.init_batchnorm(ch[0])
    bn2_p, bn2_s = L.init_batchnorm(ch[1])
    pre_encode = {
        "pre_norm": L.init_rmsnorm(cfg.feat_in),
        "conv1": L.init_conv(gen, ch[0], 1, ks[0]),
        "bn1": bn1_p,
        "conv2": L.init_conv(gen, ch[1], ch[0], ks[1]),
        "bn2": bn2_p,
        "out": L.init_linear(gen, ch[1] * sub_h[1], cfg.d_model, bias=False),
        "out_norm": L.init_rmsnorm(cfg.d_model),
    }

    layer_params = []
    layer_stats = []
    for i in range(cfg.n_layers):
        bn_p, bn_s = L.init_batchnorm(cfg.d_model)
        layer_params.append({
            "norm_ff1": L.init_rmsnorm(cfg.d_model),
            "ff1": _init_ff(gen, cfg.d_model, cfg.d_ff),
            "norm_att": L.init_rmsnorm(cfg.d_model),
            "att": L.init_mhsa(gen, cfg.d_model, cfg.n_heads,
                             cfg.should_recompute_att_scores[i]),
            "norm_conv": L.init_rmsnorm(cfg.d_model),
            "conv": {
                "pw1": L.init_linear(gen, cfg.d_model, cfg.d_model * 2),
                "dw": L.init_conv(gen, cfg.d_model, 1, (cfg.conv_kernel_size,)),
                "bn": bn_p,
                "pw2": L.init_linear(gen, cfg.d_model, cfg.d_model),
            },
            "norm_ff2": L.init_rmsnorm(cfg.d_model),
            "ff2": _init_ff(gen, cfg.d_model, cfg.d_ff),
            "norm_out": L.init_rmsnorm(cfg.d_model),
        })
        layer_stats.append({"conv_bn": bn_s})

    reduction = {
        # depthwise with a channel multiplier of 4: out 4*d_model, groups d_model
        "dw": L.init_conv(gen, cfg.d_model * 4, 1, (cfg.reduction_kernel_size,)),
        "pw": L.init_linear(gen, cfg.d_model * 4, cfg.d_model),
    }
    params = {"pre_encode": pre_encode, "layers": tuple(layer_params), "reduction": reduction}
    batch_stats = {"pre_encode": {"bn1": bn1_s, "bn2": bn2_s}, "layers": tuple(layer_stats)}
    return params, batch_stats


# ---------------------------------------------------------------------------
# Sub-modules.
# ---------------------------------------------------------------------------


def _feed_forward(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    """GLU-gated feed-forward: lin2(silu(lin1 x) * linv x).

    Serving weights carry the merged in-projection ``lin12``
    (acoustic.cast_params_for_inference): one (D, 2F) matmul, then the
    fused gate + output projection of ops/glu_ff.py — the Hopper kernel on
    CUDA tensors, its plain version on CPU tensors."""
    if "lin12" in p:
        return glu_ff2(L.linear(p["lin12"], x, dtype), p["lin2"], dtype)
    gate = L.silu(L.linear(p["lin1"], x, dtype))
    return L.linear(p["lin2"], gate * L.linear(p["linv"], x, dtype), dtype)


def _conv_module(p: Params, bn_stats: Params, x: torch.Tensor,
                 conv_state: torch.Tensor, kernel_size: int,
                 dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """pointwise -> GLU -> causal depthwise (over conv_state ‖ chunk) -> BN
    -> SiLU -> pointwise, feature-last.  Returns (output, next conv_state)."""
    d = x.shape[-1]
    y = L.glu(L.linear(p["pw1"], x, dtype), dim=-1)  # (B, T, D)
    padded = torch.cat([conv_state.to(y.dtype), y], dim=1)
    next_state = padded[:, -(kernel_size - 1):, :]
    y = L.conv1d_nhc(p["dw"], padded, stride=1, groups=d, compute_dtype=dtype)
    y = L.batchnorm(p["bn"], bn_stats, y, channel_axis=2)
    y = L.linear(p["pw2"], L.silu(y), dtype)
    return y, next_state


def _subsampling(p: Params, stats: Params, cfg: EncoderConfig, feats: torch.Tensor,
                 sub_states: tuple[torch.Tensor, torch.Tensor],
                 dtype) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Conv subsampling (x3 in time) with carried input tails.

    Returns ((B, T_out, d_model), next tails)."""
    sub_lens = cfg.subsampling_state_lens
    x = L.rmsnorm(p["pre_norm"], feats.to(dtype))
    x = x[:, None, :, :]  # (B, 1, T, F) — NCHW with time as H

    new_states = []
    for i, (conv_name, bn_name) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
        x = torch.cat([sub_states[i].to(x.dtype), x], dim=2)
        new_states.append(x[:, :, -sub_lens[i]:, :])
        x = L.conv2d(p[conv_name], x, cfg.subsampling_strides[i], dtype)
        x = L.silu(L.batchnorm(p[bn_name], stats[bn_name], x, channel_axis=1))

    # (B, C, T_out, F_out) -> (B, T_out, C * F_out) with (channel, freq) order.
    b, c, t_out, f_out = x.shape
    x = x.transpose(1, 2).reshape(b, t_out, c * f_out)
    x = L.rmsnorm(p["out_norm"], L.linear(p["out"], x, dtype))
    return x, (new_states[0], new_states[1])


def _temporal_reduction(p: Params, x: torch.Tensor, red_state: torch.Tensor,
                        cfg: EncoderConfig, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise stride-2 conv (x4 channels) + pointwise."""
    k, r = cfg.reduction_kernel_size, cfg.reduction_factor
    padded = torch.cat([red_state.to(x.dtype), x], dim=1)
    next_state = padded[:, -(k - r):, :]
    y = L.conv1d_nhc(p["dw"], padded, stride=r, groups=cfg.d_model, compute_dtype=dtype)
    return L.linear(p["pw"], y, dtype), next_state  # (B, T_red, 4D) -> (B, T_red, D)


def _temporal_upsample(x: torch.Tensor, residual: torch.Tensor, factor: int) -> torch.Tensor:
    """repeat_interleave x factor (zero-padded to the residual's length)
    plus the pre-reduction residual."""
    t_res = residual.shape[1]
    y = torch.repeat_interleave(x, factor, dim=1)
    if y.shape[1] < t_res:
        y = torch.cat([y, y.new_zeros(y.shape[0], t_res - y.shape[1], y.shape[2])], dim=1)
    return y[:, :t_res, :] + residual


def _conformer_layer(p: Params, bn_stats: Params, x: torch.Tensor, *,
                     cfg: EncoderConfig, mhsa_window: torch.Tensor | None,
                     k_offset: int, att_mask: torch.Tensor | None,
                     cached_scores: torch.Tensor | None, conv_state: torch.Tensor,
                     dtype):
    """One Macaron Conformer block.

    Returns (output, scores, new_mhsa_window or None, new_conv_state)."""
    residual = x + _feed_forward(p["ff1"], L.rmsnorm(p["norm_ff1"], x), dtype) * 0.5

    a_in = L.rmsnorm(p["norm_att"], residual)
    if mhsa_window is not None:
        kv = torch.cat([mhsa_window.to(a_in.dtype), a_in], dim=1)
        # Slide: drop the oldest tq rows, append the new pre-projection frames.
        new_window = torch.cat([mhsa_window[:, a_in.shape[1]:, :].to(a_in.dtype), a_in], dim=1)
    else:
        kv = a_in
        new_window = None
    y, scores = L.mhsa(p["att"], a_in, kv, n_heads=cfg.n_heads, rope_dim=cfg.rope_dim,
                       k_offset=k_offset, mask=att_mask, cached_scores=cached_scores,
                       compute_dtype=dtype)
    residual = residual + y

    y, new_conv_state = _conv_module(p["conv"], bn_stats["conv_bn"],
                                     L.rmsnorm(p["norm_conv"], residual), conv_state,
                                     cfg.conv_kernel_size, dtype)
    residual = residual + y

    residual = residual + _feed_forward(p["ff2"], L.rmsnorm(p["norm_ff2"], residual),
                                        dtype) * 0.5
    return L.rmsnorm(p["norm_out"], residual), scores, new_window, new_conv_state


def _state_mask(window: int, tq: int, offset: torch.Tensor) -> torch.Tensor:
    """(B, tq, window + tq) True where a key column is an invalid (not yet
    filled) leading window row; chunk columns are never masked."""
    cols = torch.arange(window + tq, dtype=torch.int32, device=offset.device)[None, :]
    masked = cols < offset[:, None]
    return masked[:, None, :].expand(masked.shape[0], tq, window + tq)


def encoder_streaming_step(params: Params, batch_stats: Params, cfg: EncoderConfig,
                           feats: torch.Tensor, state: EncoderStreamState,
                           dtype=torch.bfloat16) -> tuple[torch.Tensor, EncoderStreamState]:
    """One chunk of features through the encoder with carried state.

    ``state.conv`` and ``state.mhsa`` are updated IN PLACE and returned in
    the new state, as the reference's donated ``.at[i].set`` updates are:
    the caller's state is consumed.

    Args:
        feats: (B, feat_frames, feat_in) log-mel features (30 frames per
            300 ms chunk).

    Returns:
        (encoded (B, chunk_size, d_model), next state).
    """
    n_red = cfg.reduction_factor
    win_full = cfg.mhsa_state_size  # 30
    win_red = win_full // n_red  # 15
    chunk_full = cfg.chunk_size  # 10
    chunk_red = chunk_full // n_red  # 5

    x, new_subs = _subsampling(params["pre_encode"], batch_stats["pre_encode"], cfg,
                               feats, (state.sub1, state.sub2), dtype)
    if x.shape[1] != chunk_full:
        raise ValueError(f"chunk gives {x.shape[1]} frames, expected {chunk_full}")

    offset_full = (win_full - state.mhsa_len).to(torch.int32)
    mask_red = _state_mask(win_red, chunk_red, torch.div(offset_full, n_red,
                                                          rounding_mode="floor"))
    mask_full = _state_mask(win_full, chunk_full, offset_full)

    residual_pre_reduction = None
    cached_scores = None
    new_red_state = state.reduction
    for i in range(cfg.n_layers):
        stateful = i >= cfg.mhsa_stateless_layers
        in_reduced = cfg.reduction_position < i <= cfg.upsample_position
        if stateful:
            window = win_red if in_reduced else win_full
            mhsa_window = state.mhsa[i - cfg.mhsa_stateless_layers][:, -window:, :]
            k_offset = window
            att_mask = mask_red if in_reduced else mask_full
        else:
            mhsa_window, k_offset, att_mask = None, 0, None
        if cfg.should_recompute_att_scores[i]:
            cached_scores = None

        x, cached_scores, new_window, new_conv = _conformer_layer(
            params["layers"][i], batch_stats["layers"][i], x, cfg=cfg,
            mhsa_window=mhsa_window, k_offset=k_offset, att_mask=att_mask,
            cached_scores=cached_scores, conv_state=state.conv[i], dtype=dtype)
        state.conv[i].copy_(new_conv)
        if stateful:
            # Stored padded to mhsa_state_size rows with zeros in front.
            stored = state.mhsa[i - cfg.mhsa_stateless_layers]
            pad = cfg.mhsa_state_size - new_window.shape[1]
            stored[:, :pad].zero_()
            stored[:, pad:].copy_(new_window)

        if i == cfg.reduction_position:
            residual_pre_reduction = x
            x, new_red_state = _temporal_reduction(params["reduction"], x, state.reduction,
                                                   cfg, dtype)
        if i == cfg.upsample_position:
            x = _temporal_upsample(x, residual_pre_reduction, n_red)

    new_state = EncoderStreamState(
        sub1=new_subs[0].to(state.sub1.dtype),
        sub2=new_subs[1].to(state.sub2.dtype),
        mhsa=state.mhsa,
        conv=state.conv,
        mhsa_len=torch.clamp(state.mhsa_len + chunk_full, max=win_full),
        reduction=new_red_state.to(state.reduction.dtype),
    )
    return x, new_state
