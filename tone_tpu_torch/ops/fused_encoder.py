"""The streaming step with each Conformer layer as one fused kernel (port of
``tone_tpu/ops/fused_encoder.py``).

Computes what ``core.model.apply_streaming`` computes, with the same state
and outputs, but runs each of the 16 layers through
``ops.fused_layer.fused_conformer_layer``: on the card one launch of
``csrc/fused_layer.cu`` per layer, on the CPU its plain version.  The
frontend, subsampling, temporal reduction and upsample and the CTC head
stay the eager step's.  Weights are packed once per model
(``prepare_fused_params``).

The path is bf16 (the packing casts every matrix to bf16); on the card a
float32 config raises.  Unlike the JAX package's, ``apply_streaming_fused``
honours ``emulate_reference_fp16`` as ``apply_streaming`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tone_tpu_torch.config import EncoderConfig, ToneConfig
from tone_tpu_torch.core.encoder import (
    EncoderStreamState,
    _subsampling,
    _temporal_reduction,
    _temporal_upsample,
)
from tone_tpu_torch.core.frontend import FrontendConstants, get_frontend_constants, log_mel_streaming
from tone_tpu_torch.core.model import INT16_MAX, StreamingState, _head
from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.ops.fused_layer import (
    FusedLayerWeights,
    flatten_layer_params,
    fused_conformer_layer,
)

__all__ = ["FusedLayerPlan", "apply_streaming_fused", "encoder_streaming_step_fused",
           "prepare_fused_params"]


@dataclass(frozen=True)
class FusedLayerPlan:
    layers: tuple[FusedLayerWeights, ...]  # one packed layer per encoder layer


def _layer_static(cfg: EncoderConfig, i: int) -> dict:
    in_reduced = cfg.reduction_position < i <= cfg.upsample_position
    stateful = i >= cfg.mhsa_stateless_layers
    red = cfg.reduction_factor if in_reduced else 1
    return {
        "t": cfg.chunk_size // red,
        "window": cfg.mhsa_state_size // red if stateful else 0,
        "recompute": cfg.should_recompute_att_scores[i],
        "stateful": stateful,
        "in_reduced": in_reduced,
    }


def prepare_fused_params(variables, cfg: ToneConfig,
                         device: str | torch.device | None = None) -> FusedLayerPlan:
    """Pack every layer's weights for the fused kernel (call once), on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and cfg.compute_dtype != "bfloat16":
        raise TypeError("the fused layer kernel computes in bf16; the config's "
                        f"compute_dtype is {cfg.compute_dtype}")
    e = cfg.encoder
    layers = []
    for i in range(e.n_layers):
        st = _layer_static(e, i)
        layers.append(flatten_layer_params(
            variables["params"]["encoder"]["layers"][i], variables["batch_stats"]["layers"][i],
            e, t=st["t"], window=st["window"], recompute=st["recompute"], device=dev))
    return FusedLayerPlan(layers=tuple(layers))


def encoder_streaming_step_fused(variables, plan: FusedLayerPlan, cfg: EncoderConfig,
                                 feats: torch.Tensor, state: EncoderStreamState,
                                 dtype=torch.bfloat16) -> tuple[torch.Tensor, EncoderStreamState]:
    """``core.encoder.encoder_streaming_step`` with fused layers.
    ``state.conv`` and ``state.mhsa`` are updated in place, as there."""
    params = variables["params"]["encoder"]
    stats = variables["batch_stats"]
    x, new_subs = _subsampling(params["pre_encode"], stats["pre_encode"], cfg, feats,
                               (state.sub1, state.sub2), dtype)
    if x.shape[1] != cfg.chunk_size:
        raise ValueError(f"chunk gives {x.shape[1]} frames, expected {cfg.chunk_size}")

    invalid_full = torch.clamp(cfg.mhsa_state_size - state.mhsa_len, min=0)
    invalid_full = invalid_full.to(torch.int32)[:, None].contiguous()
    invalid_red = torch.div(invalid_full, cfg.reduction_factor, rounding_mode="floor")

    residual_pre_reduction = None
    scores = None
    new_red_state = state.reduction
    for i, w in enumerate(plan.layers):
        st = _layer_static(cfg, i)
        win = invalid = stored = None
        if st["stateful"]:
            stored = state.mhsa[i - cfg.mhsa_stateless_layers]
            win = stored[:, -st["window"]:, :].to(dtype).contiguous()
            invalid = invalid_red if st["in_reduced"] else invalid_full
        x, new_conv, new_win, scores = fused_conformer_layer(
            x.to(dtype).contiguous(), state.conv[i].to(dtype), win, invalid,
            None if st["recompute"] else scores, w,
            t=st["t"], window=st["window"], recompute=st["recompute"],
            n_heads=cfg.n_heads, rope_dim=cfg.rope_dim, conv_k=cfg.conv_kernel_size)
        state.conv[i].copy_(new_conv)
        if stored is not None:
            # Stored padded to mhsa_state_size rows with zeros in front.
            pad = cfg.mhsa_state_size - new_win.shape[1]
            stored[:, :pad].zero_()
            stored[:, pad:].copy_(new_win)

        if i == cfg.reduction_position:
            residual_pre_reduction = x
            x, new_red_state = _temporal_reduction(params["reduction"], x, state.reduction,
                                                   cfg, dtype)
        if i == cfg.upsample_position:
            x = _temporal_upsample(x, residual_pre_reduction, cfg.reduction_factor)

    new_state = EncoderStreamState(
        sub1=new_subs[0].to(state.sub1.dtype),
        sub2=new_subs[1].to(state.sub2.dtype),
        mhsa=state.mhsa,
        conv=state.conv,
        mhsa_len=torch.clamp(state.mhsa_len + cfg.chunk_size, max=cfg.mhsa_state_size),
        reduction=new_red_state.to(state.reduction.dtype),
    )
    return x, new_state


@torch.no_grad()
def apply_streaming_fused(variables, plan: FusedLayerPlan, config: ToneConfig,
                          audio_chunk: torch.Tensor, state: StreamingState,
                          constants: FrontendConstants | None = None,
                          ) -> tuple[torch.Tensor, StreamingState]:
    """``core.model.apply_streaming`` with the fused layers of ``plan``:
    the same arguments (``variables`` and ``state`` on the device of
    ``audio_chunk``) and results; the state's conv and mhsa stacks are
    updated in place."""
    if constants is None:
        constants = get_frontend_constants(config.frontend, audio_chunk.device)
    wav = audio_chunk.to(torch.float32) / INT16_MAX
    preproc = state.preproc.to(torch.float32)
    if config.emulate_reference_fp16:
        wav = wav.to(torch.float16).to(torch.float32)
        preproc = preproc.to(torch.float16).to(torch.float32)
    feats, preproc_next = log_mel_streaming(wav, preproc, constants)
    encoded, enc_state = encoder_streaming_step_fused(
        variables, plan, config.encoder, feats, state.encoder,
        getattr(torch, config.compute_dtype))
    logprobs = _head(variables["params"]["head"], encoded)
    return logprobs, StreamingState(preproc=preproc_next.to(state.preproc.dtype),
                                    encoder=enc_state)
