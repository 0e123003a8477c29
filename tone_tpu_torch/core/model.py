"""The full acoustic model: frontend + Conformer encoder + CTC head (port of
``tone_tpu/core/model.py``).

``apply_streaming(variables, config, audio_chunk, state)`` runs one 300 ms
chunk with explicit recurrent state in and state out;
``apply_offline(variables, config, audio, lengths)`` runs whole utterances
through the full-sequence forward, whose chunk-simulating masks give the
chunked streaming step's output.  ``pack_state`` /
``unpack_state`` convert the state to and from the reference-compatible
flat ``(B, 219729)`` fp16 blob with the JAX package's layout, so a stream
can move between the two packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tone_tpu_torch.config import ToneConfig
from tone_tpu_torch.core import layers as L
from tone_tpu_torch.core.encoder import (
    EncoderStreamState,
    encoder_offline,
    encoder_streaming_step,
    init_encoder_params,
    init_encoder_state,
)
from tone_tpu_torch.core.frontend import (
    FrontendConstants,
    get_frontend_constants,
    log_mel_offline,
    log_mel_streaming,
)

Params = L.Params

INT16_MAX = 32767.0


@dataclass
class StreamingState:
    """Full per-stream recurrent state: preprocessor carry + encoder state."""

    preproc: torch.Tensor  # (B, frontend.state_size)
    encoder: EncoderStreamState

    def map(self, fn, *others: "StreamingState") -> "StreamingState":
        """A new state of ``fn(tensor, *other_tensors, batch_axis)`` for each
        tensor, with ``other_tensors`` the same tensor of each of ``others``."""
        return StreamingState(
            preproc=fn(self.preproc, *(o.preproc for o in others), 0),
            encoder=self.encoder.map(fn, *(o.encoder for o in others)))


def init_model_params(gen: torch.Generator, config: ToneConfig) -> dict[str, Params]:
    """All model variables ``{"params", "batch_stats"}`` in float32, drawn from
    ``gen`` (on the generator's device) with the reference's tree layout."""
    enc_params, enc_stats = init_encoder_params(gen, config.encoder)
    head = L.init_linear(gen, config.encoder.d_model, config.vocab_size_with_blank)
    return {"params": {"encoder": enc_params, "head": head}, "batch_stats": enc_stats}


def init_streaming_state(config: ToneConfig, batch_size: int, dtype=None,
                         device: torch.device | str = "cpu") -> StreamingState:
    if dtype is None:
        dtype = getattr(torch, config.resolved_state_dtype)
    return StreamingState(
        preproc=torch.zeros((batch_size, config.frontend.state_size), dtype=dtype,
                            device=device),
        encoder=init_encoder_state(config.encoder, batch_size, dtype, device),
    )


def _head(params: Params, encoded: torch.Tensor) -> torch.Tensor:
    """1x1-conv CTC head as a float32 matmul (bf16-cast weights widened),
    then a float32 log-softmax."""
    logits = L.linear(params, encoded, torch.float32)
    return torch.log_softmax(logits.float(), dim=-1)


@torch.no_grad()
def apply_streaming(variables: dict[str, Params], config: ToneConfig,
                    audio_chunk: torch.Tensor, state: StreamingState,
                    constants: FrontendConstants | None = None,
                    ) -> tuple[torch.Tensor, StreamingState]:
    """One streaming step on a 300 ms chunk.

    Args:
        audio_chunk: (B, chunk_samples) integer (or float) audio in the int16
            range, on the device of ``state``; scaled by 1/32767.
        state: previous ``StreamingState``; its encoder conv and mhsa stacks
            are updated in place (encoder_streaming_step).

    Returns:
        (logprobs (B, chunk_size, vocab+1) float32, next state).
    """
    if constants is None:
        constants = get_frontend_constants(config.frontend, audio_chunk.device)
    dtype = getattr(torch, config.compute_dtype)

    wav = audio_chunk.to(torch.float32) / INT16_MAX
    preproc = state.preproc.to(torch.float32)
    if config.emulate_reference_fp16:
        # The reference's streaming entry quantizes the normalized waveform
        # (and hence the 80-sample carry) to fp16.
        wav = wav.to(torch.float16).to(torch.float32)
        preproc = preproc.to(torch.float16).to(torch.float32)
    feats, preproc_next = log_mel_streaming(wav, preproc, constants)

    encoded, enc_state = encoder_streaming_step(
        variables["params"]["encoder"], variables["batch_stats"], config.encoder,
        feats, state.encoder, dtype)
    logprobs = _head(variables["params"]["head"], encoded)
    return logprobs, StreamingState(preproc=preproc_next.to(state.preproc.dtype),
                                    encoder=enc_state)


@torch.no_grad()
def apply_offline(variables: dict[str, Params], config: ToneConfig, audio: torch.Tensor,
                  lengths: torch.Tensor | None = None,
                  constants: FrontendConstants | None = None, training: bool = False,
                  blocked_attention: bool = True,
                  ) -> tuple[torch.Tensor, torch.Tensor, dict[str, Params]]:
    """Full-sequence forward of whole utterances (inference).

    Args:
        audio: (B, T_samples) waveform on the device of ``variables``: an
            integer dtype is in the int16 range (scaled by 1/32767), a float
            dtype is taken as it is (already in [-1, 1]).
        lengths: (B,) valid sample counts, or None.
        training: must be False; dropout and BatchNorm statistic updates come
            with the training slice (ROADMAP A13).
        blocked_attention: chunk-local attention as per-chunk blocks (the
            default) or as masked (T, T) products.

    Returns:
        (logprobs (B, T_frames_out, vocab+1) float32, output lengths (B,),
         batch_stats).
    """
    if training:
        raise NotImplementedError(
            "apply_offline(training=True): dropout and BatchNorm statistic "
            "updates are not ported yet (ROADMAP A13, training)")
    if constants is None:
        constants = get_frontend_constants(config.frontend, audio.device)
    dtype = getattr(torch, config.compute_dtype)

    if audio.dtype.is_floating_point:
        wav = audio.to(torch.float32)
    else:
        wav = audio.to(torch.float32) / INT16_MAX
    feats, feat_lens = log_mel_offline(wav, lengths, constants)
    encoded, out_len, stats = encoder_offline(
        variables["params"]["encoder"], variables["batch_stats"], config.encoder,
        feats, feat_lens, dtype, blocked_attention=blocked_attention)
    return _head(variables["params"]["head"], encoded), out_len, stats


# ---------------------------------------------------------------------------
# Flat fp16 state packing (reference-compatible 219,729-element blob).
# Per batch row, concatenated in this order (the JAX package's layout):
#
#   [0]      preproc carry        (80,)            = 80
#   [1]      mhsa windows         (2, 30, 384)     = 23,040
#   [2]      conv states          (16, 384, 30)    = 184,320
#   [3]      mhsa_len             (1,)             = 1
#   [4]      subsampling tail 1   (1, 10, 64)      = 640
#   [5]      subsampling tail 2   (32, 8, 44)      = 11,264
#   [6]      reduction tail       (384, 1)         = 384
#                                            total = 219,729
# ---------------------------------------------------------------------------


def _state_layout(config: ToneConfig) -> list[tuple[str, tuple[int, ...]]]:
    e, f = config.encoder, config.frontend
    sub_h = e.subsampling_hidden_features
    sub_lens = e.subsampling_state_lens
    return [
        ("preproc", (f.state_size,)),
        ("mhsa", (e.n_stateful_mhsa_layers, e.mhsa_state_size, e.d_model)),
        ("conv", (e.n_layers, e.d_model, e.conv_state_size)),
        ("mhsa_len", (1,)),
        ("sub1", (1, sub_lens[0], e.feat_in)),
        ("sub2", (e.subsampling_conv_channels[0], sub_lens[1], sub_h[0])),
        ("reduction", (e.d_model, e.reduction_state_size)),
    ]


def pack_state(state: StreamingState, config: ToneConfig) -> np.ndarray:
    """Flatten a ``StreamingState`` into the (B, 219729) fp16 numpy blob."""
    b = state.preproc.shape[0]
    enc = state.encoder
    # stored (N, B, ...) internally -> (B, N, ...) in the blob; conv and
    # reduction are stored time-major internally -> channel-major blob
    fields = {
        "preproc": state.preproc,
        "mhsa": enc.mhsa.permute(1, 0, 2, 3),
        "conv": enc.conv.permute(1, 0, 3, 2),
        "mhsa_len": enc.mhsa_len[:, None],
        "sub1": enc.sub1,
        "sub2": enc.sub2,
        "reduction": enc.reduction.permute(0, 2, 1),
    }
    parts = [fields[name].reshape(b, -1).to(torch.float16) for name, _ in _state_layout(config)]
    packed = torch.cat(parts, dim=1).cpu().numpy()
    if packed.shape[1] != config.flat_state_size:
        raise AssertionError(f"packed state has {packed.shape[1]} elements")
    return packed


def unpack_state(flat: np.ndarray, config: ToneConfig, dtype=torch.float32,
                 device: torch.device | str = "cpu") -> StreamingState:
    """Inverse of :func:`pack_state`; the result owns fresh tensors (the
    caller's blob is never aliased)."""
    b = flat.shape[0]
    if flat.shape != (b, config.flat_state_size):
        raise ValueError(f"state blob shape {flat.shape}, expected (B, {config.flat_state_size})")
    out = {}
    offset = 0
    for name, shape in _state_layout(config):
        n = int(np.prod(shape))
        out[name] = flat[:, offset:offset + n].reshape(b, *shape)
        offset += n

    def t(arr, dt=dtype):
        return torch.tensor(np.ascontiguousarray(arr), dtype=dt, device=device)

    enc = EncoderStreamState(
        sub1=t(out["sub1"]),
        sub2=t(out["sub2"]),
        mhsa=t(np.transpose(out["mhsa"], (1, 0, 2, 3))),
        conv=t(np.transpose(out["conv"], (1, 0, 3, 2))),
        mhsa_len=t(out["mhsa_len"][:, 0].astype(np.int32), torch.int32),
        reduction=t(np.transpose(out["reduction"], (0, 2, 1))),
    )
    return StreamingState(preproc=t(out["preproc"]), encoder=enc)
