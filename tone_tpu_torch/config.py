"""Typed configuration for the PyTorch/CUDA port (a copy of
``tone_tpu/config.py``, kept here so that the port imports nothing of the
JAX package).

One config object is the single source of truth consumed by every layer
(model, pipeline, serving, training).  This replaces the reference's layered
ad-hoc config system (HF ``ToneConfig`` dict defaults, stale ``Encoder``
constructor defaults, env vars, monkeypatched class constants — see
reference tone/training/model_wrapper.py:27-121 and dev/triton/client_wer.py:277).

The default values are the *pretrained checkpoint contract*: they mirror the
authoritative hyperparameters from the reference's ``ToneConfig``
(tone/training/model_wrapper.py:27-121), NOT the stale ``Encoder.__init__``
defaults (tone/nn/modules/conformer.py:66-88).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Literal

# Russian alphabet (33 letters) + space = 34 labels; blank id = 34 (== pad id).
# Reference: tone/decoder.py:23, tone/training/model_wrapper.py:79-115.
LABELS = "абвгдеёжзийклмнопрстуфхцчшщъыьэюя "
BLANK_ID = len(LABELS)  # 34
VOCAB_SIZE_WITH_BLANK = len(LABELS) + 1  # 35


@dataclass(frozen=True)
class FrontendConfig:
    """Log-mel filterbank frontend (reference tone/nn/modules/feats.py:26)."""

    sample_rate: int = 8000
    window_size: float = 0.02  # seconds -> 160 samples
    window_stride: float = 0.01  # seconds -> 80 samples
    n_fft: int = 160
    n_mels: int = 64
    preemphasis_coefficient: float = 0.97
    log_zero_guard_value: float = 2.0**-24

    @property
    def win_length(self) -> int:
        return int(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.window_stride * self.sample_rate)

    @property
    def state_size(self) -> int:
        """Streaming left-context carry in samples (n_fft - hop = 80)."""
        return self.n_fft - self.hop_length

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


@dataclass(frozen=True)
class EncoderConfig:
    """Streaming Conformer encoder (reference tone/training/model_wrapper.py:36-75)."""

    feat_in: int = 64
    n_layers: int = 16
    d_model: int = 384
    ff_expansion_factor: int = 4
    n_heads: int = 8
    rope_dim: int = 32
    conv_kernel_size: int = 31
    dropout: float = 0.1
    dropout_att: float = 0.1

    subsampling_conv_channels: tuple[int, ...] = (32, 64)
    subsampling_kernel_size: tuple[tuple[int, int], ...] = ((11, 21), (11, 11))
    subsampling_strides: tuple[tuple[int, int], ...] = ((1, 1), (3, 1))

    # Streaming attention topology.
    mhsa_stateless_layers: int = 14
    mhsa_state_size: int = 30
    chunk_size: int = 10  # model frames per 300 ms chunk

    # Temporal reduction x2 in layers (reduction_position, upsample_position].
    reduction_position: int = 6
    reduction_factor: int = 2
    reduction_kernel_size: int = 3
    upsample_position: int = 14

    # Attention-score sharing: scores are computed at layers {0, 7, 14, 15}
    # and reused in-between (reference model_wrapper.py:50-67); legal because
    # reuse layers have no q/k projections (reference submodules.py:193-202).
    should_recompute_att_scores: tuple[bool, ...] = (
        True, False, False, False, False, False, False, True,
        False, False, False, False, False, False, True, True,
    )

    @property
    def d_ff(self) -> int:
        return self.d_model * self.ff_expansion_factor

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def subsampling_factor(self) -> int:
        f = 1
        for s in self.subsampling_strides:
            f *= s[0]
        return f

    @property
    def subsampling_state_lens(self) -> tuple[int, ...]:
        """Time rows of carried input tail per subsampling conv (k_t - s_t)."""
        return tuple(
            k[0] - s[0]
            for k, s in zip(self.subsampling_kernel_size, self.subsampling_strides)
        )

    @property
    def subsampling_hidden_features(self) -> tuple[int, ...]:
        """Feature widths after each subsampling conv (valid convolution)."""
        feats = []
        f = self.feat_in
        for k, s in zip(self.subsampling_kernel_size, self.subsampling_strides):
            f = (f - k[1]) // s[1] + 1
            feats.append(f)
        return tuple(feats)

    @property
    def conv_state_size(self) -> int:
        return self.conv_kernel_size - 1

    @property
    def reduction_state_size(self) -> int:
        return self.reduction_kernel_size - self.reduction_factor

    @property
    def n_stateful_mhsa_layers(self) -> int:
        return self.n_layers - self.mhsa_stateless_layers


@dataclass(frozen=True)
class ToneConfig:
    """Full model + pipeline configuration."""

    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    labels: str = LABELS

    # Streaming pipeline constants (reference tone/onnx_wrapper.py:30-34,
    # tone/pipeline.py:47-48).
    audio_chunk_samples: int = 2400  # 300 ms @ 8 kHz
    padding: int = 2400  # "magic padding" added before/after each utterance
    frame_size: float = 0.03  # seconds per output logprob frame
    mean_time_bias: float = 0.33  # timestamp correction, seconds

    # Numerical policy: params stored fp32; matmul/conv compute in
    # ``compute_dtype``; norms/softmax/log_softmax always fp32
    # (mirrors the reference's TensorRT bf16+fp32-pins recipe,
    # scripts/trt_build.md:7-22).
    compute_dtype: Literal["bfloat16", "float32"] = "bfloat16"
    # Streaming-state storage dtype (HBM traffic per tick); None = follow
    # compute_dtype.  The reference stores its state in fp16
    # (onnx_wrapper.py:34).
    state_dtype: Literal["bfloat16", "float32", "float16"] | None = None
    # Reproduce the reference streaming path's fp16 quantization points —
    # the normalized waveform and the frontend carry are rounded to fp16
    # (reference tone/nn/model.py:164-165) — so golden streaming-parity
    # tests can assert a tight tolerance (4e-4 measured over 24 chunks vs
    # 0.15 without the emulation).  Off by default: full precision is
    # strictly more accurate.
    emulate_reference_fp16: bool = False

    @property
    def resolved_state_dtype(self) -> str:
        return self.state_dtype or self.compute_dtype

    @property
    def vocab_size(self) -> int:
        return len(self.labels)

    @property
    def vocab_size_with_blank(self) -> int:
        return len(self.labels) + 1

    @property
    def blank_id(self) -> int:
        return len(self.labels)

    @property
    def feat_frames_per_chunk(self) -> int:
        return self.audio_chunk_samples // self.frontend.hop_length  # 30

    @property
    def flat_state_size(self) -> int:
        """Total fp16 elements in the flattened per-stream state (219,729)."""
        e = self.encoder
        f = self.frontend
        sub_h = e.subsampling_hidden_features
        sub_lens = e.subsampling_state_lens
        n = f.state_size  # preprocessor carry: 80
        n += e.n_stateful_mhsa_layers * e.mhsa_state_size * e.d_model  # 23,040
        n += e.n_layers * e.d_model * e.conv_state_size  # 184,320
        n += 1  # mhsa_len
        n += 1 * sub_lens[0] * e.feat_in  # 640
        n += e.subsampling_conv_channels[0] * sub_lens[1] * sub_h[0]  # 11,264
        n += e.d_model * e.reduction_state_size  # 384
        return n

    def with_chunk_duration_ms(self, chunk_ms: int) -> "ToneConfig":
        """Derive a config for a different streaming chunk duration.

        The reference achieves this by re-exporting with a different signal
        length (tone/scripts/export.py:562-569) or by monkeypatching class
        constants (dev/triton/client_wer.py:277 — the config-system smell this
        method fixes).  The chunk's model-frame count follows from the conv
        subsampling arithmetic; e.g. 400 ms -> 3200 samples -> 40 feature
        frames -> 13 model frames.
        """
        samples = chunk_ms * self.frontend.sample_rate // 1000
        feat_frames = samples // self.frontend.hop_length
        t = feat_frames
        for k, s, tail in zip(self.encoder.subsampling_kernel_size,
                              self.encoder.subsampling_strides,
                              self.encoder.subsampling_state_lens):
            t = (t + tail - k[0]) // s[0] + 1
        if t <= 0:
            raise ValueError(f"chunk of {chunk_ms} ms is too short")
        return dataclasses.replace(
            self,
            audio_chunk_samples=samples,
            encoder=dataclasses.replace(self.encoder, chunk_size=t),
        )

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ToneConfig":
        d = dict(d)
        fe = d.pop("frontend", {})
        enc = d.pop("encoder", {})
        if "subsampling_conv_channels" in enc:
            enc["subsampling_conv_channels"] = tuple(enc["subsampling_conv_channels"])
        for key in ("subsampling_kernel_size", "subsampling_strides"):
            if key in enc:
                enc[key] = tuple(tuple(x) for x in enc[key])
        if "should_recompute_att_scores" in enc:
            enc["should_recompute_att_scores"] = tuple(enc["should_recompute_att_scores"])
        return cls(frontend=FrontendConfig(**fe), encoder=EncoderConfig(**enc), **d)
