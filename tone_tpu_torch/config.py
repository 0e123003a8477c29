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


# ---------------------------------------------------------------------------
# FastConformer CTC (NVIDIA NeMo's ``EncDecCTCModelBPE`` with a FastConformer
# encoder, e.g. Parakeet-CTC-1.1B): an offline-only architecture.  Its
# defaults are the published Parakeet-CTC-1.1B (model card
# huggingface.co/nvidia/parakeet-ctc-1.1b and NeMo's FastConformer CTC
# recipe); the released ``tokenizer.model`` is not in the repository, so the
# default vocabulary is a stand-in table of 1,024 pieces.
# ---------------------------------------------------------------------------

FASTCONFORMER_CTC = "fastconformer_ctc"
PIECE_SPACE = "▁"  # SentencePiece's word-start mark

# NeMo's settings that the port runs in one form only: per-feature
# normalization, ``dw_striding`` subsampling, relative-position attention
# over the full context with inputs scaled by sqrt(d_model) and each
# layer's own position biases, BatchNorm in the convolution module.  A
# config's dict states them (``to_dict``); ``from_dict`` refuses another
# value.
FASTCONFORMER_FIXED = {
    "frontend": {"normalize": "per_feature"},
    "encoder": {"subsampling": "dw_striding", "self_attention_model": "rel_pos",
                "att_context_size": (-1, -1), "xscaling": True, "untie_biases": True,
                "conv_norm_type": "batch_norm"},
}


def stand_in_vocabulary(n: int = 1024) -> tuple[str, ...]:
    """``n`` distinct SentencePiece-style pieces, in a fixed order: each
    letter and the apostrophe with and without the word-start mark, then
    two- and three-letter pieces likewise.  It stands in for a released
    tokenizer's table, which gives the same sizes and another text."""
    chars = "abcdefghijklmnopqrstuvwxyz'"
    pieces: list[str] = []
    grams = list(chars)
    while len(pieces) < n:
        for g in grams:
            pieces += [PIECE_SPACE + g, g]
        grams = [g + c for g in grams for c in chars if g[-1] != c]
    return tuple(pieces[:n])


@dataclass(frozen=True)
class FastConformerFrontendConfig:
    """NeMo's ``AudioToMelSpectrogramPreprocessor`` as the model runs it:
    pre-emphasis over the signal, a window of ``window_size`` centred in an
    FFT of ``n_fft`` over centred frames, the power spectrum, slaney mels,
    ``log(mel + guard)`` and each mel normalized over the call's own frames
    (``normalize: per_feature``).  Dither is off, as at inference."""

    sample_rate: int = 16000
    window_size: float = 0.025  # seconds -> 400 samples
    window_stride: float = 0.01  # seconds -> 160 samples
    n_fft: int = 512
    n_mels: int = 80
    preemphasis_coefficient: float = 0.97
    log_zero_guard_value: float = 2.0**-24

    def __post_init__(self):
        if self.win_length > self.n_fft:
            raise ValueError(f"window of {self.win_length} samples exceeds n_fft {self.n_fft}")

    @property
    def win_length(self) -> int:
        return round(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return round(self.window_stride * self.sample_rate)

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def frames(self, n_samples: int) -> int:
        """Feature frames of a signal of ``n_samples`` (centred framing)."""
        return n_samples // self.hop_length + 1


@dataclass(frozen=True)
class FastConformerEncoderConfig:
    """The FastConformer encoder: ``dw_striding`` subsampling, Macaron
    Conformer layers with Transformer-XL relative-position attention over
    the full context, and the CTC head's input width."""

    feat_in: int = 80
    n_layers: int = 42
    d_model: int = 1024
    n_heads: int = 8
    ff_expansion_factor: int = 4
    conv_kernel_size: int = 9
    subsampling_factor: int = 8
    subsampling_conv_channels: int = 256

    def __post_init__(self):
        if self.subsampling_factor < 2 or self.subsampling_factor & (self.subsampling_factor - 1):
            raise ValueError(f"subsampling_factor {self.subsampling_factor} is not a power of 2")
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of {self.n_heads} heads")

    @property
    def d_ff(self) -> int:
        return self.d_model * self.ff_expansion_factor

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_subsampling_convs(self) -> int:
        """Stride-2 convolutions of the subsampling (log2 of its factor)."""
        return self.subsampling_factor.bit_length() - 1

    @staticmethod
    def halved(n: int) -> int:
        """Output length of one k3, s2, p1 convolution over ``n``."""
        return (n - 1) // 2 + 1

    @property
    def subsampled_feat(self) -> int:
        """Mel bins left after the subsampling's convolutions (80 -> 10)."""
        f = self.feat_in
        for _ in range(self.n_subsampling_convs):
            f = self.halved(f)
        return f


@dataclass(frozen=True)
class FastConformerConfig:
    """A FastConformer CTC model (defaults: Parakeet-CTC-1.1B).  Offline
    only: the port transcribes it through ``OfflineTranscriber(...,
    use_offline_forward=True)``; the streaming engine refuses it."""

    frontend: FastConformerFrontendConfig = field(default_factory=FastConformerFrontendConfig)
    encoder: FastConformerEncoderConfig = field(default_factory=FastConformerEncoderConfig)
    vocabulary: tuple[str, ...] = field(default_factory=stand_in_vocabulary)
    # "float32" runs on the CPU only: on a CUDA device the attention kernel
    # computes in bf16 and apply_fastconformer refuses any other dtype.
    compute_dtype: Literal["bfloat16", "float32"] = "bfloat16"
    architecture: str = FASTCONFORMER_CTC

    # No edge padding and no time bias: a phrase's frames start at the call's.
    padding = 0
    mean_time_bias = 0.0

    def __post_init__(self):
        if self.architecture != FASTCONFORMER_CTC:
            raise ValueError(f"architecture {self.architecture!r} is not {FASTCONFORMER_CTC!r}")

    @property
    def vocab_size_with_blank(self) -> int:
        return len(self.vocabulary) + 1

    @property
    def frame_samples(self) -> int:
        """Audio samples per output frame (1,280: 80 ms at 16 kHz)."""
        return self.frontend.hop_length * self.encoder.subsampling_factor

    @property
    def frame_size(self) -> float:
        """Seconds per output logprob frame."""
        return self.frame_samples / self.frontend.sample_rate

    def output_frames(self, n_samples: int) -> int:
        """Logprob frames of a call of ``n_samples``."""
        n = self.frontend.frames(n_samples)
        for _ in range(self.encoder.n_subsampling_convs):
            n = self.encoder.halved(n)
        return n

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        for part, fixed in FASTCONFORMER_FIXED.items():
            d[part].update(fixed)
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FastConformerConfig":
        d = dict(d)
        parts = {part: dict(d.pop(part, {})) for part in FASTCONFORMER_FIXED}
        for part, fixed in FASTCONFORMER_FIXED.items():
            for key, value in fixed.items():
                given = parts[part].pop(key, value)
                if (tuple(given) if isinstance(given, list) else given) != value:
                    raise ValueError(f"FastConformer {part}.{key}={given!r} is not supported "
                                     f"(only {value!r})")
        if "vocabulary" in d:
            d["vocabulary"] = tuple(d["vocabulary"])
        return cls(frontend=FastConformerFrontendConfig(**parts["frontend"]),
                   encoder=FastConformerEncoderConfig(**parts["encoder"]), **d)


ModelConfig = ToneConfig | FastConformerConfig


def config_from_dict(d: dict[str, Any]) -> ModelConfig:
    """The config a ``to_dict`` wrote: a ``FastConformerConfig`` where its
    ``architecture`` says so, else a ``ToneConfig``."""
    if d.get("architecture") == FASTCONFORMER_CTC:
        return FastConformerConfig.from_dict(d)
    return ToneConfig.from_dict(d)


def require_streaming(config, who: str) -> None:
    """Raise where ``config`` is an offline-only architecture."""
    if isinstance(config, FastConformerConfig):
        raise ValueError(
            f"{who} streams T-one's chunk step; a FastConformer CTC model is offline only: "
            "transcribe it with OfflineTranscriber(variables, config, use_offline_forward=True)")
