"""Plain reference of the FastConformer CTC model (NVIDIA NeMo's
``EncDecCTCModelBPE`` with a FastConformer encoder, as in Parakeet-CTC-1.1B:
huggingface.co/nvidia/parakeet-ctc-1.1b), in float32, one call at a time.

Written out in plain PyTorch from NeMo's modules, with no kernel, no
batching, no blocking and no rounding to a lower precision: every product
runs in float32 (TF32 off, ``float32_exactly``) unless a ``Precision`` of a
lower kind is given, which is how the benchmark's control is computed.  It
imports nothing of the program it judges.  The weights are a flat
``state_dict`` under NeMo's published names (``param_layout``), in torch's
layouts.

The model, per call of ``n`` samples at 16 kHz:

* ``AudioToMelSpectrogramPreprocessor``: pre-emphasis ``y[0] = x[0]``,
  ``y[i] = x[i] - 0.97 x[i - 1]``; ``torch.stft`` (n_fft 512, hop 160, a
  symmetric Hann window of 400 centred in the FFT, ``center=True`` with zero
  padding); the magnitude squared; slaney mels (librosa's filterbank,
  ``norm="slaney"``); ``log(mel + 2^-24)``; each mel normalized over the
  call's ``n // 160 + 1`` frames (mean, unbiased standard deviation + 1e-5).
* ``ConvSubsampling`` ``dw_striding``: conv2d 1 -> C (k3, s2, p1), ReLU,
  then ``log2(factor) - 1`` times depthwise conv2d (k3, s2, p1), pointwise
  1x1, ReLU; ``out`` a linear of C x remaining mels to d_model.
* ``RelPositionalEncoding``: the input scaled by sqrt(d_model); sinusoidal
  encodings of the relative positions T - 1 down to -(T - 1).
* Each ``ConformerLayer``: x + 1/2 FF1(LN(x)); + RelMHSA(LN(x)); + Conv(LN(x));
  + 1/2 FF2(LN(x)); LN_out.  FF: linear1, Swish, linear2.  RelMHSA: the
  score of query i and key j is ((q_i + u) . k_j + (q_i + v) . p_{i-j}) /
  sqrt(d_head), p_r = linear_pos(PE(r)), the bd term taken by indexing
  p_{i-j} directly (not NeMo's ``rel_shift``, whose result it equals).
  Conv: pointwise_conv1 d -> 2d, GLU, depthwise conv (k, padding (k-1)/2),
  BatchNorm (running statistics), Swish, pointwise_conv2.
* ``ConvASRDecoder``: a 1x1 convolution to the vocabulary and the blank
  (the last class), log-softmax.

Departures from NeMo, each on purpose: dither is off (NeMo adds it only in
training, and a deterministic forward is what is compared); the
vocabulary is the configuration's (a stand-in table where the released
``tokenizer.model`` is not at hand); the positional encodings are computed
for the call's own length, which is what NeMo's table gives where it is
long enough (``pos_emb_max_len``), and NeMo extends it where it is not.

The splitter and greedy decoder the port applies to a FastConformer's
logprobs are stated here too (``phrase_texts``): a frame is speech where
P(blank) <= 0.9; a phrase ends at a silence of at least 20 frames, the
stream's start and end counting as silence; a phrase of 2,000 frames or
more is cut into pieces of 2,000; each phrase is decoded from its frames
with 3 more on each side; greedy decoding takes the best class per frame,
merges repeats, drops the blank, joins the pieces with their word-start
mark read as a space and strips spaces at the ends.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Configuration: the sizes of the configuration's "model" object.
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
    n_layers: int
    d_model: int
    d_ff: int
    n_heads: int
    conv_kernel: int
    sub_factor: int
    sub_channels: int
    pieces: tuple

    @property
    def vocab(self) -> int:
        """Classes of the head: the pieces and the blank."""
        return len(self.pieces) + 1

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_sub_convs(self) -> int:
        return int(round(math.log2(self.sub_factor)))

    @property
    def sub_feat(self) -> int:
        f = self.n_mels
        for _ in range(self.n_sub_convs):
            f = (f + 2 - 3) // 2 + 1
        return f

    def frames(self, n_samples: int) -> int:
        """Output frames of a call of ``n_samples``."""
        t = n_samples // self.hop + 1
        for _ in range(self.n_sub_convs):
            t = (t + 2 - 3) // 2 + 1
        return t


def sizes(model: dict) -> Sizes:
    fe, enc = model["frontend"], model["encoder"]
    return Sizes(
        sample_rate=fe["sample_rate"], win=round(fe["window_size"] * fe["sample_rate"]),
        hop=round(fe["window_stride"] * fe["sample_rate"]), n_fft=fe["n_fft"],
        n_mels=fe["n_mels"], preemph=fe["preemphasis_coefficient"],
        log_guard=fe["log_zero_guard_value"], n_layers=enc["n_layers"],
        d_model=enc["d_model"], d_ff=enc["d_model"] * enc["ff_expansion_factor"],
        n_heads=enc["n_heads"], conv_kernel=enc["conv_kernel_size"],
        sub_factor=enc["subsampling_factor"], sub_channels=enc["subsampling_conv_channels"],
        pieces=tuple(model["vocabulary"]))


# ---------------------------------------------------------------------------
# The parameters: NeMo's names, torch's shapes, and how each leaf is drawn.
# ---------------------------------------------------------------------------


class Leaf(NamedTuple):
    shape: tuple
    kind: str
    scale: float


def param_layout(s: Sizes) -> dict:
    """``{NeMo name: Leaf(shape, kind, scale)}``: ``uniform`` in [-scale,
    scale] (a weight or bias: 1/sqrt(fan-in)), ``one`` in [1 - scale,
    1 + scale] (a norm's scale, a running variance) or ``zero`` in [-scale,
    scale] (a norm's shift, a running mean, a position bias).  BatchNorm's
    ``num_batches_tracked`` is left out: inference does not read it."""
    out: dict[str, Leaf] = {}

    def weight(name, shape, fan_in, bias=True):
        b = 1.0 / math.sqrt(fan_in)
        out[f"{name}.weight"] = Leaf(tuple(shape), "uniform", b)
        if bias:
            out[f"{name}.bias"] = Leaf((shape[0],), "uniform", b)

    def norm(name, d):
        out[f"{name}.weight"] = Leaf((d,), "one", 0.1)
        out[f"{name}.bias"] = Leaf((d,), "zero", 0.05)

    c, d, h = s.sub_channels, s.d_model, s.n_heads
    weight("encoder.pre_encode.conv.0", (c, 1, 3, 3), 9)
    for i in range(s.n_sub_convs - 1):
        weight(f"encoder.pre_encode.conv.{2 + 3 * i}", (c, 1, 3, 3), 9)
        weight(f"encoder.pre_encode.conv.{3 + 3 * i}", (c, c, 1, 1), c)
    weight("encoder.pre_encode.out", (d, c * s.sub_feat), c * s.sub_feat)
    for i in range(s.n_layers):
        pfx = f"encoder.layers.{i}"
        for ff in ("1", "2"):
            norm(f"{pfx}.norm_feed_forward{ff}", d)
            weight(f"{pfx}.feed_forward{ff}.linear1", (s.d_ff, d), d)
            weight(f"{pfx}.feed_forward{ff}.linear2", (d, s.d_ff), s.d_ff)
            if ff == "1":
                norm(f"{pfx}.norm_self_att", d)
                for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
                    weight(f"{pfx}.self_attn.{name}", (d, d), d)
                weight(f"{pfx}.self_attn.linear_pos", (d, d), d, bias=False)
                out[f"{pfx}.self_attn.pos_bias_u"] = Leaf((h, s.d_head), "zero", 0.1)
                out[f"{pfx}.self_attn.pos_bias_v"] = Leaf((h, s.d_head), "zero", 0.1)
                norm(f"{pfx}.norm_conv", d)
                weight(f"{pfx}.conv.pointwise_conv1", (2 * d, d, 1), d)
                weight(f"{pfx}.conv.depthwise_conv", (d, 1, s.conv_kernel), s.conv_kernel)
                norm(f"{pfx}.conv.batch_norm", d)
                out[f"{pfx}.conv.batch_norm.running_mean"] = Leaf((d,), "zero", 0.1)
                out[f"{pfx}.conv.batch_norm.running_var"] = Leaf((d,), "one", 0.2)
                weight(f"{pfx}.conv.pointwise_conv2", (d, d, 1), d)
        norm(f"{pfx}.norm_out", d)
    weight("decoder.decoder_layers.0", (s.vocab, d, 1), d)
    return out


def parameter_count(s: Sizes) -> int:
    """Parameters as NeMo counts them (BatchNorm's running statistics are
    buffers, not parameters)."""
    return sum(math.prod(leaf.shape) for name, leaf in param_layout(s).items()
               if not name.endswith(("running_mean", "running_var")))


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

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)


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
# The frontend.
# ---------------------------------------------------------------------------


def mel_filterbank(s: Sizes) -> np.ndarray:
    """librosa's ``filters.mel(sr, n_fft, n_mels, fmin=0, fmax=sr/2,
    htk=False, norm="slaney")``, (n_mels, n_fft // 2 + 1), in float64."""
    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        lin = f / (200.0 / 3)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                        / (np.log(6.4) / 27.0), lin)

    def mel_to_hz(m):
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        m * (200.0 / 3))

    fft_freqs = np.linspace(0.0, s.sample_rate / 2.0, s.n_fft // 2 + 1)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(s.sample_rate / 2.0),
                                  s.n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]


def log_mel(s: Sizes, wav: torch.Tensor) -> torch.Tensor:
    """(n,) float32 waveform of one call -> (n // hop + 1, n_mels) features."""
    x = torch.cat([wav[:1], wav[1:] - s.preemph * wav[:-1]])
    window = torch.hann_window(s.win, periodic=False, dtype=torch.float32, device=wav.device)
    spec = torch.stft(x, n_fft=s.n_fft, hop_length=s.hop, win_length=s.win, window=window,
                      center=True, pad_mode="constant", return_complex=True)
    power = torch.view_as_real(spec).pow(2).sum(-1).sqrt().pow(2)      # (n_freqs, T)
    fb = torch.from_numpy(mel_filterbank(s)).to(wav.device, torch.float32)
    feats = torch.log(fb @ power + s.log_guard)                        # (n_mels, T)
    mean = feats.mean(dim=1, keepdim=True)
    std = (feats.std(dim=1, keepdim=True) if feats.shape[1] > 1
           else torch.zeros_like(mean))
    return ((feats - mean) / (std + 1e-5)).T


# ---------------------------------------------------------------------------
# The encoder and the head.
# ---------------------------------------------------------------------------


def positional_encoding(t: int, d: int, device) -> torch.Tensor:
    """(2t - 1, d): row k is relative position t - 1 - k (NeMo's
    ``RelPositionalEncoding.create_pe``)."""
    positions = torch.arange(t - 1, -t, -1, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(2 * t - 1, d, device=device)
    pe[:, 0::2] = torch.sin(positions * div)
    pe[:, 1::2] = torch.cos(positions * div)
    return pe


def subsampling(sd, s: Sizes, feats: torch.Tensor, pr: Precision) -> torch.Tensor:
    """(T, n_mels) -> (T_out, d_model), ``dw_striding``."""
    def conv(x, name, stride, padding, groups=1):
        return F.conv2d(pr.q(x), pr.q(sd[f"{name}.weight"]), sd[f"{name}.bias"],
                        stride=stride, padding=padding, groups=groups)

    x = F.relu(conv(feats[None, None], "encoder.pre_encode.conv.0", 2, 1))
    for i in range(s.n_sub_convs - 1):
        x = conv(x, f"encoder.pre_encode.conv.{2 + 3 * i}", 2, 1, groups=s.sub_channels)
        x = F.relu(conv(x, f"encoder.pre_encode.conv.{3 + 3 * i}", 1, 0))
    _, c, t, f = x.shape
    x = x[0].transpose(0, 1).reshape(t, c * f)
    return pr.linear(x, sd["encoder.pre_encode.out.weight"], sd["encoder.pre_encode.out.bias"])


def layer_norm(sd, name, x):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], 1e-5)


def feed_forward(sd, name, x, pr: Precision):
    h = pr.linear(x, sd[f"{name}.linear1.weight"], sd[f"{name}.linear1.bias"])
    h = h * torch.sigmoid(h)
    return pr.linear(h, sd[f"{name}.linear2.weight"], sd[f"{name}.linear2.bias"])


def rel_attention(sd, name, x, pos, s: Sizes, pr: Precision):
    """One call's relative-position self-attention over all its frames;
    the bd term by direct indexing of p_{i-j}."""
    t, h, dk = x.shape[0], s.n_heads, s.d_head

    def proj(n, inp, bias=True):
        return pr.linear(inp, sd[f"{name}.{n}.weight"], sd[f"{name}.{n}.bias"] if bias else None)

    q = proj("linear_q", x).reshape(t, h, dk).transpose(0, 1)           # (H, T, dk)
    k = proj("linear_k", x).reshape(t, h, dk).transpose(0, 1)
    v = proj("linear_v", x).reshape(t, h, dk).transpose(0, 1)
    p = proj("linear_pos", pos, bias=False).reshape(2 * t - 1, h, dk).transpose(0, 1)
    q_u = q + sd[f"{name}.pos_bias_u"][:, None, :]
    q_v = q + sd[f"{name}.pos_bias_v"][:, None, :]
    ac = pr.q(q_u) @ pr.q(k).transpose(1, 2)                             # (H, T, T)
    by_position = pr.q(q_v) @ pr.q(p).transpose(1, 2)                    # (H, T, 2T - 1)
    i = torch.arange(t, device=x.device)
    row_of = (t - 1) - (i[:, None] - i[None, :])                         # row of p_{i-j}
    bd = by_position.gather(2, row_of[None].expand(h, t, t))
    attn = torch.softmax((ac + bd) / math.sqrt(dk), dim=-1)
    ctx = (pr.q(attn) @ pr.q(v)).transpose(0, 1).reshape(t, h * dk)
    return proj("linear_out", ctx)


def conv_module(sd, name, x, s: Sizes, pr: Precision):
    """(T, d) -> (T, d)."""
    y = F.conv1d(pr.q(x.T[None]), pr.q(sd[f"{name}.pointwise_conv1.weight"]),
                 sd[f"{name}.pointwise_conv1.bias"])
    y = F.glu(y, dim=1)
    y = F.conv1d(pr.q(y), pr.q(sd[f"{name}.depthwise_conv.weight"]),
                 sd[f"{name}.depthwise_conv.bias"], padding=(s.conv_kernel - 1) // 2,
                 groups=s.d_model)
    bn = f"{name}.batch_norm"
    y = F.batch_norm(y, sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"], sd[f"{bn}.weight"],
                     sd[f"{bn}.bias"], training=False, eps=1e-5)
    y = y * torch.sigmoid(y)
    y = F.conv1d(pr.q(y), pr.q(sd[f"{name}.pointwise_conv2.weight"]),
                 sd[f"{name}.pointwise_conv2.bias"])
    return y[0].T


def forward(sd, s: Sizes, wav: torch.Tensor, pr: Precision = FLOAT32) -> torch.Tensor:
    """One call: (n,) float32 waveform in [-1, 1] -> (frames, vocab)
    logprobs."""
    x = subsampling(sd, s, log_mel(s, wav), pr)
    x = x * math.sqrt(s.d_model)
    pos = positional_encoding(x.shape[0], s.d_model, x.device)
    for i in range(s.n_layers):
        pfx = f"encoder.layers.{i}"
        x = x + 0.5 * feed_forward(sd, f"{pfx}.feed_forward1",
                                   layer_norm(sd, f"{pfx}.norm_feed_forward1", x), pr)
        x = x + rel_attention(sd, f"{pfx}.self_attn",
                              layer_norm(sd, f"{pfx}.norm_self_att", x), pos, s, pr)
        x = x + conv_module(sd, f"{pfx}.conv", layer_norm(sd, f"{pfx}.norm_conv", x), s, pr)
        x = x + 0.5 * feed_forward(sd, f"{pfx}.feed_forward2",
                                   layer_norm(sd, f"{pfx}.norm_feed_forward2", x), pr)
        x = layer_norm(sd, f"{pfx}.norm_out", x)
    logits = F.conv1d(pr.q(x.T[None]), pr.q(sd["decoder.decoder_layers.0.weight"]),
                      sd["decoder.decoder_layers.0.bias"])[0].T
    return torch.log_softmax(logits, dim=-1)


# ---------------------------------------------------------------------------
# Phrases and texts.
# ---------------------------------------------------------------------------

SILENCE_THRESHOLD = 0.9
MIN_SILENCE = 20
EXPAND = 3
MAX_PHRASE = 2000
WORD_START = "▁"


def phrase_spans(logprobs: np.ndarray) -> list[tuple[int, int]]:
    """(start, end) frames of each phrase of a finished call."""
    # float32, as the program decides it from its logprobs
    speech = np.exp(logprobs[..., -1]) <= SILENCE_THRESHOLD
    silent = [True] * MIN_SILENCE + [not sp for sp in speech] + [True] * MIN_SILENCE
    runs = []  # silence runs of MIN_SILENCE frames or more, in the call's frames
    i = 0
    while i < len(silent):
        if silent[i]:
            j = i
            while j < len(silent) and silent[j]:
                j += 1
            if j - i >= MIN_SILENCE:
                runs.append((i - MIN_SILENCE, j - MIN_SILENCE))
            i = j
        else:
            i += 1
    spans = []
    for (_, start), (end, _) in zip(runs, runs[1:]):
        while end - start >= MAX_PHRASE:
            spans.append((start, start + MAX_PHRASE))
            start += MAX_PHRASE
        spans.append((start, end))
    return spans


def greedy_text(logprobs: np.ndarray, pieces) -> str:
    text, prev = [], -1
    for t in logprobs.argmax(-1).tolist():
        if t != prev and t < len(pieces):
            text.append(pieces[t])
        prev = t
    return "".join(text).replace(WORD_START, " ").strip()


def phrase_texts(logprobs: np.ndarray, pieces) -> list[str]:
    """The texts of a finished call's phrases, in order."""
    return [greedy_text(logprobs[max(0, a - EXPAND):b + EXPAND], pieces)
            for a, b in phrase_spans(logprobs)]
