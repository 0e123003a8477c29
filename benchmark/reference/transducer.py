"""Plain reference of the FastConformer token-and-duration transducer
(NVIDIA NeMo's ``EncDecRNNTBPEModel`` with a FastConformer encoder and a
TDT decoder, as in Parakeet-TDT-0.6B-v3:
huggingface.co/nvidia/parakeet-tdt-0.6b-v3; the TDT of Xu et al., ICML
2023, arXiv:2304.06795), in float32, one call at a time.

Written out in plain PyTorch from NeMo's modules, with no kernel and no
batching: every product runs in float32 (TF32 off,
``fastconformer.float32_exactly``) unless a lower ``Precision`` is given,
which is how the benchmark's control is computed.  It imports nothing of
the program it judges.  The weights are a flat ``state_dict`` under NeMo's
published names (``param_layout``), in torch's layouts.

The model, per call, with V pieces, the blank the class V and D the
configuration's ``durations``:

* the encoder: ``fastconformer.py``'s, everything before its CTC head
  (``encode``);
* ``RNNTDecoder`` (``blank_as_pad``): an embedding of the V + 1 classes
  whose blank row is zero, then ``pred_rnn_layers`` LSTM layers
  (``torch.nn.LSTM``'s equations, gates i, f, g, o; ``b_ih`` and
  ``b_hh``), from a zero state with the blank as the first input;
* ``RNNTJoint``: z = W_out ReLU(W_enc f_t + b_enc + W_pred g + b_pred) +
  b_out, the V + 1 token logits then one logit per duration;
* greedy TDT decoding (NeMo's batched greedy TDT, one row; ``greedy``):
  at frame t take the best token k and the best duration index; a token
  that is not the blank is emitted at t and steps the prediction network;
  a blank whose duration is 0 takes 1; t advances by the duration; a call
  that has emitted ``max_symbols`` tokens on one frame and stays on it
  advances by one more; the call ends when t reaches its frames.

``replay`` computes the logits along a given path (teacher forcing: each
step at its recorded frame, the prediction network fed the tokens the
path emitted before it); ``path_errors`` counts the steps of a path that
the rules above do not allow; ``phrase_texts`` splits a call's tokens into
phrases as the program does (20 or more frames with no token end a phrase,
the call's start and end counting as such; a phrase of 2,000 frames or more
is cut into pieces of 2,000) and joins each phrase's pieces.

Departures from NeMo, each on purpose: those of ``fastconformer.py`` (dither
off, a stand-in vocabulary, positional encodings of the call's own
length), and only the greedy decoding (no beam).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from reference import fastconformer as fc

Precision = fc.Precision
FLOAT32 = fc.FLOAT32
float32_exactly = fc.float32_exactly

# ---------------------------------------------------------------------------
# Configuration: the encoder's sizes and the transducer's.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Sizes:
    enc: fc.Sizes
    pred_hidden: int
    pred_layers: int
    joint_hidden: int
    durations: tuple
    max_symbols: int

    @property
    def blank(self) -> int:
        return len(self.enc.pieces)

    @property
    def n_out(self) -> int:
        """The joint's outputs: V + 1 tokens, then the durations."""
        return self.blank + 1 + len(self.durations)


def sizes(model: dict) -> Sizes:
    t = model["transducer"]
    return Sizes(enc=fc.sizes(model), pred_hidden=t["pred_hidden"],
                 pred_layers=t["pred_rnn_layers"], joint_hidden=t["joint_hidden"],
                 durations=tuple(t["durations"]), max_symbols=t["max_symbols"])


def param_layout(s: Sizes) -> dict:
    """``fastconformer.param_layout`` of the encoder, with the prediction
    network and the joint in the CTC head's place; the embedding is drawn
    in [-1, 1] (its blank row is zeroed by whoever draws it) and the LSTMs
    in 1/sqrt(hidden), as ``torch.nn.LSTM`` draws them."""
    out = {k: v for k, v in fc.param_layout(s.enc).items()
           if not k.startswith("decoder.decoder_layers.")}
    h, j, d = s.pred_hidden, s.joint_hidden, s.enc.d_model
    out["decoder.prediction.embed.weight"] = fc.Leaf((s.blank + 1, h), "uniform", 1.0)
    for i in range(s.pred_layers):
        for part in ("ih", "hh"):
            rnn = "decoder.prediction.dec_rnn.lstm"
            out[f"{rnn}.weight_{part}_l{i}"] = fc.Leaf((4 * h, h), "uniform", 1 / math.sqrt(h))
            out[f"{rnn}.bias_{part}_l{i}"] = fc.Leaf((4 * h,), "uniform", 1 / math.sqrt(h))
    for name, n_out, n_in in (("joint.enc", j, d), ("joint.pred", j, h),
                              ("joint.joint_net.2", s.n_out, j)):
        out[f"{name}.weight"] = fc.Leaf((n_out, n_in), "uniform", 1 / math.sqrt(n_in))
        out[f"{name}.bias"] = fc.Leaf((n_out,), "uniform", 1 / math.sqrt(n_in))
    return out


def parameter_count(s: Sizes) -> int:
    return sum(math.prod(leaf.shape) for name, leaf in param_layout(s).items()
               if not name.endswith(("running_mean", "running_var")))


# ---------------------------------------------------------------------------
# The encoder, the prediction network and the joint.
# ---------------------------------------------------------------------------


def encode(sd, s: Sizes, wav: torch.Tensor, pr: Precision = FLOAT32) -> torch.Tensor:
    """One call: (n,) float32 waveform in [-1, 1] -> (frames, d_model)."""
    e = s.enc
    x = fc.subsampling(sd, e, fc.log_mel(e, wav), pr) * math.sqrt(e.d_model)
    pos = fc.positional_encoding(x.shape[0], e.d_model, x.device)
    for i in range(e.n_layers):
        pfx = f"encoder.layers.{i}"
        x = x + 0.5 * fc.feed_forward(sd, f"{pfx}.feed_forward1",
                                      fc.layer_norm(sd, f"{pfx}.norm_feed_forward1", x), pr)
        x = x + fc.rel_attention(sd, f"{pfx}.self_attn",
                                 fc.layer_norm(sd, f"{pfx}.norm_self_att", x), pos, e, pr)
        x = x + fc.conv_module(sd, f"{pfx}.conv", fc.layer_norm(sd, f"{pfx}.norm_conv", x), e, pr)
        x = x + 0.5 * fc.feed_forward(sd, f"{pfx}.feed_forward2",
                                      fc.layer_norm(sd, f"{pfx}.norm_feed_forward2", x), pr)
        x = fc.layer_norm(sd, f"{pfx}.norm_out", x)
    return x


def lstm_step(sd, s: Sizes, token: int, state, pr: Precision = FLOAT32):
    """The prediction network on one token from ``state`` (each layer's
    (h, c), (H,) float32): (the last layer's h, the new state)."""
    rnn = "decoder.prediction.dec_rnn.lstm"
    x = sd["decoder.prediction.embed.weight"][token]
    new = []
    for i, (h, c) in enumerate(state):
        gates = (pr.linear(x, sd[f"{rnn}.weight_ih_l{i}"], sd[f"{rnn}.bias_ih_l{i}"])
                 + pr.linear(h, sd[f"{rnn}.weight_hh_l{i}"], sd[f"{rnn}.bias_hh_l{i}"]))
        gi, gf, gg, go = gates.chunk(4)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        x = torch.sigmoid(go) * torch.tanh(c)
        new.append((x, c))
    return x, new


def start_state(s: Sizes, device):
    zero = torch.zeros(s.pred_hidden, device=device)
    return [(zero, zero)] * s.pred_layers


def project_encoder(sd, enc: torch.Tensor, pr: Precision = FLOAT32) -> torch.Tensor:
    return pr.linear(enc, sd["joint.enc.weight"], sd["joint.enc.bias"])


def project_prediction(sd, g: torch.Tensor, pr: Precision = FLOAT32) -> torch.Tensor:
    return pr.linear(g, sd["joint.pred.weight"], sd["joint.pred.bias"])


def joint(sd, f: torch.Tensor, g: torch.Tensor, pr: Precision = FLOAT32) -> torch.Tensor:
    """The projected encoder frames ``f`` and prediction outputs ``g`` ->
    the joint's logits (..., V + 1 + len(D))."""
    return pr.linear(F.relu(f + g), sd["joint.joint_net.2.weight"], sd["joint.joint_net.2.bias"])


# ---------------------------------------------------------------------------
# Greedy TDT decoding, replay and the rules of a path.
# ---------------------------------------------------------------------------


def greedy(sd, s: Sizes, enc: torch.Tensor, pr: Precision = FLOAT32) -> np.ndarray:
    """One call's greedy TDT decoding over its encoder output (frames,
    d_model): its steps (steps, 5) float64, each (frame, token, duration
    index, the token's logit, the duration's logit)."""
    f = project_encoder(sd, enc, pr)
    h, state = lstm_step(sd, s, s.blank, start_state(s, enc.device), pr)
    g = project_prediction(sd, h, pr)
    steps, t, on_frame = [], 0, 0
    while t < enc.shape[0]:
        z = joint(sd, f[t], g, pr)
        tok_v, tok = z[:s.blank + 1].max(0)
        dur_v, dur = z[s.blank + 1:].max(0)
        tok, dur = int(tok), int(dur)
        steps.append((t, tok, dur, float(tok_v), float(dur_v)))
        d = s.durations[dur]
        if tok == s.blank:
            d = max(d, 1)
        else:
            h, state = lstm_step(sd, s, tok, state, pr)
            g = project_prediction(sd, h, pr)
        on_frame = on_frame + 1 if d == 0 else 0
        if on_frame >= s.max_symbols:
            d, on_frame = 1, 0
        t += d
    return np.array(steps, dtype=np.float64).reshape(-1, 5)


def replay(sd, s: Sizes, enc: torch.Tensor, frames, tokens,
           pr: Precision = FLOAT32) -> torch.Tensor:
    """The logits (steps, V + 1 + len(D)) along a given path: step i at
    frame ``frames[i]`` (clamped to the call's), the prediction network fed
    the tokens the path emitted before it (``tokens[j]`` for j < i, blanks
    skipped)."""
    f = project_encoder(sd, enc, pr)
    h, state = lstm_step(sd, s, s.blank, start_state(s, enc.device), pr)
    outputs = [h]
    for tok in tokens[:-1]:
        if int(tok) != s.blank:
            h, state = lstm_step(sd, s, int(tok), state, pr)
        outputs.append(h)
    g = project_prediction(sd, torch.stack(outputs), pr)
    at = torch.as_tensor(np.minimum(np.asarray(frames, np.int64), enc.shape[0] - 1),
                         device=enc.device)
    return joint(sd, f[at], g, pr)


def path_errors(frames, tokens, durations_index, n_frames: int, s: Sizes) -> int:
    """Steps of a call's path that the decoding rules do not allow: a first
    step not at frame 0, a step not at the frame the step before it leads
    to, a step at or past the call's frames, and a path that stops short of
    them (counted as one)."""
    errors, t, on_frame = 0, 0, 0
    for frame, tok, dur in zip(frames, tokens, durations_index):
        if int(frame) != t or t >= n_frames:
            errors += 1
        t = int(frame)
        d = s.durations[int(dur)] if 0 <= int(dur) < len(s.durations) else 1
        if int(tok) == s.blank:
            d = max(d, 1)
        on_frame = on_frame + 1 if d == 0 else 0
        if on_frame >= s.max_symbols:
            d, on_frame = 1, 0
        t += d
    return errors + (t < n_frames)


def phrase_texts(tokens, frames, n_frames: int, pieces) -> list[str]:
    """A call's emitted tokens (and their frames) as its phrases' texts."""
    speech = np.zeros(n_frames, bool)
    speech[np.asarray(frames, np.int64)] = True
    # fastconformer.phrase_spans reads frames as speech where P(blank) <= 0.9:
    # log P(blank) is -inf at a frame with a token and 0 elsewhere.
    blank_logprob = np.where(speech, -np.inf, 0.0).astype(np.float32)[:, None]
    texts = []
    for a, b in fc.phrase_spans(blank_logprob):
        inside = [int(k) for k, t in zip(tokens, frames) if a <= t < b]
        texts.append("".join(pieces[k] for k in inside).replace(fc.WORD_START, " ").strip())
    return texts
