"""Plain reference of the FastConformer attention encoder-decoder (NVIDIA
NeMo's ``EncDecMultiTaskModel``, as in Canary-1B-v2:
huggingface.co/nvidia/canary-1b-v2; "Canary-1B-v2 & Parakeet-TDT-0.6B-v3",
arXiv:2509.14128), in float32, one window at a time.

Written out in plain PyTorch from NeMo's modules, with no kernel, no cache
and no batching: every product runs in float32 (TF32 off,
``fastconformer.float32_exactly``) unless a lower ``Precision`` is given,
which is how the benchmark's control is computed.  It imports nothing of
the program it judges.  The weights are a flat ``state_dict`` under NeMo's
names (``param_layout``), in torch's layouts.

The model, per window of audio, with V pieces (the prompt's tokens and
``<|endoftext|>`` are ids among them), hidden size D and H heads:

* the encoder: ``fastconformer.py``'s, everything before its CTC head
  (``encode``);
* ``TransformerEmbedding``: e_u = LayerNorm(E[y_u] + P[u]), P NeMo's
  ``FixedPositionalEncoding`` (even features sin(u w_k), odd cos(u w_k),
  w_k = 10000^(-2k/D), the table divided by sqrt(D));
* ``TransformerDecoder`` with ``pre_ln``, each block on the residual x:
  x + SelfAttn(LN_1(x)) (causal), then x + CrossAttn(LN_2(x), m) over the
  window's encoder output m, then x + dense_out(ReLU(dense_in(LN_3(x))));
  ``MultiHeadAttention`` with biases on ``query_net``, ``key_net``,
  ``value_net`` and ``out_projection``, scores q.k / sqrt(D / H); then
  ``final_layer_norm``;
* ``TokenClassifier`` (``log_softmax.mlp.layer0``): the logits W x + b,
  not tied to E (NeMo's log-softmax after it does not move the argmax);
* greedy decoding (NeMo's AED greedy, beam 1; ``greedy``): from the
  prompt, append the argmax of the last position's logits and repeat,
  until ``<|endoftext|>`` or the window's cap, ceil(``max_tokens_per_second``
  x its seconds).

``forward`` is the decoder's full forward, teacher-forced: the logits of
every position of a given prompt and tokens; ``cross_memory`` every
layer's cross-attention keys and values over a window's encoder output.  ``stop_errors`` says whether
a row's tokens stop where the rules say; ``windows`` cuts a call into its
consecutive windows, and ``window_text`` joins a window's tokens before
``<|endoftext|>`` (the word-start mark read as a space).

Departures from NeMo, each on purpose: those of ``fastconformer.py`` (dither
off, a stand-in vocabulary), the special tokens' ids (the released
tokenizer is not in the repository), and only greedy decoding (no beam, no
timestamps, no translation prompts).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from reference import fastconformer as fc
from reference import transducer as td

Precision = fc.Precision
FLOAT32 = fc.FLOAT32
float32_exactly = fc.float32_exactly
DECODER = "transf_decoder._decoder"
EMBEDDING = "transf_decoder._embedding"
HEAD = "log_softmax.mlp.layer0"

# ---------------------------------------------------------------------------
# Configuration: the encoder's sizes and the decoder's.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Sizes:
    enc: fc.Sizes
    n_layers: int
    hidden: int
    inner: int
    n_heads: int
    prompt: tuple
    eos: int
    window_seconds: float
    max_tokens_per_second: float
    max_positions: int

    @property
    def vocab(self) -> int:
        return len(self.enc.pieces)

    @property
    def d_head(self) -> int:
        return self.hidden // self.n_heads

    @property
    def window(self) -> int:
        """Samples of a full window."""
        return round(self.window_seconds * self.enc.sample_rate)

    def cap(self, n_samples: int) -> int:
        """The most tokens a window of ``n_samples`` emits."""
        return math.ceil(self.max_tokens_per_second * n_samples / self.enc.sample_rate)


def sizes(model: dict) -> Sizes:
    a = model["aed"]
    return Sizes(enc=fc.sizes(model), n_layers=a["n_layers"], hidden=a["hidden"],
                 inner=a["inner"], n_heads=a["n_heads"], prompt=tuple(a["prompt"]),
                 eos=a["eos"], window_seconds=a["window_seconds"],
                 max_tokens_per_second=a["max_tokens_per_second"],
                 max_positions=a["max_positions"])


def param_layout(s: Sizes) -> dict:
    """``fastconformer.param_layout`` of the encoder, with the decoder and
    its head in the CTC head's place: linears uniform in 1/sqrt(fan-in),
    the embedding in 1/sqrt(D), norms as the encoder's."""
    out = {k: v for k, v in fc.param_layout(s.enc).items()
           if not k.startswith("decoder.decoder_layers.")}
    d, f = s.hidden, s.inner

    def weight(name, n_out, n_in):
        out[f"{name}.weight"] = fc.Leaf((n_out, n_in), "uniform", 1 / math.sqrt(n_in))
        out[f"{name}.bias"] = fc.Leaf((n_out,), "uniform", 1 / math.sqrt(n_in))

    def norm(name):
        out[f"{name}.weight"] = fc.Leaf((d,), "one", 0.1)
        out[f"{name}.bias"] = fc.Leaf((d,), "zero", 0.05)

    out[f"{EMBEDDING}.token_embedding.weight"] = fc.Leaf((s.vocab, d), "uniform",
                                                         1 / math.sqrt(d))
    norm(f"{EMBEDDING}.layer_norm")
    for i in range(s.n_layers):
        pfx = f"{DECODER}.layers.{i}"
        for n, sub in ((1, "first_sub_layer"), (2, "second_sub_layer")):
            norm(f"{pfx}.layer_norm_{n}")
            for net in ("query_net", "key_net", "value_net", "out_projection"):
                weight(f"{pfx}.{sub}.{net}", d, d)
        norm(f"{pfx}.layer_norm_3")
        weight(f"{pfx}.third_sub_layer.dense_in", f, d)
        weight(f"{pfx}.third_sub_layer.dense_out", d, f)
    norm(f"{DECODER}.final_layer_norm")
    weight(HEAD, s.vocab, d)
    return out


def parameter_count(s: Sizes) -> int:
    return sum(math.prod(leaf.shape) for name, leaf in param_layout(s).items()
               if not name.endswith(("running_mean", "running_var")))


# ---------------------------------------------------------------------------
# The encoder and the decoder.
# ---------------------------------------------------------------------------


def encode(sd, s: Sizes, wav: torch.Tensor, pr: Precision = FLOAT32) -> torch.Tensor:
    """One window: (n,) float32 waveform in [-1, 1] -> (frames, D)."""
    return td.encode(sd, s, wav, pr)


def positions(n: int, d: int, device) -> torch.Tensor:
    """(n, d): NeMo's ``FixedPositionalEncoding`` table of positions 0 .. n - 1."""
    position = torch.arange(0.0, n, device=device)[:, None]
    div = torch.exp(-math.log(10000.0) / d * torch.arange(0.0, d, 2, device=device))
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe / math.sqrt(d)


def _attention(sd, name, x, memory, causal: bool, s: Sizes, pr: Precision):
    def proj(net, y):
        return pr.linear(y, sd[f"{name}.{net}.weight"], sd[f"{name}.{net}.bias"])

    def heads(y):                                  # (n, D) -> (H, n, d_head)
        return y.reshape(y.shape[0], s.n_heads, s.d_head).transpose(0, 1)

    q, k, v = heads(proj("query_net", x)), heads(proj("key_net", memory)), \
        heads(proj("value_net", memory))
    scores = pr.q(q) @ pr.q(k).transpose(1, 2) / math.sqrt(s.d_head)
    if causal:
        later = torch.ones(x.shape[0], memory.shape[0], dtype=torch.bool,
                           device=x.device).triu(1)
        scores = scores.masked_fill(later, -math.inf)
    ctx = pr.q(torch.softmax(scores, dim=-1)) @ pr.q(v)
    return proj("out_projection", ctx.transpose(0, 1).reshape(x.shape[0], s.hidden))


def forward(sd, s: Sizes, enc: torch.Tensor, tokens, pr: Precision = FLOAT32) -> torch.Tensor:
    """The decoder over ``tokens`` (a prompt and what follows) and a
    window's encoder output ``enc`` (frames, D): the logits (n, V) of every
    position, each attending to the positions up to its own."""
    tok = torch.as_tensor(np.asarray(tokens, np.int64), device=enc.device)
    n = tok.shape[0]
    x = sd[f"{EMBEDDING}.token_embedding.weight"][tok] + positions(n, s.hidden, enc.device)
    x = fc.layer_norm(sd, f"{EMBEDDING}.layer_norm", x)
    for i in range(s.n_layers):
        pfx = f"{DECODER}.layers.{i}"
        h = fc.layer_norm(sd, f"{pfx}.layer_norm_1", x)
        x = x + _attention(sd, f"{pfx}.first_sub_layer", h, h, True, s, pr)
        h = fc.layer_norm(sd, f"{pfx}.layer_norm_2", x)
        x = x + _attention(sd, f"{pfx}.second_sub_layer", h, enc, False, s, pr)
        h = fc.layer_norm(sd, f"{pfx}.layer_norm_3", x)
        ff = f"{pfx}.third_sub_layer"
        h = F.relu(pr.linear(h, sd[f"{ff}.dense_in.weight"], sd[f"{ff}.dense_in.bias"]))
        x = x + pr.linear(h, sd[f"{ff}.dense_out.weight"], sd[f"{ff}.dense_out.bias"])
    x = fc.layer_norm(sd, f"{DECODER}.final_layer_norm", x)
    return pr.linear(x, sd[f"{HEAD}.weight"], sd[f"{HEAD}.bias"])


def cross_memory(sd, s: Sizes, enc: torch.Tensor, pr: Precision = FLOAT32) -> torch.Tensor:
    """Every layer's cross-attention keys and values over a window's
    encoder output ``enc`` (frames, D), as ``_attention`` projects them:
    (2, layers, frames, D), keys first."""
    return torch.stack([torch.stack([
        pr.linear(enc, sd[f"{DECODER}.layers.{i}.second_sub_layer.{net}.weight"],
                  sd[f"{DECODER}.layers.{i}.second_sub_layer.{net}.bias"])
        for i in range(s.n_layers)]) for net in ("key_net", "value_net")])


def teacher_forced(sd, s: Sizes, enc: torch.Tensor, tokens, pr: Precision = FLOAT32):
    """The logits (len(tokens), V) at which each of a row's generated
    ``tokens`` was chosen: ``forward`` over the prompt and the tokens but
    the last, from the prompt's last position on."""
    n = len(s.prompt)
    z = forward(sd, s, enc, list(s.prompt) + [int(t) for t in tokens[:-1]], pr)
    return z[n - 1:n - 1 + len(tokens)]


def greedy(sd, s: Sizes, enc: torch.Tensor, cap: int, pr: Precision = FLOAT32):
    """One window's greedy decoding with no cache (each step the full
    forward over the prompt and the tokens so far): (its tokens, the last
    one ``eos`` where it stopped there; their logits (len, V))."""
    tokens, logits = [], []
    while len(tokens) < cap:
        z = forward(sd, s, enc, list(s.prompt) + tokens, pr)[-1]
        tokens.append(int(z.argmax()))
        logits.append(z)
        if tokens[-1] == s.eos:
            break
    if not logits:
        return tokens, torch.zeros(0, s.vocab, device=enc.device)
    return tokens, torch.stack(logits)


# ---------------------------------------------------------------------------
# Windows, stops and texts.
# ---------------------------------------------------------------------------


def windows(call: np.ndarray, s: Sizes) -> list[np.ndarray]:
    """A call's consecutive windows of ``s.window`` samples, the last one
    what is left (one window for an empty call)."""
    w = s.window
    return [call[k * w:(k + 1) * w] for k in range(max(-(-len(call) // w), 1))]


def stop_errors(live: np.ndarray, tokens: np.ndarray, cap: int, eos: int) -> int:
    """1 where a row's steps break the stopping rules, else 0: its live
    steps are not the first ones, or it stops before ``eos`` and before its
    cap, or runs past either."""
    live = np.asarray(live, bool)
    n = int(live.sum())
    if live[:n].sum() != n:
        return 1
    emitted = np.asarray(tokens, np.int64)[:n]
    ended = n > 0 and emitted[-1] == eos
    if (emitted[:-1] == eos).any() or n > cap or (n < cap and not ended):
        return 1
    return 0


def window_text(tokens, pieces, eos: int) -> str:
    """A window's text: its tokens before ``eos`` joined, the word-start mark
    read as a space, spaces at the ends stripped."""
    out = []
    for t in tokens:
        if int(t) == eos:
            break
        out.append(pieces[int(t)])
    return "".join(out).replace(fc.WORD_START, " ").strip()
