"""The token-and-duration transducer (TDT; Xu et al., "Efficient Sequence
Transduction by Jointly Predicting Tokens and Durations", ICML 2023,
arXiv:2304.06795) over a FastConformer encoder, as NeMo's
``EncDecRNNTBPEModel`` runs Parakeet-TDT-0.6B-v3: the prediction network,
the joint and batched greedy TDT decoding on the device.

With V pieces, the blank is class V and D = ``config.transducer.durations``:

* prediction network (NeMo's ``RNNTDecoder``, ``blank_as_pad``): an
  embedding of the V + 1 classes, the blank's row zero, then LSTM layers
  (PyTorch's gate order i, f, g, o; both biases), from a zero state with
  the blank as the first input;
* joint (``RNNTJoint``): z = W_out ReLU(W_enc f_t + b_enc + W_pred g_u +
  b_pred) + b_out, V + 1 token logits then one logit per duration;
* greedy TDT (NeMo's batched greedy TDT): at frame t take the best token k
  and the best duration d; a token that is not the blank is emitted at t
  and steps the prediction network; a blank with d = 0 takes d = 1; t
  advances by d; a row that has emitted ``max_symbols`` tokens on one frame
  and stays on it advances by one more.

Variables (``params["decoder"]`` and ``params["joint"]``, beside the
encoder's)::

    decoder: {"embed": (V + 1, H),
              "lstm": ({"ih": linear (in, 4H), "hh": linear (H, 4H)}, ...)}
    joint:   {"enc": linear (d_model, J), "pred": linear (H, J),
              "out": linear (J, V + 1 + len(D))}

Precision: the port's policy (``core/layers.py``): products of operands in
the compute dtype summed in float32 (``layers._mm``, ``layers.linear``
with a float32 result), the LSTM's gates, cells and hidden states, the
joint's sum and its logits in float32.  W_enc f_t is one product over
every frame of the batch.

The loop steps every row of the batch in lockstep, on the device, each
row with its own frame, symbols on that frame, LSTM state, last
prediction output and length; a row whose frame has reached its length
changes nothing.  The host reads whether any row is still decoding only
after the fewest steps the longest row can take (its frames over the
largest advance), then every ``CHECK_EVERY`` steps.  Each step of each
row is kept in the loop's record (``FIELDS``), from which the host reads
the emitted tokens.  A step is some 45 small kernels, each launched in
tens of microseconds of host time, so on a card the transcriber replays
``CHECK_EVERY`` steps at a time as one CUDA graph (``GraphedLoop``); the
CPU runs the same steps eagerly.

Traced (``profiling``), a batch's decode records the span
``transducer.decode`` and the counts ``transducer.steps_computed`` (rows
× steps run), ``transducer.row_steps`` (steps at which a row was still
decoding) and ``transducer.emitted`` (tokens).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from tone_tpu_torch import profiling
from tone_tpu_torch.config import PIECE_SPACE, FastConformerConfig
from tone_tpu_torch.core import graphs
from tone_tpu_torch.core import layers as L

__all__ = ["FIELDS", "GraphedLoop", "emitted", "greedy_tdt", "init_transducer_params",
           "joint_logits", "prediction_step", "tokens_text"]

Params = L.Params
CHECK_EVERY = 16   # steps between the host's reads of whether any row still decodes

# The columns of the loop's record (B, steps, len(FIELDS)), float32: the
# step's frame, its best token and duration index, their raw logits, and
# 1 where the row was still decoding at the step.
FIELDS = ("frame", "token", "duration", "token_logit", "duration_logit", "active")
FRAME, TOKEN, DURATION, TOKEN_LOGIT, DURATION_LOGIT, ACTIVE = range(len(FIELDS))


def init_transducer_params(gen: torch.Generator, config: FastConformerConfig) -> Params:
    """``{"decoder", "joint"}`` in float32 from ``gen`` (uniform in
    1/sqrt(fan-in), the embedding in [-1, 1] with the blank's row zero)."""
    t = config.transducer
    v, h, j = config.vocab_size_with_blank, t.pred_hidden, t.joint_hidden
    embed = L._uniform(gen, (v, h), 1.0)
    embed[v - 1] = 0.0
    lstm = []
    for _ in range(t.pred_rnn_layers):
        bound = 1.0 / math.sqrt(h)    # torch.nn.LSTM's: 1/sqrt(hidden)
        lstm.append({"ih": {"w": L._uniform(gen, (h, 4 * h), bound),
                            "b": L._uniform(gen, (4 * h,), bound)},
                     "hh": {"w": L._uniform(gen, (h, 4 * h), bound),
                            "b": L._uniform(gen, (4 * h,), bound)}})
    joint = {"enc": L.init_linear(gen, config.encoder.d_model, j),
             "pred": L.init_linear(gen, h, j),
             "out": L.init_linear(gen, j, v + len(t.durations))}
    return {"decoder": {"embed": embed, "lstm": tuple(lstm)}, "joint": joint}


def _weights(params: Params, dtype) -> dict:
    """The transducer's weights as the loop reads them: the embedding
    and every matrix in ``dtype``, each LSTM layer's W_ih ‖ W_hh (in + H, 4H)
    with b_ih + b_hh in float32 (one product of [x, h] per layer and step),
    the joint's biases in float32."""
    dec, joint = params["decoder"], params["joint"]
    return {"embed": dec["embed"].to(dtype),
            "lstm": [(torch.cat([p["ih"]["w"], p["hh"]["w"]]).to(dtype),
                      p["ih"]["b"].float() + p["hh"]["b"].float()) for p in dec["lstm"]],
            **{k: (joint[k]["w"].to(dtype), joint[k]["b"].float()) for k in ("enc", "pred", "out")}}


def _project(wb: tuple, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` summed and returned in float32."""
    return L._mm(x, wb[0]).add_(wb[1])


def prediction_step(weights: dict, tokens: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The prediction network on ``tokens`` (B,) from the state ``h`` (layers,
    B, H) in the compute dtype and ``c`` (layers, B, H) float32: the new
    (h, c); ``h[-1]`` is the network's output."""
    x = weights["embed"].index_select(0, tokens)
    hn, cn = torch.empty_like(h), torch.empty_like(c)
    for k, wb in enumerate(weights["lstm"]):
        gates = _project(wb, torch.cat([x, h[k]], dim=-1))
        i, f, _, o = torch.sigmoid(gates).chunk(4, dim=-1)
        g = torch.tanh(gates.chunk(4, dim=-1)[2])
        torch.addcmul(f * c[k], i, g, out=cn[k])
        x = torch.mul(o, torch.tanh(cn[k]), out=hn[k])     # rounded once to the dtype
    return hn, cn


def joint_logits(weights: dict, f: torch.Tensor, g: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The joint's float32 logits (B, V + 1 + len(D)) over the projected
    encoder frames ``f`` and prediction outputs ``g`` (float32, (B, J)):
    their sum's ReLU is rounded to the compute dtype in ``z`` (B, J)."""
    return _project(weights["out"], torch.add(f, g, out=z).relu_())


class _Loop(NamedTuple):
    """What a batch's loop reads (``f``: every row's projected frames, row
    b's frame t at ``f[b * stride + t]``; ``end``: b * stride + its length)
    and the state its steps update in place: each row's place in ``f``,
    tokens emitted on its frame, prediction output ``g``, LSTM state ``h``,
    ``c`` and the joint's input ``z``."""

    f: torch.Tensor
    end: torch.Tensor
    at: torch.Tensor
    symbols: torch.Tensor
    g: torch.Tensor
    h: torch.Tensor
    c: torch.Tensor
    z: torch.Tensor


def _step(w: dict, s: _Loop, advance: torch.Tensor, row: torch.Tensor, blank: int,
          max_symbols: int) -> None:
    """One step of every row, in place on ``s``; the step's record (``FIELDS``
    by rows, the frame as a place in ``f``) into ``row``."""
    active = s.at < s.end
    logits = joint_logits(w, s.f.index_select(0, s.at), s.g, s.z)
    token_logit, token = logits[:, :blank + 1].max(-1)
    duration_logit, duration = logits[:, blank + 1:].max(-1)
    torch.stack([s.at.float(), token.float(), duration.float(), token_logit, duration_logit,
                 active.float()], out=row)
    emitting = token != blank
    # advance by duration index: a blank's first (0 taking 1), then a token's
    d = advance.index_select(0, torch.add(duration, emitting, alpha=len(advance) // 2))
    s.symbols.add_(1).mul_(d == 0)          # tokens emitted on this frame, staying
    forced = s.symbols >= max_symbols
    s.at.add_((d + forced) * active)
    s.symbols.masked_fill_(forced, 0)
    emit = emitting & active
    hn, cn = prediction_step(w, token, s.h, s.c)
    torch.where(emit[:, None], _project(w["pred"], hn[-1]), s.g, out=s.g)
    torch.where(emit[None, :, None], hn, s.h, out=s.h)
    torch.where(emit[None, :, None], cn, s.c, out=s.c)


def _advance_table(tc, device) -> torch.Tensor:
    return torch.tensor([max(d, 1) for d in tc.durations] + list(tc.durations), device=device)


class GraphedLoop:
    """The loop's steps on a CUDA device, ``CHECK_EVERY`` at a time as one
    CUDA graph, so that the host launches one replay where it would launch
    some 45 kernels a step.  The graph reads the transducer's weights and a
    batch's ``_Loop`` in buffers of its own, of ``rows`` × ``frames``; it is
    captured again only when a batch needs more (frames in steps of
    ``ROUND``).  A batch is copied into the first of its rows; the others
    end before their first step."""

    ROUND = 256

    def __init__(self, variables: dict, config: FastConformerConfig):
        self.config = config
        self.w = _weights(variables["params"], getattr(torch, config.compute_dtype))
        self.graph = None
        self.rows = self.frames = 0

    def _capture(self, rows: int, frames: int, device) -> None:
        tc, dtype = self.config.transducer, getattr(torch, self.config.compute_dtype)
        torch.cuda.synchronize(device)          # the last graph's replays are done
        self.graph = None
        stride = frames + max(max(tc.durations), 1)
        layers = len(self.w["lstm"])
        self.rows, self.frames, self.stride = rows, frames, stride
        self.loop = _Loop(
            f=torch.zeros(rows * stride, tc.joint_hidden, device=device),
            end=torch.zeros(rows, dtype=torch.int64, device=device),
            at=torch.zeros(rows, dtype=torch.int64, device=device),
            symbols=torch.zeros(rows, dtype=torch.int64, device=device),
            g=torch.zeros(rows, tc.joint_hidden, device=device),
            h=torch.zeros(layers, rows, tc.pred_hidden, dtype=dtype, device=device),
            c=torch.zeros(layers, rows, tc.pred_hidden, device=device),
            z=torch.empty(rows, tc.joint_hidden, dtype=dtype, device=device))
        self.first = torch.arange(rows, device=device) * stride
        self.advance = _advance_table(tc, device)
        self.record = torch.empty(CHECK_EVERY, len(FIELDS), rows, device=device)
        blank = self.config.vocab_size_with_blank - 1

        def steps():
            for k in range(CHECK_EVERY):
                _step(self.w, self.loop, self.advance, self.record[k], blank, tc.max_symbols)

        self.graph = self._graph(steps, device)

    _graph = staticmethod(graphs.capture)

    def run(self, s: _Loop, min_steps: int) -> torch.Tensor:
        """The steps (steps, ``len(FIELDS)``, B) of a batch's loop ``s`` from
        its start, the frame counted from each row's first."""
        b = s.at.shape[0]
        width = s.f.shape[0] // b                # the batch's frames a row
        frames = -(-width // self.ROUND) * self.ROUND
        if self.graph is None or b > self.rows or frames > self.frames:
            self._capture(max(b, self.rows), max(frames, self.frames), s.f.device)
        own = self.loop
        own.f.view(self.rows, self.stride, -1)[:b, :width].copy_(s.f.view(b, width, -1))
        own.at.copy_(self.first)
        own.end.copy_(self.first)
        own.end[:b].add_(s.end - s.at)           # the rows' lengths; the others end at once
        for state, batch in ((own.g, s.g), (own.h, s.h), (own.c, s.c)):
            state.zero_()
            state[..., :b, :].copy_(batch)
        own.symbols.zero_()
        chunks, step = [], 0
        while True:
            self.graph.replay()
            chunks.append(self.record[:, :, :b].clone())
            step += CHECK_EVERY
            if step >= min_steps and not bool((own.at[:b] < own.end[:b]).any()):
                break
        rec = torch.cat(chunks)
        rec[:, FRAME] -= self.first[:b]
        return rec


@torch.no_grad()
def greedy_tdt(variables: dict, config: FastConformerConfig, enc: torch.Tensor,
               lengths: Sequence[int], graphed: GraphedLoop | None = None) -> torch.Tensor:
    """Greedy TDT decoding of a batch of encoder outputs.

    Args:
        enc: (B, T, d_model), the encoder's output (``encode_fastconformer``).
        lengths: each row's valid frames, on the host.
        graphed: on a CUDA device, the caller's ``GraphedLoop`` over the
            same variables runs the steps; without one, they run eagerly.

    Returns:
        The loop's record (B, steps, ``len(FIELDS)``) float32 on ``enc``'s
        device: row b's step s at ``[b, s]``; steps where ``ACTIVE`` is 0
        (the row had reached its length) are not the row's.
    """
    tc = config.transducer
    dtype = getattr(torch, config.compute_dtype)
    dev = enc.device
    b, t_max = enc.shape[0], enc.shape[1]
    blank = config.vocab_size_with_blank - 1
    # A row's frame passes its length by at most the largest advance; its
    # projected frames are padded that far, so that reading them needs no clamp.
    stride = t_max + max(max(tc.durations), 1)
    min_steps = -(-max(lengths) // max(max(tc.durations), 1))
    with profiling.span("transducer.decode"):
        w = graphed.w if graphed is not None else _weights(variables["params"], dtype)
        lens = torch.tensor(lengths, dtype=torch.int64)
        lens = lens.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else lens
        f = torch.nn.functional.pad(_project(w["enc"], enc), (0, 0, 0, stride - t_max))
        start = torch.arange(b, device=dev) * stride
        h = torch.zeros(len(w["lstm"]), b, tc.pred_hidden, dtype=dtype, device=dev)
        h, c = prediction_step(w, torch.full((b,), blank, device=dev), h,
                               torch.zeros(h.shape, device=dev))
        s = _Loop(f=f.view(b * stride, -1), end=start + lens, at=start.clone(),
                  symbols=torch.zeros(b, dtype=torch.int64, device=dev),
                  g=_project(w["pred"], h[-1]), h=h, c=c,
                  z=torch.empty(b, tc.joint_hidden, dtype=dtype, device=dev))
        if graphed is not None:
            rec = graphed.run(s, min_steps)
        else:
            advance, rows, step = _advance_table(tc, dev), [], 0
            while True:
                rows.append(torch.empty(len(FIELDS), b, device=dev))
                _step(w, s, advance, rows[-1], blank, tc.max_symbols)
                step += 1
                if step >= min_steps and (step - min_steps) % CHECK_EVERY == 0 \
                        and not bool((s.at < s.end).any()):
                    break
            rec = torch.stack(rows)
            rec[:, FRAME] -= start
        out = rec.permute(2, 0, 1).contiguous()             # (B, steps, FIELDS)
        if profiling.recording():
            live = out[..., ACTIVE] > 0
            row_steps, tokens_out = torch.stack(
                [live.sum(), (live & (out[..., TOKEN] != blank)).sum()]).tolist()
            profiling.count("transducer.steps_computed", b * out.shape[1])
            profiling.count("transducer.row_steps", row_steps)
            profiling.count("transducer.emitted", tokens_out)
    return out


def emitted(record: np.ndarray, blank: int) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, frames) a row emitted, in order, from its record (steps,
    ``len(FIELDS)``) on the host."""
    record = record[(record[:, ACTIVE] > 0) & (record[:, TOKEN] != blank)]
    return record[:, TOKEN].astype(np.int64), record[:, FRAME].astype(np.int64)


def tokens_text(tokens: Sequence[int], vocabulary: Sequence[str]) -> str:
    """The pieces of ``tokens`` joined, the word-start mark read as a space,
    spaces at the ends stripped."""
    return "".join(vocabulary[k] for k in tokens).replace(PIECE_SPACE, " ").strip()
