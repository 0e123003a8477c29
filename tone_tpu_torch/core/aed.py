"""The attention encoder-decoder (AED) head over a FastConformer encoder, as
NeMo's ``EncDecMultiTaskModel`` runs Canary-1B-v2: a pre-LN Transformer
decoder (NeMo's ``TransformerDecoder``) with cross-attention to the
encoder's output, its self-attention keys and values kept in a static
cache, and batched greedy decoding on the device.

With V pieces (the special tokens are ids among them), hidden size D, H
heads of d_h = D / H, and the encoder's output m of a window:

* input: e_u = LN_emb(E[y_u] + P[u]), E a V x D embedding and P NeMo's
  ``FixedPositionalEncoding`` (even features sin(u w_k), odd cos(u w_k),
  w_k = 10000^(-2k/D), the table divided by sqrt(D));
* each layer, on the residual stream x::

      x <- x + SelfAttn(LN_1(x))       causal
      x <- x + CrossAttn(LN_2(x), m)   keys and values from m, frames past
                                       the window's length masked
      x <- x + W_2 ReLU(W_1 LN_3(x) + b_1) + b_2

  attention with biases on q, k, v and the output, scores q.k / sqrt(d_h);
* z = W_head LN_final(x) + b_head, the head not tied to E;
* greedy decoding (NeMo's AED greedy, beam 1): from the prompt, append
  argmax z of the last position and repeat; a row stops at ``eos`` or after
  its ``max_tokens``; its output is the generated tokens before ``eos``.

Variables (``params["aed"]``, beside the encoder's)::

    {"embed": (V, D), "embed_norm": norm,
     "layers": ({"norm_self_att", "self_att": {"linear_q", "linear_k",
                 "linear_v", "linear_out"}, "norm_cross_att", "cross_att":
                 {...}, "norm_ff", "ff": {"linear1", "linear2"}}, ...),
     "final_norm": norm, "head": linear (D, V)}

Precision: the port's policy (``core/layers.py``): products of operands in
the compute dtype summed in float32 (``layers._mm``), the residual stream
in the compute dtype, LayerNorms and softmax in float32, the attention
weights rounded to the compute dtype before their product with V, the
logits in float32.  The embedding's sum with the position and LN_emb run
in float32 and are rounded once.  The junction after each sublayer (its
output product's bias, the residual add and the next LayerNorm; the last
one's LN_final) is ``ops/norm_junction.py``'s: kernel B4 on the card, its
plain version on the CPU.

The decode of a batch: each layer's cross-attention keys and values are
projected once from the encoder's output (``aed.prefill``), and the prompt
but its last token runs as one causal pass that fills the self-attention
cache; then every step feeds each row's last token at the next position
(the first step the prompt's last token) and writes its keys and values
into the cache there.  Every row steps in lockstep; a row is live while it
has emitted fewer than its cap and no ``eos``, and a row that is not live
changes nothing of its output (it is fed its last token again).  Each step
of each row is kept in the loop's record (``FIELDS``: the chosen token, 1
where the row was live); for rows the caller names, the steps' float32
logits too, and the cross-attention keys and values the steps read over
the row's frames (``memory``: what a check holds against the encoder's
output of that row's own window).  The host reads whether any row is still live only every
``CHECK_EVERY`` steps; on a card the transcriber replays ``CHECK_EVERY``
steps at a time as one CUDA graph (``GraphedDecoder``), the CPU runs the
same steps eagerly.

Traced (``profiling``), a batch records the spans ``aed.prefill`` and
``aed.decode``; ``count_steps`` records, from a batch's record once it is
on the host (the transcriber's finish, so that counting adds no wait for
the card), the counts ``aed.steps_computed`` (the rows the loop computed
x the steps run: on a card every row of the graph, those past the batch's
own, stopped rows and the steps past the end of a replay included),
``aed.row_steps`` (steps at which a row was live), ``aed.emitted``
(tokens), ``aed.step_bytes`` (``step_bytes``: the bytes the live rows'
steps must read at least) and, as the encoder counts its own,
``fastconformer.junction_bytes`` (``junction_bytes``: the bytes the
decoder's junctions must move for the batch's prompt positions and live
steps, so that kernel B4's share of its roofline reads both).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tone_tpu_torch import profiling
from tone_tpu_torch.config import FastConformerConfig
from tone_tpu_torch.core import graphs
from tone_tpu_torch.core import layers as L
from tone_tpu_torch.device import record_event
from tone_tpu_torch.ops.norm_junction import EPS, JUNCTION_BYTES, layer_norm, norm_junction

__all__ = ["CHECK_EVERY", "FIELDS", "GraphedDecoder", "count_steps", "emitted", "greedy_aed",
           "init_aed_params", "junction_bytes", "parameter_count", "positions_table",
           "step_bytes"]

Params = L.Params
CHECK_EVERY = 16   # steps between the host's reads of whether any row is still live

# The columns of the loop's record (B, steps, len(FIELDS)), float32: the
# step's chosen token, and 1 where the row was live at the step.
FIELDS = ("token", "live")
TOKEN, LIVE = range(len(FIELDS))
PROJECTIONS = ("linear_q", "linear_k", "linear_v", "linear_out")


def init_aed_params(gen: torch.Generator, config: FastConformerConfig) -> Params:
    """``{"aed": ...}`` in float32 from ``gen``: linears uniform in
    1/sqrt(fan-in), the embedding in 1/sqrt(D), norms at their initial
    values."""
    a = config.aed
    d, v = a.hidden, len(config.vocabulary)
    layers = tuple({
        "norm_self_att": L.init_layernorm(d),
        "self_att": {n: L.init_linear(gen, d, d) for n in PROJECTIONS},
        "norm_cross_att": L.init_layernorm(d),
        "cross_att": {n: L.init_linear(gen, d, d) for n in PROJECTIONS},
        "norm_ff": L.init_layernorm(d),
        "ff": {"linear1": L.init_linear(gen, d, a.inner),
               "linear2": L.init_linear(gen, a.inner, d)},
    } for _ in range(a.n_layers))
    return {"aed": {"embed": L._uniform(gen, (v, d), 1.0 / math.sqrt(d)),
                    "embed_norm": L.init_layernorm(d), "layers": layers,
                    "final_norm": L.init_layernorm(d), "head": L.init_linear(gen, d, v)}}


def parameter_count(config: FastConformerConfig) -> int:
    """The decoder's parameters as NeMo counts them: the embedding, every
    weight, bias and norm, and the head (the position table is a buffer)."""
    a = config.aed
    d, f, v = a.hidden, a.inner, len(config.vocabulary)
    layer = 3 * 2 * d + 2 * 4 * (d * d + d) + (d * f + f) + (f * d + d)
    return v * d + 2 * d + a.n_layers * layer + 2 * d + (d * v + v)


def positions_table(n: int, d: int, device) -> torch.Tensor:
    """(n, d) float32: NeMo's ``FixedPositionalEncoding`` of positions 0 to
    n - 1, even features ``sin(u w_k)``, odd ``cos(u w_k)``, ``w_k =
    10000^(-2k/d)``, divided by sqrt(d), computed in float32 as NeMo
    computes it."""
    position = torch.arange(0.0, n, device=device)[:, None]
    div = torch.exp(-math.log(10000.0) / d * torch.arange(0.0, d, 2, device=device))
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe.div_(math.sqrt(d))


def _weights(params: Params, config: FastConformerConfig) -> dict:
    """The decoder's weights as the steps read them: each self-attention's
    W_q ‖ W_k ‖ W_v (D, 3D) and each cross-attention's W_k ‖ W_v (D, 2D) as
    one product, matrices in the compute dtype, biases and norms in
    float32, the embedding and the position table in float32."""
    p = params["aed"]
    dtype = getattr(torch, config.compute_dtype)

    def lin(*parts):
        return {"w": torch.cat([q["w"] for q in parts], dim=1).to(dtype),
                "b": torch.cat([q["b"] for q in parts]).float()}

    layers = []
    for lp in p["layers"]:
        s, c = lp["self_att"], lp["cross_att"]
        layers.append({"qkv": lin(s["linear_q"], s["linear_k"], s["linear_v"]),
                       "self_out": lin(s["linear_out"]), "cross_q": lin(c["linear_q"]),
                       "cross_kv": lin(c["linear_k"], c["linear_v"]),
                       "cross_out": lin(c["linear_out"]), "ff1": lin(lp["ff"]["linear1"]),
                       "ff2": lin(lp["ff"]["linear2"]), "norm_self_att": lp["norm_self_att"],
                       "norm_cross_att": lp["norm_cross_att"], "norm_ff": lp["norm_ff"]})
    embed = p["embed"].float()
    return {"embed": embed, "embed_norm": p["embed_norm"], "layers": layers,
            "final_norm": p["final_norm"], "head": lin(p["head"]),
            "positions": positions_table(config.aed.max_positions, config.aed.hidden,
                                         embed.device)}


class _State(NamedTuple):
    """A batch's decode state, updated in place by its steps: the
    self-attention cache (keys (layers, rows, H, d_h, positions), values
    (layers, rows, H, positions, d_h)), the cross-attention keys and values
    over the encoder's frames (the same layouts), True at each row's frames
    past its length (rows, 1, 1, frames), the position of the next input,
    each row's next input, cap, tokens emitted and whether it emitted
    ``eos``."""

    k: torch.Tensor
    v: torch.Tensor
    ck: torch.Tensor
    cv: torch.Tensor
    frames_off: torch.Tensor
    pos: torch.Tensor
    token: torch.Tensor
    cap: torch.Tensor
    count: torch.Tensor
    done: torch.Tensor


def _new_state(config: FastConformerConfig, rows: int, positions: int, frames: int,
               device) -> _State:
    """A zeroed state: masked keys and values then hold finite numbers, so
    that a weight of 0 times one of them is 0."""
    a = config.aed
    dtype = getattr(torch, config.compute_dtype)
    n, h, dh = a.n_layers, a.n_heads, a.d_head

    def zeros(*shape, dt=dtype):
        return torch.zeros(*shape, dtype=dt, device=device)

    i64 = torch.int64
    return _State(k=zeros(n, rows, h, dh, positions), v=zeros(n, rows, h, positions, dh),
                  ck=zeros(n, rows, h, dh, frames), cv=zeros(n, rows, h, frames, dh),
                  frames_off=zeros(rows, 1, 1, frames, dt=torch.bool), pos=zeros((), dt=i64),
                  token=zeros(rows, dt=i64), cap=zeros(rows, dt=i64),
                  count=zeros(rows, dt=i64), done=zeros(rows, dt=torch.bool))


def _attend(q: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, masked: torch.Tensor,
            dtype) -> torch.Tensor:
    """Attention of queries ``q`` (rows, n, D) over keys ``kt`` (rows, H,
    d_h, K) and values ``v`` (rows, H, K, d_h), True in ``masked``
    (broadcast to (rows, H, n, K)) left out: the context (rows, n, D) in
    ``dtype``."""
    rows, n, d = q.shape
    h, dh = kt.shape[1], kt.shape[2]
    scores = L._mm(q.view(rows, n, h, dh).transpose(1, 2), kt)      # (rows, H, n, K) float32
    scores.mul_(1.0 / math.sqrt(dh)).masked_fill_(masked, -math.inf)
    weights = torch.softmax(scores, dim=-1).to(dtype)
    return L._mm(weights, v).to(dtype).transpose(1, 2).reshape(rows, n, d)


def _pass(w: dict, config: FastConformerConfig, s: _State, tokens: torch.Tensor,
          at: torch.Tensor) -> torch.Tensor:
    """The decoder over ``tokens`` (rows, n) at the positions ``at`` (n,),
    each attending to the cached positions up to its own: writes their keys
    and values into the cache at ``at`` and returns LN_final of the last
    layer's output (rows, n, D) in the compute dtype."""
    dtype = getattr(torch, config.compute_dtype)
    rows, n = tokens.shape
    h, dh = config.aed.n_heads, config.aed.d_head
    e = w["embed"].index_select(0, tokens.reshape(-1)).view(rows, n, -1)
    norm = w["embed_norm"]
    x = F.layer_norm(e + w["positions"].index_select(0, at), e.shape[-1:], norm["scale"],
                     norm["bias"], EPS).to(dtype)
    layers = w["layers"]
    hn = layer_norm(x, layers[0]["norm_self_att"])
    later = torch.arange(s.k.shape[-1], device=tokens.device)[None] > at[:, None]   # (n, P)
    for i, lw in enumerate(layers):
        q, k, v = L.linear(lw["qkv"], hn, dtype).split(hn.shape[-1], dim=-1)
        s.k[i].index_copy_(3, at, k.reshape(rows, n, h, dh).permute(0, 2, 3, 1))
        s.v[i].index_copy_(2, at, v.reshape(rows, n, h, dh).transpose(1, 2))
        ctx = _attend(q, s.k[i], s.v[i], later, dtype)
        x, hn = norm_junction(L.linear_product(lw["self_out"], ctx, dtype), lw["self_out"]["b"],
                              x, 1.0, lw["norm_cross_att"])
        ctx = _attend(L.linear(lw["cross_q"], hn, dtype), s.ck[i], s.cv[i], s.frames_off, dtype)
        x, hn = norm_junction(L.linear_product(lw["cross_out"], ctx, dtype),
                              lw["cross_out"]["b"], x, 1.0, lw["norm_ff"])
        y = L.linear_product(lw["ff2"], L.linear(lw["ff1"], hn, dtype).relu_(), dtype)
        following = layers[i + 1]["norm_self_att"] if i + 1 < len(layers) else w["final_norm"]
        x, hn = norm_junction(y, lw["ff2"]["b"], x, 1.0, following)
    return hn


def _start(w: dict, config: FastConformerConfig, s: _State, enc: torch.Tensor,
           frames: Sequence[int], caps: Sequence[int]) -> None:
    """A batch's state ``s`` (of at least its rows, frames and positions)
    made ready for its first step: each layer's cross-attention keys and
    values projected from ``enc`` (B, T, D) into the first rows and frames,
    the frames past each row's masked (the rows past the batch's keep one
    frame and a cap of 0), the prompt but its last token run through the
    decoder at positions 0.., the last one each row's first input."""
    a = config.aed
    dtype = getattr(torch, config.compute_dtype)
    b, t, d = enc.shape
    h, dh = a.n_heads, a.d_head
    dev = enc.device
    for i, lw in enumerate(w["layers"]):
        k, v = L.linear(lw["cross_kv"], enc, dtype).split(d, dim=-1)
        s.ck[i, :b, :, :, :t].copy_(k.reshape(b, t, h, dh).permute(0, 2, 3, 1))
        s.cv[i, :b, :, :t].copy_(v.reshape(b, t, h, dh).transpose(1, 2))
    rows = s.token.shape[0]
    host = torch.tensor(list(frames) + [1] * (rows - b), dtype=torch.int64)
    caps = torch.tensor(list(caps) + [0] * (rows - b), dtype=torch.int64)
    if dev.type == "cuda":
        host, caps = host.pin_memory(), caps.pin_memory()
    lengths = host.to(dev, non_blocking=True)
    s.frames_off.copy_((torch.arange(s.ck.shape[-1], device=dev) >= lengths[:, None])
                       [:, None, None])
    s.cap.copy_(caps, non_blocking=True)
    s.count.zero_()
    s.done.zero_()
    prompt = torch.tensor(a.prompt, dtype=torch.int64, device=dev)
    if len(a.prompt) > 1:
        _pass(w, config, s, prompt[:-1].expand(rows, -1),
              torch.arange(len(a.prompt) - 1, device=dev))
    s.token.copy_(prompt[-1].expand(rows))
    s.pos.fill_(len(a.prompt) - 1)


def _step(w: dict, config: FastConformerConfig, s: _State, logits: torch.Tensor,
          row: torch.Tensor) -> None:
    """One step of every row, in place on ``s``: the step's float32 logits
    into ``logits`` (rows, V), its record (``FIELDS`` by rows) into ``row``."""
    hn = _pass(w, config, s, s.token[:, None], s.pos.view(1))[:, 0]
    torch.add(L._mm(hn, w["head"]["w"]), w["head"]["b"], out=logits)
    token = logits.argmax(dim=-1)
    live = (s.count < s.cap) & ~s.done
    torch.stack([token.float(), live.float()], out=row)
    s.done.logical_or_(live & (token == config.aed.eos))
    s.count.add_(live)
    torch.where(live, token, s.token, out=s.token)
    s.pos.add_(1)


def _memory(s: _State, row: int, frames: int) -> torch.Tensor:
    """Row ``row``'s cross-attention keys and values over its first
    ``frames`` frames, as the steps read them: (2, layers, frames, D) in
    the compute dtype, keys first."""
    n, _, h, dh, _ = s.ck.shape
    k = s.ck[:, row, :, :, :frames].permute(0, 3, 1, 2).reshape(n, frames, h * dh)
    v = s.cv[:, row, :, :frames].transpose(1, 2).reshape(n, frames, h * dh)
    return torch.stack([k, v])


def _any_live(s: _State) -> torch.Tensor:
    """Whether any row is still live, on the device (rows past a batch's
    have a cap of 0)."""
    return ((s.count < s.cap) & ~s.done).any()


class GraphedDecoder:
    """The loop's steps on a CUDA device, ``CHECK_EVERY`` at a time as one
    CUDA graph, so that the host launches one replay where it would launch
    about 300 kernels a step.  The graph reads the decoder's weights and a
    ``_State`` of its own, of ``rows`` x ``frames`` x ``positions``; it is
    captured again only when a batch needs more (frames in steps of
    ``ROUND``).  A batch fills the first of its rows; the others have a cap
    of 0."""

    ROUND = 128

    def __init__(self, variables: dict, config: FastConformerConfig):
        self.config = config
        self.w = _weights(variables["params"], config)
        self.graph = None
        self.rows = self.frames = self.positions = 0

    def _capture(self, rows: int, frames: int, positions: int, device) -> None:
        torch.cuda.synchronize(device)          # the last graph's replays are done
        self.graph = None
        self.rows, self.frames, self.positions = rows, frames, positions
        self.state = _new_state(self.config, rows, positions, frames, device)
        self.logits = torch.empty(CHECK_EVERY, rows, len(self.config.vocabulary), device=device)
        self.record = torch.empty(CHECK_EVERY, len(FIELDS), rows, device=device)

        self.alive = torch.zeros((), dtype=torch.bool, device=device)
        self.flags = torch.zeros(2, dtype=torch.bool, pin_memory=device.type == "cuda")

        def steps():
            for k in range(CHECK_EVERY):
                _step(self.w, self.config, self.state, self.logits[k], self.record[k])
            self.alive.copy_(_any_live(self.state))

        self.graph = self._graph(steps, device)

    _graph = staticmethod(graphs.capture)

    def prepare(self, b: int, frames: int, positions: int, device) -> _State:
        """The state a batch of ``b`` rows, ``frames`` and ``positions``
        starts from (captured again where it needs more)."""
        frames = -(-frames // self.ROUND) * self.ROUND
        if self.graph is None or b > self.rows or frames > self.frames \
                or positions > self.positions:
            self._capture(max(b, self.rows), max(frames, self.frames),
                          max(positions, self.positions), device)
        return self.state

    def run(self, b: int, max_cap: int, keep: Sequence[int]):
        """(the steps (steps, ``len(FIELDS)``, b), the kept rows' logits
        [(steps, V)]) of the prepared batch's loop from its first step.

        Replays until the caps are reached or no row is live.  Whether any
        row is live after a replay comes back through a pinned flag that
        the host reads after queueing the next replay, so that the card
        always has one queued; the replay past the last live step is all
        rows stopped."""
        chunks, kept, pending = [], [], None
        for replay in range(-(-max(max_cap, 1) // CHECK_EVERY)):
            self.graph.replay()
            chunks.append(self.record[:, :, :b].clone())
            if keep:
                kept.append(self.logits[:, list(keep)].clone())
            if pending is not None:
                flag, events = pending
                for event in events:
                    event.synchronize()
                if not bool(flag):
                    break
            flag = self.flags[replay % 2]
            flag.copy_(self.alive, non_blocking=True)
            pending = flag, record_event(self.alive.device)
        logits = torch.cat(kept).unbind(1) if keep else []
        return torch.cat(chunks), list(logits)


def _bytes_per_step(config: FastConformerConfig) -> int:
    """The weights one step reads: every layer's matrices (its
    self-attention's four, the cross-attention's query and output, the
    feed-forward's two) at the compute dtype's size, their biases and the
    layers' norms, the embedding's and the final norm and the head."""
    a = config.aed
    d, f, v = a.hidden, a.inner, len(config.vocabulary)
    wb = getattr(torch, config.compute_dtype).itemsize
    layer = wb * (6 * d * d + 2 * d * f) + 4 * (7 * d + f + 3 * 2 * d)
    return a.n_layers * layer + 4 * 2 * 2 * d + wb * d * v + 4 * v


def step_bytes(config: FastConformerConfig, live: np.ndarray, frames: Sequence[int]) -> int:
    """The bytes the live steps of a batch (``live``: (B, steps) bool) must
    read at least: the weights once for each step with a live row, and for
    each live row its cross-attention keys and values over its frames and
    its self-attention keys and values up to its position (step s of a row
    at position len(prompt) - 1 + s), at the compute dtype's size."""
    a = config.aed
    live = np.asarray(live, bool)
    if not live.size:
        return 0
    wb = getattr(torch, config.compute_dtype).itemsize
    kv = 2 * a.n_layers * a.hidden * wb          # a key and a value, every layer
    at = np.arange(live.shape[1]) + len(a.prompt)             # positions + 1 read
    frames = np.asarray(frames, np.int64)[:, None]
    rows = int(((frames + at[None]) * live).sum())
    return int(live.any(axis=0).sum()) * _bytes_per_step(config) + kv * rows


@torch.no_grad()
def greedy_aed(variables: dict, config: FastConformerConfig, enc: torch.Tensor,
               frames: Sequence[int], caps: Sequence[int], keep: Sequence[int] = (),
               graphed: GraphedDecoder | None = None):
    """Greedy decoding of a batch of encoder outputs.

    Args:
        enc: (B, T, D), the encoder's output (``encode_fastconformer``).
        frames: each row's valid frames, on the host.
        caps: each row's most tokens (``AEDConfig.max_tokens``).
        keep: rows whose steps' logits and cross-attention memory are
            returned.
        graphed: on a CUDA device, the caller's ``GraphedDecoder`` over the
            same variables runs the steps; without one, they run eagerly.

    Returns:
        (the loop's record (B, steps, ``len(FIELDS)``) float32 on ``enc``'s
        device, row b's step s at ``[b, s]``; steps where ``LIVE`` is 0 are
        not the row's; the logits (steps, V) float32 of each row of
        ``keep``; each such row's ``_memory``).

    Raises:
        ValueError: a cap that runs past the position table.
    """
    a = config.aed
    b, t = enc.shape[0], enc.shape[1]
    dev = enc.device
    max_cap = max(caps)
    # the loop runs whole multiples of CHECK_EVERY steps, past the caps
    positions = len(a.prompt) - 1 + -(-max(max_cap, 1) // CHECK_EVERY) * CHECK_EVERY
    if positions > a.max_positions:
        raise ValueError(f"greedy_aed: the prompt and a cap of {max_cap} tokens run past the "
                         f"{a.max_positions} positions of the decoder's table")
    with profiling.span("aed.prefill"):
        if graphed is not None:
            w, s = graphed.w, graphed.prepare(b, t, positions, dev)
        else:
            w, s = _weights(variables["params"], config), _new_state(config, b, positions, t, dev)
        _start(w, config, s, enc, frames, caps)
        memory = [_memory(s, row, frames[row]) for row in keep]
    with profiling.span("aed.decode"):
        if graphed is not None:
            rec, kept = graphed.run(b, max_cap, keep)
        else:
            rows, logits, step = [], [], 0
            while True:
                rows.append(torch.empty(len(FIELDS), b, device=dev))
                z = torch.empty(b, len(config.vocabulary), device=dev)
                _step(w, config, s, z, rows[-1])
                if keep:
                    logits.append(z[list(keep)])
                step += 1
                if step >= max_cap or step % CHECK_EVERY == 0 and not bool(_any_live(s)):
                    break
            rec = torch.stack(rows)
            kept = list(torch.stack(logits).unbind(1)) if keep else []
        out = rec.permute(2, 0, 1).contiguous()             # (B, steps, FIELDS)
    return out, kept, memory


def junction_bytes(config: FastConformerConfig, rows: int, row_steps: int) -> int:
    """The bytes the decoder's junctions (``ops/norm_junction.py``) must
    move for ``rows`` rows' prompt but its last token and ``row_steps``
    live steps: at each of their positions the first layer's norm alone
    and three single junctions a layer (``JUNCTION_BYTES``) over the hidden
    width."""
    a = config.aed
    per = JUNCTION_BYTES["norm"] + 3 * a.n_layers * JUNCTION_BYTES["single"]
    return a.hidden * per * (rows * (len(a.prompt) - 1) + row_steps)


def count_steps(config: FastConformerConfig, record: np.ndarray, frames: Sequence[int],
                rows: int) -> None:
    """The counts of a batch's loop (module docstring) from its record (B,
    steps, ``len(FIELDS)``) on the host and ``rows``, the rows the loop
    computed, while ``profiling`` records."""
    if not profiling.recording():
        return
    live = record[..., LIVE] > 0
    row_steps = int(live.sum())
    profiling.count("aed.steps_computed", rows * live.shape[1])
    profiling.count("aed.row_steps", row_steps)
    profiling.count("aed.emitted", int((live & (record[..., TOKEN] != config.aed.eos)).sum()))
    profiling.count("aed.step_bytes", step_bytes(config, live, frames))
    profiling.count("fastconformer.junction_bytes",
                    junction_bytes(config, live.shape[0], row_steps))


def emitted(record: np.ndarray, eos: int) -> np.ndarray:
    """The tokens a row emitted, in order, from its record (steps,
    ``len(FIELDS)``) on the host: its live steps' tokens before ``eos``."""
    tokens = record[record[:, LIVE] > 0, TOKEN].astype(np.int64)
    return tokens[tokens != eos]
