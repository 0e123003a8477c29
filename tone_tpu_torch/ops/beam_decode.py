"""Batched CTC prefix beam search on the card (port of
``tone_tpu/ops/beam_decode.py``: the LM-free search, the hotword search and
the fused-LM search).

All streams and all beams advance together, one frame at a time, in torch
tensor ops on the state's device, vectorized over (B, W, V); prefixes merge
by two 32-bit rolling hashes of the collapsed text, and hypotheses come back
from per-frame backpointers.  The host only assembles strings and, in the
decoder, rescores the n-best list with the word LM
(``decoding/rescore.py``).

Semantics are the JAX search's, step for step, so states agree with it: the
hashes, tokens, lengths and last characters bit for bit, the log
probabilities within float rounding.  Three details carry that:

* the best W candidates are the first W of a stable descending sort (XLA's
  TopK keeps the lower index first among equal values, and most candidates
  tie at -inf; ``torch.topk`` promises no order);
* the uint32 hashes are held as int64 and masked to 32 bits after every
  product, with the 32-bit constant split in 16-bit halves so no product
  leaves the int64 range;
* the drop-mode scatter of the token splice writes out-of-range positions
  into one extra column that is then cut off.

The frame loop and the backtrack are Python loops over T (``jax.lax.scan``
in JAX), so each frame issues its tensor ops one by one: on the card the
search is bound by the host's launch rate (PERF.md).  The fused search adds
the LM's hash-table probes to each frame: their uint32 products go through
``_mul_u32`` like the text hashes, and the table keys are compared as int32
(``_as_i32``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tone_tpu_torch.config import BLANK_ID, LABELS
from tone_tpu_torch.device import resolve_device

SPACE_ID = LABELS.index(" ")
NEG_INF = float("-inf")
_U32 = 0xFFFFFFFF
_H1_MUL = 1000003
_H2_MUL = 2654435761   # > 2**31: applied in 16-bit halves (_mul_u32)


class BeamState(NamedTuple):
    """Carried search state for a batch of streams.

    Shapes: (B, W) per beam; ``tokens`` (B, W, L) int8 holds the collapsed
    token ids of each hypothesis (L caps the phrase length).  ``h1``/``h2``
    are uint32 values held in int64; ``lc``, ``lens`` are int64.
    """

    p_b: torch.Tensor    # log P(prefix, ends in blank)
    p_nb: torch.Tensor   # log P(prefix, ends in non-blank)
    h1: torch.Tensor     # rolling hash of the collapsed text (two u32 words)
    h2: torch.Tensor
    lc: torch.Tensor     # last emitted char id; -1 = none yet
    tokens: torch.Tensor
    lens: torch.Tensor

    @property
    def totals(self) -> torch.Tensor:
        return torch.logaddexp(self.p_b, self.p_nb)


def _initial_hashes(beam_width: int) -> tuple[np.ndarray, np.ndarray]:
    w = np.arange(beam_width, dtype=np.uint32)
    h1 = np.where(w == 0, np.uint32(0x811C9DC5), w * np.uint32(0x9E3779B9) + 7)
    h2 = np.where(w == 0, np.uint32(0x85EBCA6B), w * np.uint32(0xC2B2AE35) + 11)
    return h1.astype(np.int64), h2.astype(np.int64)


def init_beam_state(batch: int, beam_width: int, max_len: int = 2048,
                    device: str | torch.device = "cpu") -> BeamState:
    """Fresh state: beam 0 is the empty hypothesis, the rest are -inf
    placeholders with distinct hashes (so they never merge with a live
    beam)."""
    h1, h2 = _initial_hashes(beam_width)
    p_b = torch.full((batch, beam_width), NEG_INF, dtype=torch.float32, device=device)
    p_b[:, 0] = 0.0
    return BeamState(
        p_b=p_b,
        p_nb=torch.full((batch, beam_width), NEG_INF, dtype=torch.float32, device=device),
        h1=torch.from_numpy(h1).to(device).expand(batch, beam_width).clone(),
        h2=torch.from_numpy(h2).to(device).expand(batch, beam_width).clone(),
        lc=torch.full((batch, beam_width), -1, dtype=torch.int64, device=device),
        tokens=torch.zeros((batch, beam_width, max_len), dtype=torch.int8, device=device),
        lens=torch.zeros((batch, beam_width), dtype=torch.int64, device=device),
    )


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for uint32 values ``h`` held in int64, with no
    intermediate above 2**49."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((h * hi) & 0xFFFF) << 16) + h * lo) & _U32


def _mix(h1, h2, v):
    """Extend the rolling hash with token id ``v`` (content-addressed: equal
    collapsed texts always hash equal, independent of the search path).
    uint32 arithmetic of ``tone_tpu/ops/beam_decode.py:89-93`` on int64."""
    u = v + 1
    return ((h1 * _H1_MUL) & _U32) ^ u, (_mul_u32(h2, _H2_MUL) + u) & _U32


class _Consts:
    """Index tensors every frame step reads, made once per advance call."""

    def __init__(self, b_sz: int, w: int, n_char: int, device) -> None:
        i64 = dict(dtype=torch.int64, device=device)
        self.v_ids = torch.arange(n_char, **i64)                      # (C,)
        self.u = self.v_ids + 1
        self.is_space = (self.v_ids == SPACE_ID)[None, None, :]       # (1, 1, C)
        self.char_ext = ~self.is_space
        self.upper = (torch.arange(w, device=device)[:, None]
                      < torch.arange(w, device=device)[None, :])[None]  # (1, Wj, Wi)
        n_ext = w * n_char
        self.e_lc = self.v_ids.repeat(w).expand(b_sz, n_ext)          # (B, E)
        self.e_flag = (self.e_lc[:1] == SPACE_ID)[:, None, :]         # (1, 1, E)
        iota_w = torch.arange(w, **i64)
        self.e_parent = iota_w.repeat_interleave(n_char).expand(b_sz, n_ext)
        # (parent, emit) of a self candidate, and of an inactive stream
        self.self_pe = torch.stack(
            [iota_w, torch.full_like(iota_w, -1)], -1).expand(b_sz, w, 2)
        self.neg_inf_e = torch.full((b_sz, n_ext), NEG_INF, dtype=torch.float32,
                                    device=device)


def _hw_expand(hw, hw_node, hw_tent, hw_bias, is_space, lead_space):
    """Hotword automaton step for every (beam, char) expansion: three dense
    per-(node, char) gathers (``tone_tpu/ops/beam_decode.py:96-129``).
    Parked (-1) until the next boundary; a collapsed (empty-word) space
    doesn't step.  Returns (node, tentative, bias), each (B, W, V-1)."""
    parked = (hw_node < 0)[:, :, None]                        # (B, W, 1)
    safe = hw_node.clamp(min=0)
    next_node, tent_after, delta = hw
    if next_node.ndim == 3:
        # per-row tables (B, n_nodes, n_char): each row its own automaton
        idx = safe[:, :, None].expand(-1, -1, next_node.shape[2])
        nxt = torch.gather(next_node, 1, idx)
        tnt = torch.gather(tent_after, 1, idx)
        dlt = torch.gather(delta, 1, idx)
    else:
        nxt, tnt, dlt = next_node[safe], tent_after[safe], delta[safe]
    node3 = hw_node[:, :, None]
    exp_node = torch.where(parked, torch.where(is_space, 0, node3), nxt)
    exp_tent = torch.where(parked, 0.0, tnt)
    exp_delta = torch.where(parked, 0.0, dlt)
    exp_node = torch.where(lead_space, node3, exp_node)
    exp_tent = torch.where(lead_space, hw_tent[:, :, None], exp_tent)
    exp_delta = torch.where(lead_space, 0.0, exp_delta)
    return exp_node, exp_tent, hw_bias[:, :, None] + exp_delta


def _frame_step(cf, ci, p, active, c: _Consts, hw=None):
    """One frame of prefix beam search for the whole batch
    (``tone_tpu/ops/beam_decode.py:132-278``).

    The carry is two stacked tensors: ``cf`` (B, W, 2|4) float32 holds
    (p_b, p_nb[, tent, bias]) and ``ci`` (B, W, 3|4) int64 holds
    (h1, h2, lc[, node]); ``p`` (B, V) is the frame's pruned log
    probabilities.  ``hw`` (device hotword tables) switches in the biased
    search: ranking uses ``logaddexp(p_b, p_nb) + bias``.  Returns the new
    carry and the (B, W, 2) (parent, emitted token) backpointers."""
    cand_f, cand_i = _candidates(cf, ci, p, c, hw)
    tot = torch.logaddexp(cand_f[..., 0], cand_f[..., 1])
    if hw is not None:
        tot = tot + cand_f[..., 3]
    n_f, n_i = _keep_best(cand_f, cand_i, tot, cf.shape[1])
    # inactive streams: state unchanged, identity backpointers
    keep = active[:, None, None]
    n_ci = ci.shape[2]
    return (torch.where(keep, n_f, cf), torch.where(keep, n_i[..., :n_ci], ci),
            torch.where(keep, n_i[..., n_ci:], c.self_pe))


def _keep_best(cand_f, cand_i, tot, w: int):
    """The best ``w`` candidates by ``tot``: the first W of a stable
    descending sort (XLA's TopK order)."""
    idx = torch.sort(tot, dim=1, descending=True, stable=True)[1][:, :w, None]
    return (torch.gather(cand_f, 1, idx.expand(-1, -1, cand_f.shape[2])),
            torch.gather(cand_i, 1, idx.expand(-1, -1, cand_i.shape[2])))


def _candidates(cf, ci, p, c: _Consts, hw=None):
    """The merged candidates of one frame: ``C = W + W·(V-1)`` rows (selves
    first), as ``cand_f`` (B, C, 2|4) float32 (p_b, p_nb[, tent, bias])
    and ``cand_i`` (B, C, 5|6) int64 (h1, h2, lc[, node], parent, emit) —
    the carry's columns, then the backpointer."""
    p_b, p_nb = cf[..., 0], cf[..., 1]
    h1, h2, lc = ci[..., 0], ci[..., 1], ci[..., 2]
    b_sz, w = p_b.shape
    n_char = p.shape[-1] - 1                 # non-blank tokens 0..V-2

    ptot = torch.logaddexp(p_b, p_nb)
    # --- self candidates: identity unchanged (blank / run-extension) -------
    p_at_lc = torch.gather(p, 1, lc.clamp(min=0))
    p_at_lc = torch.where(lc >= 0, p_at_lc, NEG_INF)
    self_pb = ptot + p[:, BLANK_ID:BLANK_ID + 1]
    lc_space = lc == SPACE_ID
    # lc == space: the re-space collapses into the same prefix, so the
    # whole mass moves: p_total + p[space].
    self_pnb = torch.where(lc_space, ptot, p_nb) + p_at_lc

    # --- expansion candidates: (B, W, V-1) ---------------------------------
    is_space = c.is_space
    is_rep = c.v_ids == lc[:, :, None]                       # repeat char
    exp_pnb = torch.where(is_rep, p_b[:, :, None], ptot[:, :, None]) + p[:, None, :n_char]
    lead_space = is_space & (lc == -1)[:, :, None]           # empty text + space
    h1m = (h1 * _H1_MUL) & _U32
    h2m = _mul_u32(h2, _H2_MUL)
    exp_h1 = torch.where(lead_space, h1[:, :, None], h1m[:, :, None] ^ c.u)
    exp_h2 = torch.where(lead_space, h2[:, :, None], (h2m[:, :, None] + c.u) & _U32)
    exp_e = torch.where(lead_space, -1, c.v_ids)
    # space-after-space already lives in the self candidate
    exp_pnb = torch.where(is_space & lc_space[:, :, None], NEG_INF, exp_pnb)

    # --- merge extensions that share a parent text (the empty beam and the
    # leading-space beam): fold the higher-indexed twin's char extensions
    # into the lower's ---------------------------------------------------------
    donates = ((h1[:, :, None] == h1[:, None, :]) & (h2[:, :, None] == h2[:, None, :])
               & c.upper)                                    # (B, Wj, Wi): i -> j
    has_donor = donates.any(2)
    donor_idx = donates.to(torch.uint8).argmax(2)            # first donor
    donated = torch.gather(exp_pnb, 1, donor_idx[:, :, None].expand(-1, -1, n_char))
    donated = torch.where(has_donor[:, :, None], donated, NEG_INF)
    exp_pnb = torch.where(c.char_ext, torch.logaddexp(exp_pnb, donated), exp_pnb)
    exp_pnb = torch.where(donates.any(1)[:, :, None] & c.char_ext, NEG_INF, exp_pnb)

    # --- merge extensions into selves: a (W·(V-1)) x W identity match ------
    n_ext = w * n_char
    e_h1, e_h2 = exp_h1.reshape(b_sz, n_ext), exp_h2.reshape(b_sz, n_ext)
    e_pnb = exp_pnb.reshape(b_sz, n_ext)
    match = ((e_h1[:, None, :] == h1[:, :, None]) & (e_h2[:, None, :] == h2[:, :, None])
             & (c.e_flag == lc_space[:, :, None]))           # (B, W, E)
    contrib = torch.where(match, e_pnb[:, None, :], NEG_INF)
    m_self_pnb = torch.logaddexp(self_pnb, torch.logsumexp(contrib, -1))
    e_pnb = torch.where(match.any(1), NEG_INF, e_pnb)

    # --- C = W + W*(V-1) candidates (selves first), fields stacked as the
    # carry is, then (parent, emit) ------------------------------------------
    e_i, s_f, e_f = [e_h1, e_h2, c.e_lc], [self_pb, m_self_pnb], [c.neg_inf_e, e_pnb]
    if hw is not None:
        exp_node, exp_tent, exp_bias = _hw_expand(
            hw, ci[..., 3], cf[..., 2], cf[..., 3], is_space, lead_space)
        e_i.append(exp_node.reshape(b_sz, n_ext))
        s_f += [cf[..., 2], cf[..., 3]]
        e_f += [exp_tent.reshape(b_sz, n_ext), exp_bias.reshape(b_sz, n_ext)]
    e_i += [c.e_parent, exp_e.reshape(b_sz, n_ext)]
    cand_i = torch.cat([torch.cat([ci, c.self_pe], -1), torch.stack(e_i, -1)], 1)
    cand_f = torch.cat([torch.stack(s_f, -1), torch.stack(e_f, -1)], 1)
    return cand_f, cand_i


def _backtrack_and_splice(tokens0, lens0, pes):
    """Recover each surviving beam's emitted tokens from the per-frame
    (parent, emit) backpointers ``pes`` (a list of (B, W, 2)) and splice
    them onto its origin beam's buffer."""
    b_sz, w, l_max = tokens0.shape
    w_cur = torch.arange(w, dtype=torch.int64, device=tokens0.device).expand(b_sz, w)
    es = [None] * len(pes)
    for t in range(len(pes) - 1, -1, -1):
        g = torch.gather(pes[t], 1, w_cur[:, :, None].expand(-1, -1, 2))
        w_cur, es[t] = g[..., 0], g[..., 1]
    base = torch.gather(lens0, 1, w_cur)
    old = torch.gather(tokens0, 1, w_cur[:, :, None].expand(-1, -1, l_max))
    if not es:
        return old, base
    es = torch.stack(es, 2)                                  # (B, W, T)
    emask = es >= 0
    offs = torch.cumsum(emask, 2) - emask.long()
    pos = base[:, :, None] + offs
    pos = torch.where(emask & (pos < l_max), pos, l_max)     # column l_max: dropped
    buf = torch.cat([old, old.new_zeros(b_sz, w, 1)], 2)
    buf.scatter_(2, pos, es.to(torch.int8))
    lens = torch.clamp(base + emask.sum(2), max=l_max)
    return buf[:, :, :l_max], lens


def _pruned_frames(logprobs: torch.Tensor, token_min_logp: float) -> torch.Tensor:
    """(T, B, V) frames with tokens below ``token_min_logp`` at -inf, the
    frame's argmax always kept — for all frames at once."""
    lp = logprobs.transpose(0, 1)
    amax = lp.argmax(-1, keepdim=True)
    keepmask = (lp >= token_min_logp) | (
        torch.arange(lp.shape[-1], device=lp.device) == amax)
    return torch.where(keepmask, lp, NEG_INF).contiguous()


def _prepare(logprobs, lengths, device):
    """(B, T, V) float32 logprobs and the (T, B) active mask on ``device``."""
    if not isinstance(logprobs, torch.Tensor):
        logprobs = torch.from_numpy(np.asarray(logprobs, np.float32))
    logprobs = logprobs.to(device=device, dtype=torch.float32)
    b_sz, t_max, _ = logprobs.shape
    if lengths is None:
        active = torch.ones((t_max, b_sz), dtype=torch.bool, device=device)
    else:
        lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int64).to(device)
        active = torch.arange(t_max, device=device)[:, None] < lengths[None, :]
    return logprobs, active


def _advance(base: BeamState, logprobs, active, token_min_logp, extra=None, hw=None):
    """The frame loop and the splice; ``extra`` = (node, tent, bias) of the
    hotword search.  Returns (BeamState, extra')."""
    b_sz, w = base.p_b.shape
    frames = _pruned_frames(logprobs, token_min_logp)
    c = _Consts(b_sz, w, frames.shape[-1] - 1, frames.device)
    f_fields, i_fields = [base.p_b, base.p_nb], [base.h1, base.h2, base.lc]
    if extra is not None:
        i_fields.append(extra[0])
        f_fields += [extra[1], extra[2]]
    cf, ci = torch.stack(f_fields, -1), torch.stack(i_fields, -1)
    pes = []
    for t in range(frames.shape[0]):
        cf, ci, pe = _frame_step(cf, ci, frames[t], active[t], c, hw)
        pes.append(pe)
    tokens, lens = _backtrack_and_splice(base.tokens, base.lens, pes)
    state = BeamState(cf[..., 0], cf[..., 1], ci[..., 0], ci[..., 1], ci[..., 2],
                      tokens, lens)
    if extra is None:
        return state, None
    return state, (ci[..., 3], cf[..., 2], cf[..., 3])


def beam_advance(state: BeamState, logprobs, lengths=None, *,
                 token_min_logp: float = -5.0) -> BeamState:
    """Consume (B, T, V) log-probability frames (natural log) on the state's
    device.

    ``lengths`` (B,) masks per-stream padding frames: frames at ``t >=
    lengths[b]`` leave that stream's state exactly unchanged, so a padded
    batch decodes identically to per-stream calls.
    """
    logprobs, active = _prepare(logprobs, lengths, state.p_b.device)
    return _advance(state, logprobs, active, float(token_min_logp))[0]


def _hyp_text(ids) -> str:
    return "".join(LABELS[i] for i in ids).strip()


def _nbest(scores, tokens, lens, n: int) -> list[list[tuple[str, float]]]:
    scores = scores.cpu().numpy()
    tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
    out = []
    for b in range(scores.shape[0]):
        order = np.argsort(-scores[b], kind="stable")[:n]
        out.append([(_hyp_text(tokens[b, wi, :lens[b, wi]]), float(scores[b, wi]))
                    for wi in order if np.isfinite(scores[b, wi])])
    return out


def beam_nbest(state: BeamState, n: int = 1) -> list[list[tuple[str, float]]]:
    """Host-side readout: per stream, up to ``n`` (text, acoustic_logp)
    pairs, best first.  -inf placeholder beams are dropped."""
    return _nbest(state.totals, state.tokens, state.lens, n)


def beam_search_decode(logprobs, lengths=None, *, beam_width: int = 16,
                       token_min_logp: float = -5.0, max_len: int = 2048,
                       device: str | torch.device | None = None) -> list[str]:
    """Decode a batch of (B, T, V) logprobs to texts on ``device`` (``cuda``
    unless the caller asks for the CPU)."""
    logprobs = np.asarray(logprobs, np.float32)
    state = init_beam_state(logprobs.shape[0], beam_width, max_len, resolve_device(device))
    state = beam_advance(state, logprobs, lengths, token_min_logp=token_min_logp)
    return [hyps[0][0] if hyps else "" for hyps in beam_nbest(state, 1)]


# ---------------------------------------------------------------------------
# Carried-state serving primitives: per-slot reset + top-hypothesis readout.
# With beam_advance they make the search a device-resident arena beside the
# acoustic arena (the engine's interim_device_beam).
# ---------------------------------------------------------------------------


def _mask(mask, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(mask, bool)).to(device)


def beam_reset(state: BeamState, mask) -> BeamState:
    """Reset masked streams to the fresh empty-hypothesis state; others
    unchanged."""
    batch, w = state.p_b.shape
    dev = state.p_b.device
    fresh = init_beam_state(batch, w, state.tokens.shape[-1], dev)
    m2 = _mask(mask, dev)[:, None]
    return BeamState(*(torch.where(m2 if new.ndim == 2 else m2[:, :, None], new, old)
                       for new, old in zip(fresh, state)))


def _top_tokens(scores, tokens, lens):
    best = scores.argmax(1)
    top = torch.gather(tokens, 1, best[:, None, None].expand(-1, 1, tokens.shape[2]))[:, 0]
    return top, torch.gather(lens, 1, best[:, None])[:, 0]


def beam_top_tokens(state: BeamState) -> tuple[torch.Tensor, torch.Tensor]:
    """Best hypothesis per stream as (tokens (B, L), lens (B,)) — gathered
    on the device so one hypothesis per stream crosses to the host."""
    return _top_tokens(state.totals, state.tokens, state.lens)


def top_texts(tokens, lens) -> list[str]:
    """Host-side string assembly for :func:`beam_top_tokens` output."""
    tokens = tokens.cpu().numpy() if isinstance(tokens, torch.Tensor) else np.asarray(tokens)
    lens = lens.cpu().numpy() if isinstance(lens, torch.Tensor) else np.asarray(lens)
    return [_hyp_text(row[:n]) for row, n in zip(tokens, lens)]


# ---------------------------------------------------------------------------
# Hotword (contextual-biasing) search: the host automaton
# (decoding/hotwords.py) as dense trie arrays riding the beam state, stepped
# for all (W, V-1) expansions inside the frame step so the bias steers
# pruning.
# ---------------------------------------------------------------------------


class HotwordTables(NamedTuple):
    """Dense automaton step tables: for an active node n and emitted char
    c, the next node (-1 = park), the tentative boost at the new node, and
    the score delta (word-boundary commits, retractions and Aho–Corasick
    word-aligned suffix rematches folded in at build time).  Node 0 is the
    root; the node count is padded to a power of two.

    Held as numpy arrays on the host: stacking per-row tables
    (:func:`stack_hotword_tables`) is host work, and each search call
    uploads its tables once."""

    next_node: "np.ndarray"   # (n_nodes, n_char) int32, -1 = parked
    tent_after: "np.ndarray"  # (n_nodes, n_char) f32 tentative at next_node
    delta: "np.ndarray"       # (n_nodes, n_char) f32 score delta
    weight: "np.ndarray"      # () f32 boost per matching character


def make_hotword_tables(phrases, weight: float = 10.0,
                        pad_nodes: int | None = None) -> HotwordTables:
    """Build the tables from words/phrases (host-side, once per list):
    every (node, char) transition is one HotwordScorer.step simulation.
    ``pad_nodes`` pads the node axis to a given count (>= the natural
    power-of-two pad)."""
    from tone_tpu_torch.decoding.hotwords import HotwordScorer

    scorer = HotwordScorer(phrases, weight)
    n_char = len(LABELS)
    n_nodes = len(scorer._children)
    padded = 1 << (n_nodes - 1).bit_length() if n_nodes > 1 else 1
    if pad_nodes is not None:
        if pad_nodes < n_nodes:
            raise ValueError(f"pad_nodes={pad_nodes} < {n_nodes} trie nodes")
        padded = pad_nodes
    next_node = np.full((padded, n_char), -1, np.int32)
    tent_after = np.zeros((padded, n_char), np.float32)
    delta = np.zeros((padded, n_char), np.float32)
    for node, kids in enumerate(scorer._children):
        for ch in kids:
            if ch not in LABELS:
                raise ValueError(f"hotword character {ch!r} not in the label set")
        tent = scorer._tent_at[node]
        for cid, ch in enumerate(LABELS):
            (nxt, t_new), d = scorer.step((node, tent), ch)
            next_node[node, cid] = nxt
            tent_after[node, cid] = t_new
            delta[node, cid] = d
    return HotwordTables(next_node, tent_after, delta, np.float32(weight))


def pad_hotword_tables(tables: HotwordTables, n_nodes: int) -> HotwordTables:
    """Pad the node axis to ``n_nodes`` (new nodes park every transition, so
    behaviour is unchanged)."""
    n = int(tables.next_node.shape[0])
    if n >= n_nodes:
        return tables
    pad = ((0, n_nodes - n), (0, 0))
    return HotwordTables(
        np.pad(tables.next_node, pad, constant_values=-1),
        np.pad(tables.tent_after, pad),
        np.pad(tables.delta, pad),
        tables.weight)


def stack_hotword_tables(rows: "list[HotwordTables | None]",
                         n_rows: int | None = None) -> HotwordTables:
    """Stack per-row tables into (B, n_nodes, n_char) tables so one call
    decodes rows with different hotword lists.  Rows pad on the node axis to
    the power-of-two maximum; ``None`` rows (and rows past ``len(rows)`` up
    to ``n_rows``) get the dead automaton, which never biases."""
    n_char = len(LABELS)
    n_nodes = max((int(r.next_node.shape[0]) for r in rows
                   if r is not None), default=1)
    n_nodes = 1 << (n_nodes - 1).bit_length() if n_nodes > 1 else 1
    b = max(n_rows or 0, len(rows))
    next_node = np.full((b, n_nodes, n_char), -1, np.int32)
    tent_after = np.zeros((b, n_nodes, n_char), np.float32)
    delta = np.zeros((b, n_nodes, n_char), np.float32)
    for i, r in enumerate(rows):
        if r is None:
            continue
        n = int(r.next_node.shape[0])
        next_node[i, :n] = r.next_node
        tent_after[i, :n] = r.tent_after
        delta[i, :n] = r.delta
    return HotwordTables(next_node, tent_after, delta, np.float32(0.0))


def _device_tables(hw: HotwordTables, device):
    """(next_node int64, tent_after, delta) on ``device``: one upload."""
    return (torch.from_numpy(np.asarray(hw.next_node, np.int64)).to(device),
            torch.from_numpy(np.asarray(hw.tent_after, np.float32)).to(device),
            torch.from_numpy(np.asarray(hw.delta, np.float32)).to(device))


class HotBeamState(NamedTuple):
    """Beam state + per-beam automaton (node, tentative, bias)."""

    base: BeamState
    node: torch.Tensor   # (B, W) int64
    tent: torch.Tensor   # (B, W) f32 retractable boost
    bias: torch.Tensor   # (B, W) f32 total applied boost

    @property
    def scores(self) -> torch.Tensor:
        return self.base.totals + self.bias


def init_hot_beam_state(batch: int, beam_width: int, max_len: int = 2048,
                        device: str | torch.device = "cpu") -> HotBeamState:
    base = init_beam_state(batch, beam_width, max_len, device)
    zeros = torch.zeros((batch, beam_width), dtype=torch.float32, device=device)
    return HotBeamState(base, torch.zeros_like(base.lc), zeros, zeros.clone())


def hot_beam_advance(state: HotBeamState, logprobs, lengths=None, *,
                     hotwords: HotwordTables,
                     token_min_logp: float = -5.0) -> HotBeamState:
    """:func:`beam_advance` with contextual biasing riding the state."""
    dev = state.base.p_b.device
    logprobs, active = _prepare(logprobs, lengths, dev)
    base, extra = _advance(state.base, logprobs, active, float(token_min_logp),
                           extra=(state.node, state.tent, state.bias),
                           hw=_device_tables(hotwords, dev))
    return HotBeamState(base, *extra)


def hot_beam_reset(state: HotBeamState, mask) -> HotBeamState:
    """:func:`beam_reset` for the biased arena (serving interims)."""
    m2 = _mask(mask, state.node.device)[:, None]
    return HotBeamState(
        base=beam_reset(state.base, mask),
        node=torch.where(m2, 0, state.node),
        tent=torch.where(m2, 0.0, state.tent),
        bias=torch.where(m2, 0.0, state.bias),
    )


def hot_beam_top_tokens(state: HotBeamState) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`beam_top_tokens` ranking by the biased score."""
    return _top_tokens(state.scores, state.base.tokens, state.base.lens)


def hot_beam_nbest(state: HotBeamState, n: int = 1) -> list[list[tuple[str, float]]]:
    """Per stream, up to ``n`` (text, acoustic_logp + bias) pairs — the
    ranking the host hotword search uses (biased totals)."""
    return _nbest(state.scores, state.base.tokens, state.base.lens, n)


# ---------------------------------------------------------------------------
# Shallow fusion: the word n-gram LM (decoding/device_lm.py) joins the search
# itself (``tone_tpu/ops/beam_decode.py:658-1162``).  Per-beam word-context
# ids, a vocab-trie node for the in-progress word and the accumulated fusion
# score ride the beam state; the space expansion scores its completed word
# with a Katz-backoff walk over the LM's hash tables, inside the frame step,
# so the LM steers pruning (pyctcdecode-style fusion, not n-best rescoring).
# ---------------------------------------------------------------------------

LOG10_TO_LN = float(np.log(10.0))
_FIB = 0x9E3779B1                      # Fibonacci bucket multiplier (device_lm)
_SEED1, _SEED2 = 0x811C9DC5, 0x85EBCA6B
_COMBINE_A = 8978948897894561157       # kenlm_binary.combine_word_hash constants
_COMBINE_B = 17894857484156487943
_iotas: dict = {}


def _iota(n: int, device) -> torch.Tensor:
    """``arange(n)`` on ``device``, made once (a probe window's offsets)."""
    key = (n, str(device))
    t = _iotas.get(key)
    if t is None:
        t = _iotas[key] = torch.arange(n, dtype=torch.int64, device=device)
    return t


class FusedBeamState(NamedTuple):
    """Beam state + the LM riding it (+ the hotword automaton, when the
    search is biased).  Word ids, trie nodes and automaton nodes are int64."""

    base: BeamState
    ctx: torch.Tensor     # (B, W, order-1) word ids, -1 = missing
    node: torch.Tensor    # (B, W) vocab-trie node; 0 root, -1 dead
    wid: torch.Tensor     # (B, W) node_word[node] (-1 = not a word)
    lm_sc: torch.Tensor   # (B, W) f32 accumulated fusion score (natural log)
    hw_node: torch.Tensor | None = None   # (B, W)
    hw_tent: torch.Tensor | None = None   # (B, W) f32 retractable boost
    hw_bias: torch.Tensor | None = None   # (B, W) f32 total applied boost

    @property
    def scores(self) -> torch.Tensor:
        s = self.base.totals + self.lm_sc
        return s if self.hw_bias is None else s + self.hw_bias


def init_fused_beam_state(batch: int, beam_width: int, lm, max_len: int = 2048,
                          hotwords: HotwordTables | None = None,
                          device: str | torch.device = "cpu") -> FusedBeamState:
    """``lm`` is a decoding.device_lm.DeviceLM or DeviceProbingLM."""
    k = lm.order - 1
    ctx = torch.full((batch, beam_width, k), -1, dtype=torch.int64, device=device)
    if k:
        ctx[:, :, -1] = lm.bos_id  # host begin_context() == ("<s>",)

    def zeros(dtype):
        return torch.zeros((batch, beam_width), dtype=dtype, device=device)

    hot = hotwords is not None
    return FusedBeamState(
        base=init_beam_state(batch, beam_width, max_len, device), ctx=ctx,
        node=zeros(torch.int64),
        wid=torch.full((batch, beam_width), -1, dtype=torch.int64, device=device),
        lm_sc=zeros(torch.float32),
        hw_node=zeros(torch.int64) if hot else None,
        hw_tent=zeros(torch.float32) if hot else None,
        hw_bias=zeros(torch.float32) if hot else None)


def _as_i32(h: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 as int32 of the same bits — the
    representation of the LM tables' key columns (an int64 key >= 2**31
    never equals an int32 column: promotion would compare -1 with 2**32-1)."""
    return (h - ((h >> 31) << 32)).to(torch.int32)


def _probe(table: torch.Tensor, probe: int, key1: torch.Tensor, keys: torch.Tensor):
    """Probe an open-addressing table for uint32 keys: bucket = the high
    bits of ``key1 * 0x9E3779B1`` (a wrapping u32 product), then a linear
    window of ``probe`` rows, gathered at once.  ``keys`` (..., n) are the
    keys to match against the rows' first n columns.  Returns (found,
    payload): the other columns of the first matching row (of the window's
    first row where none matches)."""
    size = table.shape[0]
    shift = 32 - size.bit_length() + 1
    base = _mul_u32(key1, _FIB) >> shift
    rows = table[(base[..., None] + _iota(probe, key1.device)) & (size - 1)]
    n = keys.shape[-1]
    hit = (rows[..., :n] == _as_i32(keys)[..., None, :]).all(-1)    # (..., P)
    first = hit.to(torch.uint8).argmax(-1)
    idx = first[..., None, None].expand(*first.shape, 1, rows.shape[-1] - n)
    return hit.any(-1), torch.gather(rows[..., n:], -2, idx)[..., 0, :]


def _lm_lookup(lm, h1, h2):
    """(found, log10 prob, log10 backoff) for uint32 query hashes of any
    shape: key compare and payload from one row gather (the floats are a
    bitcast of the int32 columns; 0.0 where not found)."""
    found, payload = _probe(lm.table, lm.probe, h1, torch.stack([h1, h2], -1))
    payload = torch.where(found[..., None], payload.view(torch.float32), 0.0)
    return found, payload[..., 0], payload[..., 1]


def _mix_u(h1, h2, u):
    """:func:`_mix` with ``u = v + 1`` given."""
    return ((h1 * _H1_MUL) & _U32) ^ u, (_mul_u32(h2, _H2_MUL) + u) & _U32


def _lm_score(lm, ctx, wid):
    """log10 P(wid | ctx) with Katz backoff; ctx (..., K) word ids (-1 =
    missing), wid (...).  Twin of DeviceLM.score_ids / ArpaLM.score:
    longest context first, accumulating dropped contexts' backoffs.  All
    (2K+1) gram/context queries go through one stacked lookup.

    Probing-binary arrays dispatch to the KenLM-semantics scorer."""
    from tone_tpu_torch.decoding.device_lm import DeviceProbingLMArrays

    if isinstance(lm, DeviceProbingLMArrays):
        return _lm_score_probing(lm, ctx, wid)
    k = ctx.shape[-1]
    m1 = (_SEED1 * _H1_MUL) & _U32            # the seed's first products
    m2 = (_SEED2 * _H2_MUL) & _U32
    u, uw = ctx + 1, wid + 1
    # column i: the chain hash of ctx[i:] (the context of length k - i),
    # grown one position per step
    s1, s2 = u ^ m1, (u + m2) & _U32
    for step in range(1, k):
        t1, t2 = _mix_u(s1[..., :k - step], s2[..., :k - step], u[..., step:])
        s1 = torch.cat([t1, s1[..., k - step:]], -1)
        s2 = torch.cat([t2, s2[..., k - step:]], -1)
    g1, g2 = _mix_u(s1, s2, uw[..., None])    # the gram (ctx[i:], wid)
    # query columns: grams of length k+1 .. 2, the unigram, contexts of
    # length k .. 1 — longest first, as the walk reads them
    q1 = torch.cat([g1, (uw ^ m1)[..., None], s1], -1)
    q2 = torch.cat([g2, ((uw + m2) & _U32)[..., None], s2], -1)
    found, prob, bo = _lm_lookup(lm, q1, q2)

    # The walk: the longest gram found (with a whole context) gives the
    # probability; every context longer than it that is found adds its
    # backoff, summed longest first.  No gram found at all gives 0.
    valid = ctx >= 0
    hit = found[..., :k + 1] & torch.nn.functional.pad(valid, (0, 1), value=True)
    bo = torch.where(found[..., k + 1:] & valid, bo[..., k + 1:], 0.0)
    sums = [torch.zeros_like(bo[..., 0])]
    for level in range(k):
        sums.append(sums[-1] + bo[..., level])
    first = hit.to(torch.uint8).argmax(-1, keepdim=True)
    return (torch.gather(prob[..., :k + 1], -1, first)
            + torch.gather(torch.stack(sums, -1), -1, first))[..., 0]


# --- KenLM probing binaries: the 64-bit chain hash ---------------------------
# A probing ``kenlm.bin`` stores grams only as 64-bit chained hashes
# (kenlm_binary.combine_word_hash), recomputed here in two uint32 limbs held
# in int64 (JAX's emulation on the TPU; int64 products would overflow).


def _umul32_wide(a, c32: int):
    """``a`` (uint32 values in int64) * ``c32`` (< 2**32) as (high, low)
    uint32 words, exactly: ``a`` times each 16-bit half of ``c32`` is below
    2**48."""
    x = a * (c32 >> 16)
    s = ((x & 0xFFFF) << 16) + a * (c32 & 0xFFFF)       # < 2**49
    return (x >> 16) + (s >> 32), s & _U32


def _mul64_const(hi, lo, c: int):
    """(hi, lo) u64 * c mod 2**64 -> (hi, lo); ``hi=None`` means 0."""
    c_lo, c_hi = c & _U32, (c >> 32) & _U32
    p_hi, p_lo = _umul32_wide(lo, c_lo)
    out_hi = p_hi + _mul_u32(lo, c_hi)
    if hi is not None:
        out_hi = out_hi + _mul_u32(hi, c_lo)
    return out_hi & _U32, p_lo


def _combine64(hi, lo, wid):
    """KenLM CombineWordHash: ``(h * A) ^ ((1 + w) * B)`` mod 2**64, with
    ``w`` a word id (-1 chains garbage, masked by the caller's validity
    flag)."""
    ha_hi, ha_lo = _mul64_const(hi, lo, _COMBINE_A)
    wb_hi, wb_lo = _mul64_const(None, (wid + 1) & _U32, _COMBINE_B)
    return ha_hi ^ wb_hi, ha_lo ^ wb_lo


def _salts(k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) words of the order salts of the probing queries: the
    extensions n = 2..k+1, then the contexts of length 2..k."""
    key = ("salt", k, str(device))
    t = _iotas.get(key)
    if t is None:
        from tone_tpu_torch.decoding.device_lm import _order_salt

        s = [_order_salt(n) for n in range(2, k + 2)] + [_order_salt(n) for n in range(2, k + 1)]
        t = _iotas[key] = (torch.tensor([x & _U32 for x in s], device=device),
                           torch.tensor([x >> 32 for x in s], device=device))
    return t


def _lm_score_probing(lm, ctx, wid):
    """log10 P(wid | ctx) against a probing binary's own tables — twin of
    KenLMBinary.score_ids (short-to-long extension, then backoff weights of
    context grams at least as long as the match).  All ids are KenLM
    vocabulary ids (OOV = 0); ctx entries of -1 are missing.  The
    extension chain (wid, ctx[-1], ctx[-2], …) and the context chain
    (ctx[-1], ctx[-2], …) combine with the same word at each depth, so they
    advance stacked; all (2K-1) probes go through one lookup."""
    k = ctx.shape[-1]
    order = k + 1
    prob = lm.uni_prob[wid]
    if k == 0:
        return prob
    e_hi, e_lo = _combine64(None, wid, ctx[..., k - 1])
    ext, ctxs = [(e_hi, e_lo)], []
    if k > 1:
        hi = torch.stack([e_hi, torch.zeros_like(e_hi)])
        lo = torch.stack([e_lo, ctx[..., k - 1].clamp(min=0)])
        for depth in range(2, k + 1):
            hi, lo = _combine64(hi, lo, ctx[..., k - depth])
            ext.append((hi[0], lo[0]))
            ctxs.append((hi[1], lo[1]))
    salt_lo, salt_hi = _salts(k, ctx.device)
    q1 = torch.stack([lo for _, lo in ext + ctxs], -1) ^ salt_lo
    q2 = torch.stack([hi for hi, _ in ext + ctxs], -1) ^ salt_hi
    found, qprob, qbo = _lm_lookup(lm, q1, q2)

    valid = ctx >= 0
    matched = torch.ones_like(wid)
    alive = torch.ones_like(wid, dtype=torch.bool)
    for i, n in enumerate(range(2, order + 1)):
        hit = alive & valid[..., k - (n - 1)] & found[..., i]
        prob = torch.where(hit, qprob[..., i], prob)
        matched = torch.where(hit, n, matched)
        alive = hit
    cid1 = ctx[..., k - 1]
    ubo = lm.uni_backoff[cid1.clamp(min=0)]
    backoff = torch.where((cid1 >= 0) & (matched <= 1), ubo, 0.0)
    for j, clen in enumerate(range(2, order)):
        qi = k + j
        backoff = backoff + torch.where(valid[..., k - clen] & (matched <= clen)
                                        & found[..., qi], qbo[..., qi], 0.0)
    return prob + backoff


def _trie_step(lm, node, char):
    """Vocab-trie transition: (child, child's terminal word id) from one
    row gather over the edge table (rows: key, child, node_word[child]).
    -1 propagates (dead = not a vocab prefix)."""
    key = (node * len(LABELS) + char) & _U32
    found, out = _probe(lm.edges, lm.edge_probe, key, key[..., None])
    out = torch.where((found & (node >= 0))[..., None], out, -1).long()
    return out[..., 0], out[..., 1]


class _Fusion:
    """What a fused frame step reads besides its carry: the LM's device
    view and the fusion weights as float32 values (JAX's
    ``(alpha * LOG10_TO_LN) * score + beta`` in float32)."""

    def __init__(self, lm, alpha: float, beta: float) -> None:
        self.lm = lm
        self.scale = float(np.float32(np.float32(alpha) * np.float32(LOG10_TO_LN)))
        self.beta = float(np.float32(beta))


def _fused_frame_step(cf, ci, li, lm_sc, p, active, c: _Consts, fz: _Fusion, hw=None):
    """One fused frame (``tone_tpu/ops/beam_decode.py:913-1071``): the
    LM-free candidates and merges of :func:`_candidates`, ranked by
    acoustic + fusion (+ hotword) score, with the LM state reconstructed on
    the W survivors from (parent, emitted).

    Carry: ``cf``/``ci`` as in :func:`_frame_step`; ``li`` (B, W, 2+K)
    int64 holds (trie node, its word id, the K context word ids);
    ``lm_sc`` (B, W) the fusion score.  The only pre-prune LM work is one
    word score per beam (the space expansion needs it in the ranking)."""
    lm = fz.lm
    lc = ci[..., 2]
    node, nw, ctx = li[..., 0], li[..., 1], li[..., 2:]
    k = ctx.shape[-1]
    b_sz, w = lc.shape

    # --- the one pre-prune LM computation: the space expansion's word ------
    word_event = (lc >= 0) & (lc != SPACE_ID)
    is_vocab = nw >= 0    # a word id implies a live node (dead nodes carry -1)
    wid = torch.where(is_vocab, nw, lm.unk_id)     # scored as <unk> (host parity)
    # an OOV word stays in the context as an id that hashes to nothing
    ctx_wid = torch.where(is_vocab, wid, lm.oov_ctx_id)
    delta = _lm_score(lm, ctx, wid) * fz.scale + fz.beta
    exp_lm = lm_sc[:, :, None] + torch.where(c.is_space & word_event[:, :, None],
                                             delta[:, :, None], 0.0)

    cand_f, cand_i = _candidates(cf, ci, p, c, hw)
    c_lm = torch.cat([lm_sc, exp_lm.reshape(b_sz, -1)], 1)
    tot = torch.logaddexp(cand_f[..., 0], cand_f[..., 1]) + c_lm
    if hw is not None:
        tot = tot + cand_f[..., 3]
    n_f, n_i = _keep_best(cand_f, cand_i, tot, w)
    n_parent, n_e = n_i[..., -2], n_i[..., -1]

    # --- post-prune LM state transitions on the W survivors ----------------
    completed = n_e == SPACE_ID                    # a space with a word event
    shifted = torch.cat([ctx[..., 1:], ctx_wid[..., None]], -1) if k else ctx
    par = torch.cat([li, shifted], -1)             # node, nw, ctx, shifted ctx
    g = torch.gather(par, 1, n_parent[..., None].expand(-1, -1, par.shape[2]))
    gf = torch.gather(torch.stack([lm_sc, delta], -1), 1,
                      n_parent[..., None].expand(-1, -1, 2))
    p_node = g[..., 0]
    new_ctx = torch.where(completed[..., None], g[..., 2 + k:], g[..., 2:2 + k])
    is_char = n_e >= 0                  # a character, unless completed
    child, child_word = _trie_step(lm, p_node, n_e.clamp(min=0))
    new_node = torch.where(completed, 0, torch.where(is_char, child, p_node))
    new_nw = torch.where(completed, -1, torch.where(is_char, child_word, g[..., 1]))
    new_lm = gf[..., 0] + torch.where(completed, gf[..., 1], 0.0)
    new_li = torch.cat([new_node[..., None], new_nw[..., None], new_ctx], -1)

    keep = active[:, None, None]
    n_ci = ci.shape[2]
    return (torch.where(keep, n_f, cf), torch.where(keep, n_i[..., :n_ci], ci),
            torch.where(keep, new_li, li), torch.where(active[:, None], new_lm, lm_sc),
            torch.where(keep, n_i[..., n_ci:], c.self_pe))


def fused_beam_advance(state: FusedBeamState, logprobs, lm_arrays, lengths=None, *,
                       alpha: float = 0.4, beta: float = 0.9,
                       token_min_logp: float = -5.0,
                       hotwords: HotwordTables | None = None) -> FusedBeamState:
    """Consume (B, T, V) frames with the LM fused into the search, on the
    state's device.

    ``lm_arrays`` is ``lm.arrays(device)`` of a DeviceLM or DeviceProbingLM.
    Same masking semantics as :func:`beam_advance`.  ``hotwords`` adds
    contextual biasing on top of the fusion (the state must come from
    ``init_fused_beam_state(..., hotwords=...)``).
    """
    base = state.base
    b_sz, w = base.p_b.shape
    dev = base.p_b.device
    logprobs, active = _prepare(logprobs, lengths, dev)
    frames = _pruned_frames(logprobs, float(token_min_logp))
    c = _Consts(b_sz, w, frames.shape[-1] - 1, dev)
    fz = _Fusion(lm_arrays, alpha, beta)
    hw = None
    f_fields, i_fields = [base.p_b, base.p_nb], [base.h1, base.h2, base.lc]
    if hotwords is not None:
        hw = _device_tables(hotwords, dev)
        i_fields.append(state.hw_node)
        f_fields += [state.hw_tent, state.hw_bias]
    cf, ci = torch.stack(f_fields, -1), torch.stack(i_fields, -1)
    li = torch.cat([state.node[..., None], state.wid[..., None], state.ctx], -1)
    lm_sc = state.lm_sc
    pes = []
    for t in range(frames.shape[0]):
        cf, ci, li, lm_sc, pe = _fused_frame_step(cf, ci, li, lm_sc, frames[t],
                                                  active[t], c, fz, hw)
        pes.append(pe)
    tokens, lens = _backtrack_and_splice(base.tokens, base.lens, pes)
    hot = hotwords is not None
    return FusedBeamState(
        base=BeamState(cf[..., 0], cf[..., 1], ci[..., 0], ci[..., 1], ci[..., 2],
                       tokens, lens),
        ctx=li[..., 2:], node=li[..., 0], wid=li[..., 1], lm_sc=lm_sc,
        hw_node=ci[..., 3] if hot else None, hw_tent=cf[..., 2] if hot else None,
        hw_bias=cf[..., 3] if hot else None)


def fused_beam_nbest(state: FusedBeamState, lm, n: int = 1, *,
                     alpha: float = 0.4, beta: float = 0.9,
                     ) -> list[list[tuple[str, float]]]:
    """Host readout with the host search's final ranking: acoustic total +
    accumulated fusion score + the provisional score of the trailing
    in-progress word (decoding/beam.py StreamingBeamSearch.result())."""
    totals = state.base.totals.cpu().numpy()
    lm_sc = state.lm_sc.cpu().numpy()
    if state.hw_bias is not None:
        lm_sc = lm_sc + state.hw_bias.cpu().numpy()
    tokens = state.base.tokens.cpu().numpy()
    lens = state.base.lens.cpu().numpy()
    ctxs = state.ctx.cpu().numpy()
    out = []
    for b in range(totals.shape[0]):
        scored = []
        for wi in range(totals.shape[1]):
            if not np.isfinite(totals[b, wi]):
                continue
            text = "".join(LABELS[i] for i in tokens[b, wi, :lens[b, wi]])
            partial = text.rsplit(" ", 1)[-1]
            final = totals[b, wi] + lm_sc[b, wi]
            if partial:
                ctx_ids = [int(i) for i in ctxs[b, wi] if i >= 0]
                final += (alpha * LOG10_TO_LN
                          * lm.score_ids(ctx_ids, lm.word_id(partial))
                          + beta)
            scored.append((text.strip(), float(final)))
        # host final_key parity: score desc, then text asc on exact ties
        scored.sort(key=lambda p: (-p[1], p[0]))
        out.append(scored[:n])
    return out
