"""Batched CTC forced alignment on the device (port of
``tone_tpu/ops/align_device.py``).

The host Viterbi (``align.py``) aligns one phrase at a time.  This op
aligns a batch of (phrase, transcript) pairs at once: the forward recursion
over the blank-extended states with per-row masks and a back-pointer walk,
both as tensor ops on one device, then the word spans and confidences on
the host.

Shapes are bucketed (T and S to powers of two), as in the JAX package, so
a bulk job runs a handful of bucket shapes.  Ties break as the host
aligner's do (stay before prev before skip; the final state S-2 before
S-1), so the best paths, not only the texts, equal the host's.

One frame of the forward recursion is about a dozen small tensor ops from
a Python loop, so a long bucket is bound by the host's launch rate.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tone_tpu_torch.config import BLANK_ID, LABELS
from tone_tpu_torch.device import resolve_device

__all__ = ["align_words_batch"]

NEG = -1e30


def _viterbi_path(lp: torch.Tensor, ext: torch.Tensor, can_skip: torch.Tensor,
                  s_len: torch.Tensor, t_len: torch.Tensor, *,
                  blank_id: int = BLANK_ID) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-path states of a (B, T, S) bucket, on the device of ``lp``.

    Args:
        lp: (B, T, V) float32 natural-log probs.
        ext: (B, S) blank-extended label ids, padded (pad cells masked off
            through ``s_len``).
        can_skip: (B, S) bool skip-transition mask.
        s_len: (B,) valid extended-state counts (2·labels+1).
        t_len: (B,) valid frame counts.

    Returns:
        (path (B, T) int32, the state of each frame (padded frames repeat
        the final state), score (B,) float32).
    """
    b, t_max, _ = lp.shape
    s_max = ext.shape[1]
    dev = lp.device
    s_len, t_len = s_len.long(), t_len.long()
    s_iota = torch.arange(s_max, device=dev)
    s_valid = s_iota[None, :] < s_len[:, None]
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    # Every frame's emissions in one gather: (B, T, S).
    emit = torch.gather(lp.float(), 2, ext.long()[:, None, :].expand(b, t_max, s_max))
    emit = torch.where(s_valid[:, None, :], emit, neg)

    alpha = torch.where(s_iota[None, :] < 2, emit[:, 0], neg)
    active = torch.arange(t_max, device=dev)[:, None, None] < t_len[None, :, None]  # (T, B, 1)
    psi = torch.empty((max(t_max - 1, 0), b, s_max), dtype=torch.int8, device=dev)
    one, two = torch.ones((), dtype=torch.int8, device=dev), torch.full(
        (), 2, dtype=torch.int8, device=dev)
    for t in range(1, t_max):
        prev = F.pad(alpha[:, :-1], (1, 0), value=NEG)
        skip = torch.where(can_skip, F.pad(alpha[:, :-2], (2, 0), value=NEG), neg)
        # the host's tie rule: stay unless strictly beaten
        choice = torch.where(prev > alpha, one, 0)
        best = torch.maximum(alpha, prev)
        choice = torch.where(skip > best, two, choice)
        best = torch.maximum(best, skip)
        alpha = torch.where(active[t], best + emit[:, t], alpha)
        psi[t - 1] = torch.where(active[t], choice, 0)

    last = alpha.gather(1, (s_len - 1)[:, None])[:, 0]
    s_prev = torch.clamp(s_len - 2, min=0)
    last2 = alpha.gather(1, s_prev[:, None])[:, 0]
    # the host's argmax over [S-2, S-1] takes S-2 on ties
    s = torch.where(last2 >= last, s_prev, s_len - 1)
    score = torch.maximum(last, last2)

    # Walk back: psi rows of inactive frames are 0, so padded frames keep
    # the final state.
    path = torch.empty((b, t_max), dtype=torch.int64, device=dev)
    for t in range(t_max - 1, 0, -1):
        path[:, t] = s
        s = s - psi[t - 1].gather(1, s[:, None])[:, 0].long()
    path[:, 0] = s
    return path.to(torch.int32), score


def _bucket(n: int, lo: int = 32) -> int:
    v = lo
    while v < n:
        v <<= 1
    return v


def _extended_labels(text: str, blank_id: int = BLANK_ID) -> np.ndarray | None:
    """Blank-extended label ids of a transcript (None for an empty text)."""
    words = text.split()
    if not words:
        return None
    ids = np.array([LABELS.index(c) for c in " ".join(words)], np.int32)
    ext = np.full(2 * len(ids) + 1, blank_id, np.int32)
    ext[1::2] = ids
    return ext


def _stage_bucket(logprobs_list, exts, idxs, t_pad: int, s_pad: int):
    """Padded numpy inputs of one (T, S) bucket for :func:`_viterbi_path`."""
    nb = len(idxs)
    v = logprobs_list[idxs[0]].shape[1]
    lp = np.full((nb, t_pad, v), 0.0, np.float32)
    ext = np.zeros((nb, s_pad), np.int32)
    can_skip = np.zeros((nb, s_pad), bool)
    s_len = np.zeros(nb, np.int32)
    t_len = np.zeros(nb, np.int32)
    for row, i in enumerate(idxs):
        phr = np.asarray(logprobs_list[i], np.float32)
        lp[row, :phr.shape[0]] = phr
        e = exts[i]
        ext[row, :e.size] = e
        can_skip[row, 3:e.size:2] = e[3::2] != e[1:-2:2]
        s_len[row] = e.size
        t_len[row] = phr.shape[0]
    return lp, ext, can_skip, s_len, t_len


def _bucket_groups(logprobs_list, texts, blank_id: int = BLANK_ID):
    """(extended labels per text, {(T, S) bucket: phrase indices}); raises
    the host aligner's ValueError for a text longer than its phrase."""
    groups: dict[tuple[int, int], list[int]] = {}
    exts: list[np.ndarray | None] = [None] * len(texts)
    for i, (lp, text) in enumerate(zip(logprobs_list, texts)):
        ext = _extended_labels(text, blank_id)
        if ext is None:
            continue
        ids = ext[1::2]
        needed = len(ids) + int(np.sum(ids[1:] == ids[:-1]))
        if lp.shape[0] < needed:
            raise ValueError(f"{len(ids)} labels cannot align to {lp.shape[0]} frames")
        exts[i] = ext
        groups.setdefault((_bucket(lp.shape[0]), _bucket(ext.size)), []).append(i)
    return exts, groups


def align_words_batch(logprobs_list, texts, blank_id: int = BLANK_ID,
                      device: str | torch.device | None = None,
                      ) -> list[list[tuple[str, int, int, float]]]:
    """Device-batched ``align.align_words`` over many phrases.

    Returns, per phrase, the same (word, first_frame, last_frame,
    confidence) tuples as the host aligner.  Phrases are grouped into
    (T, S) power-of-two buckets, each one call of the recursion on
    ``device`` (``cuda`` unless the caller asks for the CPU).  Empty texts
    give empty lists.
    """
    dev = resolve_device(device)
    results: list[list[tuple[str, int, int, float]]] = [[] for _ in texts]
    exts, groups = _bucket_groups(logprobs_list, texts, blank_id)
    for (t_pad, s_pad), idxs in groups.items():
        staged = _stage_bucket(logprobs_list, exts, idxs, t_pad, s_pad)
        path, _ = _viterbi_path(*(torch.from_numpy(a).to(dev) for a in staged),
                                blank_id=blank_id)
        path = path.cpu().numpy()
        t_len = staged[4]
        for row, i in enumerate(idxs):
            p = path[row, :int(t_len[row])]
            e = exts[i]
            # first/last frame per odd (char) state: the path visits states
            # in nondecreasing order, so per-state spans are contiguous
            first = np.full(e.size, -1, np.int64)
            last = np.full(e.size, -1, np.int64)
            odd_t = np.flatnonzero((p % 2) == 1)
            odd_s = p[odd_t]
            first[odd_s[::-1]] = odd_t[::-1]  # earliest write wins
            last[odd_s] = odd_t
            lp_i = np.asarray(logprobs_list[i], np.float32)
            out = []
            ci = 0  # char index within " ".join(words)
            for word in texts[i].split():
                spans = [(int(first[2 * (ci + k) + 1]), int(last[2 * (ci + k) + 1]),
                          int(e[2 * (ci + k) + 1])) for k in range(len(word))]
                ci += len(word) + 1
                if any(f0 < 0 for f0, _, _ in spans):
                    raise ValueError("no feasible CTC alignment")
                logp = float(np.mean([lp_i[f, c] for f0, f1, c in spans
                                      for f in range(f0, f1 + 1)]))
                out.append((word, spans[0][0], spans[-1][1], float(np.exp(logp))))
            results[i] = out
    return results
