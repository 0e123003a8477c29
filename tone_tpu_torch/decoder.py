"""CTC decoders of the port (port of ``tone_tpu/decoder.py``): greedy, and
the device beam search with host n-best LM rescoring and hotword biasing.

``DeviceBeamSearchCTCDecoder`` runs the batched prefix beam search of
``ops/beam_decode.py`` on its device (the card unless the caller asks for
the CPU) and applies the word LM as an n-best rescoring pass on the host.
Still to come (asking for them raises ``NotImplementedError``): the fused-LM
device search (``fusion=True``, ROADMAP A10) and the host beam decoder
(``"beam"``, ROADMAP A11).
"""

from __future__ import annotations

import contextlib
from enum import Enum
from itertools import groupby
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from tone_tpu_torch.config import LABELS

if TYPE_CHECKING:
    from typing import Sequence

    import numpy.typing as npt

    from tone_tpu_torch.decoding.lm import LanguageModel

__all__ = ["LABELS", "DecoderType", "GreedyCTCDecoder", "DeviceBeamSearchCTCDecoder",
           "build_decoder", "parse_hotwords"]

# The reference's shallow-fusion weights (tone/decoder.py:108, :133).
ALPHA = 0.4
BETA = 0.9

_FUSED_LM = ("the fused-LM device search (fusion=True / --fused-lm) is not ported "
             "to tone_tpu_torch yet (ROADMAP queue A10)")
_HOST_BEAM = ("the host beam-search decoder (--decoder beam) is not ported to "
              "tone_tpu_torch yet (ROADMAP queue A11)")


class DecoderType(Enum):
    """Supported decoding strategies for CTC output."""

    GREEDY = "greedy"
    BEAM_SEARCH = "beam_search"


def _validate_logprobs(logprobs) -> None:
    if not isinstance(logprobs, np.ndarray):
        raise TypeError(
            f"Incorrect 'logprobs' type: expected np.ndarray, but got {type(logprobs)}")
    if logprobs.shape[1:] != (len(LABELS) + 1,):
        raise ValueError(
            f"Shape of 'logprobs' must be (L, {len(LABELS) + 1}), but got {logprobs.shape}")
    if logprobs.dtype != np.float32:
        raise ValueError(
            f"Incorrect dtype of 'logprobs': expected np.float32, but got {logprobs.dtype}")


class GreedyCTCDecoder:
    """Greedy CTC decoding: argmax, collapse repeats, drop blanks."""

    def forward(self, logprobs: "npt.NDArray[np.float32]") -> str:
        """Decode (L, vocab+1) logprobs to text."""
        _validate_logprobs(logprobs)
        tokens = logprobs.argmax(axis=-1)
        collapsed = (token for token, _ in groupby(tokens.tolist()))
        return "".join(LABELS[t] for t in collapsed if t < len(LABELS)).strip()


class DeviceBeamSearchCTCDecoder:
    """Beam-search decoding with the search on the device and the LM applied
    as an n-best rescoring pass on the host
    (``tone_tpu/decoder.py:247-492`` without fusion).

    The search is batched (``ops/beam_decode.py``) and host LM work is a
    handful of lookups per *hypothesis* instead of per frame
    (``decoding/rescore.py``).  ``forward`` decodes one phrase;
    ``forward_batch`` is the high-throughput path.

    On CUDA the search runs on a stream of its own, so a thread that reads
    another stream's results (the serving tick) does not wait for it.
    """

    def __init__(self, lm: "LanguageModel | None" = None, *,
                 alpha: float = ALPHA, beta: float = BETA,
                 beam_width: int = 32, nbest: int = 8,
                 max_len: int = 2048, fusion: bool = False,
                 hotwords=None, hotword_weight: float = 10.0,
                 device=None) -> None:
        """LM-free device search + host n-best rescoring with ``lm``.
        ``hotwords`` biases the device search itself toward the given
        words/phrases (ops/beam_decode.py HotwordTables).  ``device``: the
        card unless the caller asks for the CPU.  ``fusion=True`` raises
        NotImplementedError (ROADMAP A10)."""
        from tone_tpu_torch.device import resolve_device

        if fusion:
            raise NotImplementedError(_FUSED_LM)
        self.device = resolve_device(device)
        self.alpha = alpha
        self.beta = beta
        self.beam_width = beam_width
        self.nbest_hyps = nbest
        self.max_len = max_len
        self._hotwords = None
        if hotwords:
            from tone_tpu_torch.ops.beam_decode import make_hotword_tables

            self._hotwords = make_hotword_tables(hotwords, hotword_weight)
        # Serving knobs (MultiStreamEngine sets both to its final-decode
        # batch): pad the device batch up to ``batch_floor`` rows and split
        # larger lists into ``max_batch``-row calls, so every call has one
        # of the shapes {(batch_floor, 64·2^k)}.
        self.batch_floor = 1
        self.max_batch: int | None = None
        self._lm = lm
        self._cuda_stream = None

    @property
    def hotword_tables(self):
        """Hotword automaton tables (ops.beam_decode.HotwordTables) or None
        — what the serving engine's interim arena biases with."""
        return self._hotwords

    @classmethod
    def from_local(cls, model_path: str | Path, *, fusion: bool = False,
                   **kwargs) -> "DeviceBeamSearchCTCDecoder":
        """Any LM ``load_lm`` reads: ARPA text (optionally .gz) or a KenLM
        binary, probing or trie, including the reference's published
        ``kenlm.bin`` (tone/decoder.py:84-95)."""
        if fusion:
            raise NotImplementedError(_FUSED_LM)
        from tone_tpu_torch.decoding.lm import load_lm

        return cls(load_lm(Path(model_path)), **kwargs)

    def forward(self, logprobs: "npt.NDArray[np.float32]") -> str:
        _validate_logprobs(logprobs)
        return self.forward_batch([logprobs])[0]

    def nbest(self, logprobs: "npt.NDArray[np.float32]",
              n: int | None = None) -> list[tuple[str, float]]:
        """Up to ``n`` (default: the decoder's nbest) alternative
        transcripts with scores, LM-rescored when an LM is configured;
        stripped-text duplicates collapse to the best-scoring."""
        _validate_logprobs(logprobs)
        n = n or self.nbest_hyps
        return self.forward_batch_nbest([np.ascontiguousarray(logprobs)], n)[0]

    @staticmethod
    def _t_bucket(frames: int) -> int:
        """Frame-count bucket: 64·2^k (64, 128, 256, …)."""
        t = 64
        while t < frames:
            t <<= 1
        return t

    def _pad_batch(self, logprobs_list, t_pad=None):
        lengths = [lp.shape[0] for lp in logprobs_list]
        if t_pad is None:
            t_pad = self._t_bucket(max(lengths))
        b_pad = max(1 << (len(logprobs_list) - 1).bit_length(),
                    self.batch_floor)
        v = logprobs_list[0].shape[1]
        padded = np.zeros((b_pad, t_pad, v), np.float32)
        for row, lp in enumerate(logprobs_list):
            padded[row, :lp.shape[0]] = lp
        return padded, np.array(lengths + [0] * (b_pad - len(logprobs_list)))

    def forward_batch(self, logprobs_list, hotword_rows=None) -> list[str]:
        """Decode a list of (L_i, vocab+1) phrases on the device.

        Phrases are grouped by frame-count bucket (64·2^k) and each group
        decodes in one call; groups larger than ``max_batch`` split into
        sequential calls, and batch counts pad to powers of two (at least
        ``batch_floor``).

        ``hotword_rows`` (optional, aligned with ``logprobs_list``): a
        per-phrase ``HotwordTables`` or None — rows with tables run their
        own biasing inside the same batched call (stacked tables); None
        rows fall back to the decoder's own hotwords, or none.
        """
        return [r[0][0] if r else ""
                for r in self.forward_batch_nbest(logprobs_list, 1, hotword_rows)]

    def forward_batch_nbest(self, logprobs_list, n: int,
                            hotword_rows=None) -> list[list[tuple[str, float]]]:
        """Batched n-best: per phrase, up to ``n`` ranked (text, score)
        alternatives, best first, stripped-text duplicates collapsed; the
        same bucketing and device calls as :meth:`forward_batch`."""
        if not logprobs_list:
            return []
        groups: dict[int, list[int]] = {}
        for i, lp in enumerate(logprobs_list):
            groups.setdefault(self._t_bucket(lp.shape[0]), []).append(i)
        out: list[list[tuple[str, float]] | None] = [None] * len(logprobs_list)
        for t_pad in sorted(groups):
            idxs = groups[t_pad]
            cap = self.max_batch or len(idxs)
            for k in range(0, len(idxs), cap):
                chunk = idxs[k:k + cap]
                rows = ([hotword_rows[i] for i in chunk]
                        if hotword_rows is not None else None)
                if rows is not None and not any(r is not None for r in rows):
                    rows = None
                ranked = self._decode_bucket(
                    [logprobs_list[i] for i in chunk], t_pad, n, rows)
                for i, hyps in zip(chunk, ranked):
                    out[i] = hyps
        return out

    def _stream(self):
        """The decoder's own CUDA stream as a context (nothing on the CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        import torch

        if self._cuda_stream is None or self._cuda_stream.device != self.device:
            self._cuda_stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._cuda_stream)

    def _decode_bucket(self, logprobs_list, t_pad, n: int = 1,
                       hotword_rows=None) -> list[list[tuple[str, float]]]:
        """One padded device call; per row up to ``n`` deduplicated ranked
        hypotheses.  The rescoring pool is the full ``max(n, nbest_hyps)``
        readout and truncation happens after ranking, so the top-1 of any
        ``n`` agrees with ``forward``."""
        from tone_tpu_torch.decoding.rescore import rescore_nbest
        from tone_tpu_torch.ops import beam_decode as bd

        n_rows = len(logprobs_list)
        pool = max(n, self.nbest_hyps)
        padded, lengths = self._pad_batch(logprobs_list, t_pad)
        hotwords = self._hotwords
        if hotword_rows is not None:
            # rows without their own tables inherit the decoder-wide
            # hotwords (or the dead automaton = unbiased)
            hotwords = bd.stack_hotword_tables(
                [r if r is not None else self._hotwords for r in hotword_rows],
                n_rows=padded.shape[0])
        with self._stream():
            if hotwords is not None:
                state = bd.init_hot_beam_state(padded.shape[0], self.beam_width,
                                               self.max_len, self.device)
                state = bd.hot_beam_advance(state, padded, lengths, hotwords=hotwords)
                hyps_rows = bd.hot_beam_nbest(state, pool)
            else:
                state = bd.init_beam_state(padded.shape[0], self.beam_width,
                                           self.max_len, self.device)
                state = bd.beam_advance(state, padded, lengths)
                hyps_rows = bd.beam_nbest(state, pool)
        return [self._dedup_ranked(rescore_nbest(hyps, self._lm, alpha=self.alpha,
                                                 beta=self.beta), n)
                for hyps in hyps_rows[:n_rows]]

    @staticmethod
    def _dedup_ranked(ranked, n: int) -> list[tuple[str, float]]:
        out: list[tuple[str, float]] = []
        seen: set[str] = set()
        for text, score in ranked:
            if text in seen:
                continue
            seen.add(text)
            out.append((text, score))
            if len(out) >= n:
                break
        return out


def parse_hotwords(spec: "str | None") -> "list[str] | None":
    """CLI hotword spec: comma-separated list, or ``@file`` (one per line)."""
    if not spec:
        return None
    if spec.startswith("@"):
        with open(spec[1:], encoding="utf-8") as f:
            return [line.strip() for line in f if line.strip()]
    return [h.strip() for h in spec.split(",") if h.strip()]


def build_decoder(kind: "str | DecoderType" = DecoderType.GREEDY, *,
                  lm: "str | Path | None" = None, fused_lm: bool = False,
                  beam_width: int | None = None,
                  hotwords: "Sequence[str] | None" = None,
                  hotword_weight: float = 10.0, device=None):
    """CLI-facing decoder factory (``tone_tpu/decoder.py:505-548``):
    ``greedy`` or ``device-beam``, with the JAX factory's ``ValueError``s
    for inconsistent flags.  ``lm`` is an ARPA or KenLM file; ``device``
    is the device-beam decoder's (the card unless the caller asks for the
    CPU).  ``beam`` and ``fused_lm`` raise NotImplementedError (ROADMAP A11,
    A10)."""
    if isinstance(kind, DecoderType):
        kind = "greedy" if kind is DecoderType.GREEDY else "beam"
    if hotwords and kind == "greedy":
        raise ValueError("--hotwords requires --decoder beam or device-beam")
    if kind == "device-beam":
        if fused_lm and not lm:
            raise ValueError("--fused-lm requires --lm (an ARPA or KenLM "
                             "LM artifact to fuse)")
        kwargs = {"beam_width": beam_width} if beam_width else {}
        if hotwords:
            kwargs.update(hotwords=hotwords, hotword_weight=hotword_weight)
        if lm:
            return DeviceBeamSearchCTCDecoder.from_local(
                lm, fusion=fused_lm, device=device, **kwargs)
        return DeviceBeamSearchCTCDecoder(device=device, **kwargs)
    if fused_lm:
        raise ValueError("--fused-lm only applies to --decoder device-beam")
    if kind in ("beam", "beam_search"):
        raise NotImplementedError(_HOST_BEAM)
    if kind == "greedy":
        return GreedyCTCDecoder()
    raise ValueError(f"unknown decoder kind: {kind!r}")
