"""CTC decoders of the port (port of ``tone_tpu/decoder.py``): greedy, the
host beam search, and the device beam search.

``BeamSearchCTCDecoder`` is the reference's pyctcdecode-style decoder: a
CTC prefix beam search of width 200 with word n-gram LM shallow fusion and
hotwords, on the host (the C++ decoder of ``decoding/native``, or the Python
search of ``decoding/beam.py`` where no C++ toolchain is available).

``DeviceBeamSearchCTCDecoder`` runs the batched prefix beam search of
``ops/beam_decode.py`` on its device (the card unless the caller asks for
the CPU): with ``fusion=True`` the LM is fused into the device search
(``decoding/device_lm.py``); otherwise the LM rescores the n-best list on
the host.
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

__all__ = ["LABELS", "DecoderType", "GreedyCTCDecoder", "BeamSearchCTCDecoder",
           "DeviceBeamSearchCTCDecoder", "build_decoder", "parse_hotwords"]

# The reference's shallow-fusion weights (tone/decoder.py:108, :133).
ALPHA = 0.4
BETA = 0.9


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


def _native_lm_path(model_path: Path) -> Path:
    """LM path to hand the native C++ scorer.

    The C++ scorer reads ARPA text and KenLM probing binaries; KenLM *trie*
    binaries are converted once to an equivalent probing binary in the
    temp dir (keyed by source identity) and the conversion is reused.
    """
    from tone_tpu_torch.decoding.kenlm_binary import kenlm_model_type

    if kenlm_model_type(model_path) not in (2, 3, 4, 5):
        return model_path
    import hashlib
    import tempfile

    stat = model_path.stat()
    key = hashlib.sha256(
        f"{model_path.resolve()}:{stat.st_size}:{stat.st_mtime_ns}".encode()
    ).hexdigest()[:16]
    cached = Path(tempfile.gettempdir()) / f"tone_tpu_torch_lm_{key}.bin"
    if not cached.exists():
        import os

        from tone_tpu_torch.decoding.kenlm_binary import write_kenlm_binary
        from tone_tpu_torch.decoding.kenlm_trie import KenLMTrie, trie_to_ngrams

        # Per-process temp name + atomic rename: concurrent converters
        # each publish a complete file (last writer wins, same bytes).
        tmp = cached.with_suffix(f".{os.getpid()}.tmp")
        try:
            write_kenlm_binary(trie_to_ngrams(KenLMTrie(model_path)), tmp)
            tmp.replace(cached)
        finally:
            tmp.unlink(missing_ok=True)
    return cached


class BeamSearchCTCDecoder:
    """Beam-search CTC decoding on the host with optional n-gram LM shallow
    fusion (``tone_tpu/decoder.py:100-244``; the Hugging Face download is
    not ported: there is no network here).

    Defaults mirror the reference: alpha=0.4, beta=0.9, beam width 200
    (tone/decoder.py:108, :133).
    """

    ALPHA = ALPHA
    BETA = BETA
    BEAM_WIDTH = 200

    def __init__(self, lm: "LanguageModel | None" = None, *,
                 alpha: float = ALPHA, beta: float = BETA,
                 beam_width: int = BEAM_WIDTH, native_lm=None,
                 hotwords=None, hotword_weight: float = 10.0) -> None:
        self._lm = lm
        self._native_lm = native_lm
        self.alpha = alpha
        self.beta = beta
        self.beam_width = beam_width
        # The C++ decoder when it builds (it equals the Python search:
        # tests/test_torch_host_beam.py).  A Python LanguageModel without a
        # native twin, or a pre-built HotwordScorer whose phrases the native
        # side can't take, keeps the Python search.
        from tone_tpu_torch.decoding.native.beamsearch import native_available

        native_ok = native_available() and (lm is None or native_lm is not None)
        self._hotwords = None
        self._native_hotwords = None
        if hotwords:
            from tone_tpu_torch.decoding.hotwords import HotwordScorer

            if isinstance(hotwords, HotwordScorer):
                # A pre-built scorer keeps its phrase list and weight, so
                # the native twin is still constructible from it.
                self._hotwords = hotwords
                phrases, hotword_weight = hotwords.phrases, hotwords.weight
            else:
                if isinstance(hotwords, str):
                    raise TypeError(
                        "hotwords must be a list of phrases, not a string")
                phrases = [str(h) for h in hotwords]
                bad = {c for h in phrases for c in h.lower() if c not in LABELS}
                if bad:
                    raise ValueError(
                        f"hotword characters outside the label set: {sorted(bad)}")
                self._hotwords = HotwordScorer(phrases, hotword_weight)
            if native_ok:
                from tone_tpu_torch.decoding.native.beamsearch import NativeHotwords

                try:
                    self._native_hotwords = NativeHotwords(
                        LABELS, phrases, hotword_weight)
                except ValueError:
                    # pre-built scorer with out-of-label-set phrases (those
                    # can never match, but stay on the Python path)
                    native_ok = False
        self._use_native = native_ok

    @classmethod
    def from_local(cls, model_path: str | Path, *, hotwords=None,
                   hotword_weight: float = 10.0) -> "BeamSearchCTCDecoder":
        """Initialize from a local LM file: ARPA text (optionally .gz) or a
        KenLM binary — the reference's published ``kenlm.bin`` artifact
        (tone/decoder.py:84-95) loads directly."""
        from tone_tpu_torch.decoding.lm import load_lm
        from tone_tpu_torch.decoding.native.beamsearch import NativeLM, native_available

        model_path = Path(model_path)
        native_lm = None
        if native_available() and model_path.suffix != ".gz":
            try:
                native_lm = NativeLM(_native_lm_path(model_path))
            except (RuntimeError, ValueError, OSError):
                # A conversion or scorer failure of any kind degrades to
                # the Python LM instead of failing decoder construction.
                native_lm = None
        return cls(load_lm(model_path), native_lm=native_lm,
                   hotwords=hotwords, hotword_weight=hotword_weight)

    @classmethod
    def from_hugging_face(cls) -> "BeamSearchCTCDecoder":
        """Not ported: the LM download waits for the interop slice."""
        raise NotImplementedError(
            "BeamSearchCTCDecoder.from_hugging_face (the kenlm.bin download) is not "
            "ported to tone_tpu_torch yet (ROADMAP queue A14); use from_local")

    def forward(self, logprobs: "npt.NDArray[np.float32]") -> str:
        """Decode (L, vocab+1) logprobs to text via prefix beam search."""
        _validate_logprobs(logprobs)
        if self._use_native:
            from tone_tpu_torch.decoding.native.beamsearch import ctc_beam_search_native

            return ctc_beam_search_native(
                logprobs, LABELS, self._native_lm,
                alpha=self.alpha, beta=self.beta, beam_width=self.beam_width,
                hotwords=self._native_hotwords,
            )
        from tone_tpu_torch.decoding.beam import ctc_beam_search

        return ctc_beam_search(
            logprobs.astype(np.float64), LABELS, self._lm,
            alpha=self.alpha, beta=self.beta, beam_width=self.beam_width,
            hotwords=self._hotwords,
        )

    def nbest(self, logprobs: "npt.NDArray[np.float32]",
              n: int = 8) -> list[tuple[str, float]]:
        """Up to ``n`` alternative transcripts with scores, best first
        (pyctcdecode's ``decode_beams``).  Scores are natural-log acoustic
        + LM (+hotword) totals."""
        _validate_logprobs(logprobs)
        search = self.streaming()
        search.advance(np.asarray(logprobs,
                                  np.float32 if self._use_native else np.float64))
        return search.nbest(n)

    def streaming(self):
        """A carried-state decoder for incremental transcription: feed
        logprob frames as they arrive with ``advance(logprobs)``, read the
        current best with ``result()``, restart with ``reset()``.  Prefix
        beam search is frame-sequential, so advancing chunk by chunk gives
        exactly ``forward()`` over the concatenated frames — the serving
        engine's LM-quality interim transcripts (``interim_beam``)."""
        if self._use_native:
            from tone_tpu_torch.decoding.native.beamsearch import NativeStreamingBeam

            return NativeStreamingBeam(
                LABELS, self._native_lm, alpha=self.alpha, beta=self.beta,
                beam_width=self.beam_width, hotwords=self._native_hotwords)
        from tone_tpu_torch.decoding.beam import StreamingBeamSearch

        return StreamingBeamSearch(
            LABELS, self._lm, alpha=self.alpha, beta=self.beta,
            beam_width=self.beam_width, hotwords=self._hotwords)


class DeviceBeamSearchCTCDecoder:
    """Beam-search decoding with the search on the device
    (``tone_tpu/decoder.py:247-492``): the LM fused into the search
    (``fusion=True``), or applied as an n-best rescoring pass on the host.

    The search is batched (``ops/beam_decode.py``); without fusion the host
    LM work is a handful of lookups per *hypothesis* instead of per frame
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
        """``fusion=False`` (default): LM-free device search + host n-best
        rescoring with ``lm``.  ``fusion=True``: the LM itself is fused into
        the device search (``lm`` must be a ``decoding.device_lm.DeviceLM``
        or ``DeviceProbingLM``, or expose ``_ngrams`` tables to build one).
        ``hotwords`` biases the device search itself toward the given
        words/phrases in either mode (ops/beam_decode.py HotwordTables).
        ``device``: the card unless the caller asks for the CPU."""
        from tone_tpu_torch.device import resolve_device

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
        self.fusion = fusion and lm is not None
        if self.fusion:
            from tone_tpu_torch.decoding.device_lm import DeviceLM, DeviceProbingLM

            if not isinstance(lm, (DeviceLM, DeviceProbingLM)):
                ngrams = getattr(lm, "_ngrams", None)
                if ngrams is None:
                    raise TypeError(
                        "fusion=True needs a DeviceLM/DeviceProbingLM (or "
                        "an LM exposing its n-gram tables); got "
                        f"{type(lm).__name__} — use load_device_lm")
                lm = DeviceLM.from_ngrams(ngrams)
            lm.arrays(self.device)   # the one upload, shared by copies
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
        """Any LM artifact loads for either mode: ARPA text (optionally
        .gz) or a KenLM binary, probing or trie, including the reference's
        published ``kenlm.bin`` (tone/decoder.py:84-95)."""
        if fusion:
            from tone_tpu_torch.decoding.device_lm import load_device_lm

            return cls(load_device_lm(Path(model_path)), fusion=True, **kwargs)
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
            if self.fusion:
                state = bd.init_fused_beam_state(padded.shape[0], self.beam_width,
                                                 self._lm, self.max_len,
                                                 hotwords=hotwords, device=self.device)
                state = bd.fused_beam_advance(state, padded, self._lm.arrays(self.device),
                                              lengths, alpha=self.alpha, beta=self.beta,
                                              hotwords=hotwords)
                ranked_rows = bd.fused_beam_nbest(state, self._lm, pool,
                                                  alpha=self.alpha, beta=self.beta)
            elif hotwords is not None:
                state = bd.init_hot_beam_state(padded.shape[0], self.beam_width,
                                               self.max_len, self.device)
                state = bd.hot_beam_advance(state, padded, lengths, hotwords=hotwords)
                hyps_rows = bd.hot_beam_nbest(state, pool)
            else:
                state = bd.init_beam_state(padded.shape[0], self.beam_width,
                                           self.max_len, self.device)
                state = bd.beam_advance(state, padded, lengths)
                hyps_rows = bd.beam_nbest(state, pool)
        if not self.fusion:
            ranked_rows = [rescore_nbest(hyps, self._lm, alpha=self.alpha, beta=self.beta)
                           for hyps in hyps_rows[:n_rows]]
        return [self._dedup_ranked(ranked, n) for ranked in ranked_rows[:n_rows]]

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
    ``greedy``, ``beam`` (the host beam search) or ``device-beam``, with the
    JAX factory's ``ValueError``s for inconsistent flags.  ``lm`` is an ARPA
    or KenLM file; ``fused_lm`` fuses it into the device search (device-beam
    only); ``device`` is the device-beam decoder's (the card unless the
    caller asks for the CPU)."""
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
        decoder = (BeamSearchCTCDecoder.from_local(
                       lm, hotwords=hotwords, hotword_weight=hotword_weight)
                   if lm else
                   BeamSearchCTCDecoder(hotwords=hotwords, hotword_weight=hotword_weight))
        if beam_width:
            decoder.beam_width = beam_width
        return decoder
    if kind == "greedy":
        return GreedyCTCDecoder()
    raise ValueError(f"unknown decoder kind: {kind!r}")
