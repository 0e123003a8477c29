"""ctypes front-end for the native C++ CTC beam-search decoder (port of
``tone_tpu/decoding/native/beamsearch.py``).

The shared library is built at first use from the port's own copy of the
source, ``src/tone_decode.cpp``, with the system ``g++`` into the port's
build directory (``ops/_build.py build_dir``: the package's git-ignored
``_kernels/`` in a checkout, the user's cache for a read-only install,
unless redirected), under a name keyed by the hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
``build_native()`` returns False where no toolchain or no writable
directory builds it, and the entry points raise RuntimeError;
``BeamSearchCTCDecoder`` then decodes with the Python search
(``decoding/beam.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from tone_tpu_torch.ops import _build

_SRC = Path(__file__).resolve().parent / "src" / "tone_decode.cpp"


def _declare(lib: ctypes.CDLL) -> None:
    lib.tone_lm_load_arpa.restype = ctypes.c_void_p
    lib.tone_lm_load_arpa.argtypes = [ctypes.c_char_p]
    lib.tone_lm_load.restype = ctypes.c_void_p
    lib.tone_lm_load.argtypes = [ctypes.c_char_p]
    lib.tone_lm_free.argtypes = [ctypes.c_void_p]
    lib.tone_lm_order.restype = ctypes.c_int
    lib.tone_lm_order.argtypes = [ctypes.c_void_p]
    lib.tone_lm_word_id.restype = ctypes.c_int
    lib.tone_lm_word_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tone_lm_score.restype = ctypes.c_float
    lib.tone_lm_score.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int32]
    lib.tone_ctc_beam_search.restype = ctypes.c_int
    lib.tone_ctc_beam_search.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.tone_hotwords_create.restype = ctypes.c_void_p
    lib.tone_hotwords_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_double]
    lib.tone_hotwords_free.argtypes = [ctypes.c_void_p]
    lib.tone_beam_create.restype = ctypes.c_void_p
    lib.tone_beam_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.c_void_p,
    ]
    lib.tone_beam_advance.restype = ctypes.c_int
    lib.tone_beam_advance.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.tone_beam_result.restype = ctypes.c_int
    lib.tone_beam_result.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.tone_beam_nbest.restype = ctypes.c_int
    lib.tone_beam_nbest.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.tone_beam_reset.argtypes = [ctypes.c_void_p]
    lib.tone_beam_free.argtypes = [ctypes.c_void_p]


_LIBRARY = _build.GxxLibrary(_SRC, _declare)


def library_path() -> Path:
    """Where the library builds to: keyed by the source and the flags, in
    the build directory (``ops/_build.py build_dir``)."""
    return _LIBRARY.path()


def build_native(force: bool = False) -> bool:
    """Compile the shared library if needed.  Returns availability."""
    return _LIBRARY.build(force)


def _load() -> ctypes.CDLL | None:
    return _LIBRARY.load()


def native_available() -> bool:
    return _load() is not None


class NativeLM:
    """Handle to a C++-side n-gram model (ARPA text or KenLM binary,
    dispatched on file magic)."""

    def __init__(self, path: str | Path):
        lib = _load()
        if lib is None:
            raise RuntimeError("native decoder unavailable (no C++ toolchain)")
        self._lib = lib
        self._handle = lib.tone_lm_load(str(path).encode())
        if not self._handle:
            raise ValueError(f"failed to load LM from {path}")

    @property
    def order(self) -> int:
        return self._lib.tone_lm_order(self._handle)

    def word_id(self, word: str) -> int:
        return self._lib.tone_lm_word_id(self._handle, word.encode("utf-8"))

    def score_ids(self, context_ids, word_id: int) -> float:
        """log10 P(word | context) over native word ids (testing hook)."""
        arr = (ctypes.c_int32 * len(context_ids))(*context_ids)
        return self._lib.tone_lm_score(self._handle, arr, len(context_ids),
                                       word_id)

    def score(self, context, word: str) -> float:
        return self.score_ids([self.word_id(w) for w in context],
                              self.word_id(word))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tone_lm_free(handle)
            self._handle = None


class NativeHotwords:
    """Handle to a C++-side hotword automaton (twin of
    tone_tpu_torch.decoding.hotwords.HotwordScorer) built over a label set."""

    def __init__(self, labels: str, phrases, weight: float = 10.0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native decoder unavailable (no C++ toolchain)")
        self._lib = lib
        normalized = sorted({" ".join(str(p).lower().split())
                             for p in phrases} - {""})
        if not normalized:
            raise ValueError("no hotwords given")
        self._handle = lib.tone_hotwords_create(
            "\n".join(labels).encode("utf-8"), len(labels),
            "\n".join(normalized).encode("utf-8"), weight)
        if not self._handle:
            raise ValueError(
                "hotword phrase uses characters outside the label set")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tone_hotwords_free(handle)
            self._handle = None


class NativeStreamingBeam:
    """Carried-state CTC prefix beam search (native twin of
    tone_tpu_torch.decoding.beam.StreamingBeamSearch): feed logprob frames
    as they arrive, read the current best at any point.  Holds a reference
    to the ``NativeLM`` (the C++ handle must outlive this object)."""

    def __init__(self, labels: str, lm: "NativeLM | None" = None, *,
                 alpha: float = 0.4, beta: float = 0.9,
                 beam_width: int = 200, token_min_logp: float = -5.0,
                 hotwords: "NativeHotwords | None" = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native decoder unavailable (no C++ toolchain)")
        self._lib = lib
        self._lm = lm  # keep the LM handle alive
        self._hotwords = hotwords  # keep the automaton handle alive
        self._labels = labels
        handle = lib.tone_beam_create(
            "\n".join(labels).encode("utf-8"), len(labels),
            lm._handle if lm is not None else None,
            alpha, beta, beam_width, token_min_logp,
            hotwords._handle if hotwords is not None else None)
        if not handle:
            raise RuntimeError("failed to create native streaming decoder")
        self._handle = handle
        self._buf = ctypes.create_string_buffer(1 << 16)

    def advance(self, logprobs: np.ndarray) -> None:
        """Consume (T, V) natural-log probability frames."""
        lp = np.ascontiguousarray(logprobs, dtype=np.float32)
        t_max, n_classes = lp.shape
        rc = self._lib.tone_beam_advance(
            self._handle, lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            t_max, n_classes)
        if rc != 0:
            raise RuntimeError("native streaming beam advance failed")

    def result(self) -> str:
        """Best hypothesis so far (non-destructive)."""
        n = self._lib.tone_beam_result(self._handle, self._buf, len(self._buf))
        if n < 0:
            raise RuntimeError("native streaming beam result failed")
        return self._buf.value.decode("utf-8")

    def nbest(self, n: int) -> list[tuple[str, float]]:
        """Up to ``n`` (text, score) hypotheses, best first (same ranking as
        the Python twin's nbest)."""
        # n long hypotheses can exceed the 64 KiB result buffer: grow and retry.
        buf = self._buf
        while True:
            rc = self._lib.tone_beam_nbest(self._handle, n, buf, len(buf))
            if rc >= 0:
                break
            if len(buf) >= 1 << 24:
                raise RuntimeError("native streaming beam nbest failed")
            buf = ctypes.create_string_buffer(len(buf) * 4)
        out = []
        for line in buf.value.decode("utf-8").splitlines():
            score, _, text = line.partition("\t")
            out.append((text, float(score)))
        return out

    def reset(self) -> None:
        self._lib.tone_beam_reset(self._handle)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tone_beam_free(handle)
            self._handle = None


def ctc_beam_search_native(
    logprobs: np.ndarray,
    labels: str,
    lm: NativeLM | None = None,
    *,
    alpha: float = 0.4,
    beta: float = 0.9,
    beam_width: int = 200,
    token_min_logp: float = -5.0,
    hotwords: "NativeHotwords | None" = None,
) -> str:
    """Native decode of (T, V) logprobs; same semantics as
    tone_tpu_torch.decoding.beam.ctc_beam_search."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable (no C++ toolchain)")
    lp = np.ascontiguousarray(logprobs, dtype=np.float32)
    t_max, n_classes = lp.shape
    labels_joined = "\n".join(labels).encode("utf-8")
    out = ctypes.create_string_buffer(4 * n_classes * max(t_max, 1) + 16)
    n = lib.tone_ctc_beam_search(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t_max, n_classes,
        labels_joined, len(labels),
        lm._handle if lm is not None else None,
        alpha, beta, beam_width, token_min_logp,
        hotwords._handle if hotwords is not None else None, out, len(out))
    if n < 0:
        raise RuntimeError("native beam search failed")
    return out.value.decode("utf-8")
