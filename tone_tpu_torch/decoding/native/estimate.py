"""ctypes front-end for the native LM estimator (port of
``tone_tpu/decoding/native/estimate.py``).

Corpus file → ARPA file, fully native (tokenize, count, modified-KN
estimate, prune, write) — the scale path for the pure-Python estimator in
``decoding/estimate.py``.  The shared library is built at first use from the
port's own copy of the source, ``src/tone_estimate.cpp``, with the system
``g++`` into the build directory (``ops/_build.py build_dir``: the package's
git-ignored ``_kernels/`` in a checkout, the user's cache for a read-only
install, unless redirected), under a name keyed by the hash of the source
and the flags.  Callers fall back to the Python estimator when no toolchain
or no writable directory builds it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence

from tone_tpu_torch.ops import _build

_SRC = Path(__file__).resolve().parent / "src" / "tone_estimate.cpp"


def _declare(lib: ctypes.CDLL) -> None:
    lib.tone_estimate_arpa.restype = ctypes.c_longlong
    lib.tone_estimate_arpa.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]


_LIBRARY = _build.GxxLibrary(_SRC, _declare)


def library_path() -> Path:
    """Where the library builds to: keyed by the source and the flags."""
    return _LIBRARY.path()


def build_native(force: bool = False) -> bool:
    """Compile the shared library if needed.  Returns availability."""
    return _LIBRARY.build(force)


def native_available() -> bool:
    return _LIBRARY.load() is not None


def estimate_arpa_native(corpus_path: str | Path, out_path: str | Path,
                         order: int = 3,
                         prune: Sequence[int] | None = None) -> int:
    """Estimate from a text corpus file (one sentence per line) and write a
    standard ARPA file.  Returns the total n-gram count written.

    Raises RuntimeError if the native library is unavailable; ValueError
    for corpus/argument errors (mirroring estimate_ngram_lm's messages).
    """
    lib = _LIBRARY.load()
    if lib is None:
        raise RuntimeError("native estimator unavailable (no C++ toolchain)")
    prune = list(prune or [])
    arr = (ctypes.c_longlong * max(len(prune), 1))(*(prune or [0]))
    err = ctypes.create_string_buffer(256)
    n = lib.tone_estimate_arpa(
        str(corpus_path).encode(), order, arr, len(prune),
        str(out_path).encode(), err, len(err))
    if n < 0:
        raise ValueError(err.value.decode(errors="replace"))
    return int(n)
