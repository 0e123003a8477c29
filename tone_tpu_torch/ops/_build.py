"""Builds the port's CUDA kernels (and its C++ host libraries) at first use
and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``lib<name>-<hash>.so`` in the build directory; the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header is rebuilt, a stale library is never loaded, and a
library built elsewhere from the same sources is found by its name.  The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside the library as ``.log``.

``GxxLibrary`` builds the port's C++ host sources (the native beam decoder
and LM estimator under ``decoding/native/src/``) with ``g++`` into the same
directory, keyed the same way.

The build directory (``build_dir()``) is ``BUILD_DIR`` where that was set
(``export.enable_compilation_cache``, so that a container builds each
library once); else it is chosen at the first build: the package's
``_kernels/`` where it can be written (a checkout), else the user's cache,
``$XDG_CACHE_HOME/tone_tpu_torch/kernels`` (``~/.cache`` without it; an
installed, read-only copy).  Where neither can be written ``build`` raises,
naming both, and ``GxxLibrary.build`` returns False.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR: Path | None = None  # chosen by build_dir() at the first build unless set

NVCC_FLAGS = (
    "-O3", "-std=c++17",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on the "
                       "machine with the GPU (set CUDA_HOME or put nvcc on PATH)")


def probe_writable(directory: Path) -> None:
    """Create ``directory`` and write a file in it; raises OSError where it
    cannot (as root, only a read-only mount or a file in the way stops it)."""
    directory.mkdir(parents=True, exist_ok=True)
    probe = directory / f".write-probe-{os.getpid()}-{threading.get_ident()}"
    probe.touch()
    probe.unlink()


def build_dir() -> Path:
    """The directory the libraries build into: ``BUILD_DIR``, chosen once
    (see the module docstring) where it was not set.  Raises PermissionError
    naming the directories tried where none can be written."""
    global BUILD_DIR
    if BUILD_DIR is None:
        cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
        tried = [PACKAGE_DIR / "_kernels", Path(cache) / "tone_tpu_torch" / "kernels"]
        errors = []
        for directory in tried:
            try:
                probe_writable(directory)
            except OSError as e:
                errors.append(f"{directory} ({e.strerror or e})")
                continue
            BUILD_DIR = directory
            break
        else:
            raise PermissionError(
                "no directory to build the port's libraries in: "
                + "; ".join(errors) + " (set TONE_TPU_COMPILE_CACHE to a writable one)")
    return BUILD_DIR


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, every
    ``csrc/*.cuh`` header (any of them may be included) and the flags."""
    digest = hashlib.sha256((SOURCE_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for its hash exists."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # concurrent builds each publish a whole file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def gxx_library_path(source: Path) -> Path:
    """Where the C++ ``source`` builds to: keyed by the source and the flags."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS).encode())
    return build_dir() / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


class GxxLibrary:
    """A C++ source built with ``g++`` at first use and loaded with ctypes
    once; ``load()`` gives None where no toolchain builds it (the callers
    then take their Python path).  ``declare(lib)`` sets the functions'
    argtypes and restypes."""

    def __init__(self, source: Path, declare) -> None:
        self.source = source
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._failed = False

    def path(self) -> Path:
        return gxx_library_path(self.source)

    def build(self, force: bool = False) -> bool:
        """Compile the library if needed.  Returns availability: False where
        no ``g++`` builds it or no build directory can be written, as the
        JAX package's ``build_native`` does."""
        with self._lock:
            try:
                out = self.path()
            except OSError:
                self._failed = True
                return False
            if out.exists() and not force:
                return True
            if self._failed and not force:
                return False
            tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            try:
                out.parent.mkdir(parents=True, exist_ok=True)
                subprocess.run(["g++", *GXX_FLAGS, str(self.source), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=300)
                os.replace(tmp, out)  # concurrent builds each publish a whole file
                return True
            except (OSError, subprocess.SubprocessError):
                self._failed = True
                return False
            finally:
                tmp.unlink(missing_ok=True)

    def load(self) -> ctypes.CDLL | None:
        if self._lib is None and self.build():
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(str(self.path()))
                    self._declare(lib)
                    self._lib = lib
        return self._lib
