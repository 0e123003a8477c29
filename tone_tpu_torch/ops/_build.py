"""Builds the port's CUDA kernels (and its C++ host libraries) at first use
and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``_kernels/lib<name>-<hash>.so`` inside the package; the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.  The compiler's ``-Xptxas -v`` report (registers, shared
memory, spills) is kept beside the library as ``.log``.

``GxxLibrary`` builds the port's C++ host sources (the native beam decoder
and LM estimator under ``decoding/native/src/``) with ``g++`` into the same
directory, keyed the same way.  ``BUILD_DIR`` may be pointed elsewhere
before the first build (``export.enable_compilation_cache``), so that a
container builds each library once.
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
BUILD_DIR = PACKAGE_DIR / "_kernels"

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


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, every
    ``csrc/*.cuh`` header (any of them may be included) and the flags."""
    digest = hashlib.sha256((SOURCE_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for its hash exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


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
        """Compile the library if needed.  Returns availability."""
        with self._lock:
            out = self.path()
            if out.exists() and not force:
                return True
            if self._failed and not force:
                return False
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            try:
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
