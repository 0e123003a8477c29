"""One cell of the benchmark, found by its name: the manifest's entry, the
cell's own file (``workloads/<cell>.json``) and its configuration's file
(``configs/<config>.json``); the process's start, and the directories its
caches go to.

Numpy-free and torch-free, so that every process of a run may import it.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent   # benchmark/
ROOT = BENCH_DIR.parent                              # the checkout
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tone_tpu")


@dataclass
class Cell:
    name: str
    kind: str                  # the traffic kind: traffic/<kind>.py
    chips: int
    model: dict                # the configuration as it is run (ToneConfig's fields)
    params: dict               # the traffic's parameters
    limits: dict               # number compared -> its limit
    end_to_end: list = field(default_factory=list)   # manifest entries this cell reports
    per_layer: list = field(default_factory=list)


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str, reported: set[str] | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load(name: str, root: Path = ROOT, overrides: dict | None = None) -> Cell:
    """The cell ``name`` (``workloads/<name>.json`` and its configuration's
    file), with the manifest's metrics that it reports; a cell that the
    manifest does not list yet reports ``setup_s`` alone.  ``overrides``
    (tests and sweeps only) replaces entries of ``model`` and ``params``."""
    man = manifest(root)
    spec = json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())
    model = json.loads((BENCH_DIR / "configs" / f"{spec['config']}.json").read_text())["model"]
    params = dict(spec["params"])
    overrides = overrides or {}
    model = _merge(model, overrides.get("model", {}))
    params.update(overrides.get("params", {}))
    e2e = [m for m in man["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, kind=spec["kind"], chips=spec["chips"], model=model, params=params,
                limits=dict(spec["limits"]), end_to_end=e2e, per_layer=per_layer)


def _merge(base: dict, new: dict) -> dict:
    out = dict(base)
    for k, v in new.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def process_start() -> float:
    """The time.monotonic() at which this process started (its age from
    /proc, 10 ms resolution; the interpreter's import time elsewhere)."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return now


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every kernel cache of a run in fixed directories of the checkout, so
    that the first run of a cell builds and the others find it: Triton's
    and PyTorch's extension caches here; the port's B1 library builds into
    its package's ``_kernels/`` (``ops/_build.py``)."""
    cache = root / "benchmark_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def forbidden_loaded(modules) -> list[str]:
    """The loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES})
