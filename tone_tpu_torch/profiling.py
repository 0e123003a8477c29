"""Profiling and tracing helpers (port of ``tone_tpu/profiling.py``).

* :func:`trace` — capture a ``torch.profiler`` trace (host and, on a card,
  device activity) around any code block, written as a Chrome trace
  viewable in Perfetto or ``chrome://tracing``;
* :func:`step_stats` — steady-state latency and throughput of the streaming
  step at a given stream count, by the two-point slope (the time of a chain
  of n2 steps less that of n1, over n2 - n1), which cancels the fixed cost
  of starting and synchronizing a chain;
* :func:`device_label` — the card a measurement ran on, as ``nvidia-smi``
  names it with its power limit, for every result line of the measurement
  tools (``bench.py``, ``dev/*_bench.py``, ``dev/load_test.py``).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the with-block and write ``<log_dir>/trace.json`` (a Chrome
    trace) when it ends; yields ``log_dir``.  The device is traced where
    CUDA is available.  Default ``log_dir``: ``tone_tpu_torch_trace`` in
    the temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "tone_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class StepStats:
    batch: int
    seconds_per_step: float
    rtfx: float
    chunk_latency_ms: float


def step_stats(model, batch: int, steps: tuple[int, int] = (20, 120)) -> StepStats:
    """Steady-state stats of ``model.forward_native`` at a stream count: each
    chain of steps ends by reading a sum of its last logprobs on the host,
    which waits for the device."""
    cfg = model.config
    chunk = torch.as_tensor(np.random.default_rng(0).integers(
        -20000, 20000, (batch, cfg.audio_chunk_samples)), dtype=torch.int32).to(model.device)

    def chain(n):
        state = model.init_state(batch)
        t0 = time.perf_counter()
        for _ in range(n):
            logprobs, state = model.forward_native(chunk, state)
        float(logprobs.sum())  # forced sync
        return time.perf_counter() - t0

    chain(5)
    n1, n2 = steps
    t1 = min(chain(n1) for _ in range(2))
    t2 = min(chain(n2) for _ in range(2))
    sec = max((t2 - t1) / (n2 - n1), 1e-9)
    chunk_s = cfg.audio_chunk_samples / cfg.frontend.sample_rate
    return StepStats(batch=batch, seconds_per_step=sec,
                     rtfx=batch * chunk_s / sec, chunk_latency_ms=sec * 1000)


def device_label(device: torch.device | str) -> dict:
    """``{"device": name, "power_limit": "700.00 W"}`` of a CUDA device, from
    ``nvidia-smi --query-gpu=name,power.limit`` (a card below its maximum
    power runs slower under load), or ``{"device": "cpu", "power_limit":
    None}``."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": device.type, "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    except FileNotFoundError:
        return {"device": torch.cuda.get_device_name(index), "power_limit": None}
    name, limit = (x.strip() for x in out.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {"device": name, "power_limit": limit}
