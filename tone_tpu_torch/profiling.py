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
  tools (``bench.py``, ``dev/*_bench.py``, ``dev/load_test.py``);
* :func:`span` and :func:`count` — the program's own spans and counters at
  its layer boundaries (bulk transcription, training steps, the serving
  tick), read back with :func:`events`.

The spans and counters are recorded only while a ``torch.profiler``
session runs (or inside :func:`record`), on ``time.monotonic_ns()``'s
clock, the clock a device trace's operations are mapped onto; each span is
then also a ``torch.profiler.record_function``, so that a Chrome trace
shows it beside the kernels.  Off, a span is one flag check that returns a
shared no-op object: no torch call, no CUDA event, no synchronisation.
"""

from __future__ import annotations

import collections
import contextlib
import os
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


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


# -- spans and counters ----------------------------------------------------


class Span(NamedTuple):
    """One phase of the program: ``id`` is the request it belongs to (a
    batch index, a step or tick count; by default its parent's), ``parent``
    the name of the innermost span open on the same thread when it began."""

    name: str
    start_ns: int
    end_ns: int
    id: object
    parent: str | None


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int


class Recorder:
    """The process's spans and counts, in memory: a bounded, append-only
    deque (appends are atomic under the GIL, so any thread may record) that
    drops its oldest events past ``capacity`` and counts them in
    ``dropped``."""

    CAPACITY = 1 << 20

    def __init__(self, capacity: int = CAPACITY) -> None:
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._open = threading.local()
        self.dropped = 0
        self.forced = 0   # open record() blocks

    def append(self, event: Span | Count) -> None:
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        self._events.append(event)

    def open_spans(self) -> list:
        """This thread's open spans, innermost last."""
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def events(self, t0_ns: int | None = None, t1_ns: int | None = None,
               ) -> list[Span | Count]:
        """The spans that overlap [t0_ns, t1_ns] and the counts inside it,
        in order of their start."""
        lo = -1 if t0_ns is None else t0_ns
        hi = float("inf") if t1_ns is None else t1_ns
        inside = [e for e in tuple(self._events)
                  if (e.end_ns >= lo and e.start_ns <= hi if isinstance(e, Span)
                      else lo <= e.t_ns <= hi)]
        return sorted(inside, key=lambda e: e.start_ns if isinstance(e, Span) else e.t_ns)


_recorder = Recorder()


class _Off:
    """The span of a program that is not being recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _On:
    """A span being recorded: its parent and start when entered, the span
    itself when left."""

    __slots__ = ("name", "id", "parent", "start", "annotation")

    def __init__(self, name: str, id) -> None:
        self.name, self.id = name, id

    def __enter__(self):
        stack = _recorder.open_spans()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.id is None and outer is not None:
            self.id = outer.id
        stack.append(self)
        self.start = time.monotonic_ns()
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        end = time.monotonic_ns()
        _recorder.open_spans().pop()
        _recorder.append(Span(self.name, self.start, end, self.id, self.parent))
        return False


def recording() -> bool:
    """Whether spans and counts are being recorded: while a torch profiler
    session runs, or inside :func:`record`."""
    return _autograd_profiler._is_profiler_enabled or _recorder.forced > 0


def span(name: str, id=None):
    """A context manager recording the with-block as the span ``name`` of
    request ``id`` (by default the enclosing span's)."""
    # recording() inlined: this check is all a span costs when off
    if not (_autograd_profiler._is_profiler_enabled or _recorder.forced):
        return _OFF
    return _On(name, id)


def add_span(name: str, start_ns: int, end_ns: int, id=None) -> None:
    """Record a span whose start another thread saw (a queued task's wait
    for a worker)."""
    if recording():
        stack = _recorder.open_spans()
        _recorder.append(Span(name, start_ns, end_ns, id, stack[-1].name if stack else None))


def count(name: str, n: int) -> None:
    """Record ``n`` of what ``name`` counts, now."""
    if recording():
        _recorder.append(Count(name, time.monotonic_ns(), int(n)))


def events(t0_ns: int | None = None, t1_ns: int | None = None) -> list[Span | Count]:
    """The recorded spans that overlap [t0_ns, t1_ns] (``time.monotonic_ns()``
    times; open ends take everything) and the counts inside it."""
    return _recorder.events(t0_ns, t1_ns)


def dropped() -> int:
    """Events dropped because the recorder was full."""
    return _recorder.dropped


@contextlib.contextmanager
def record():
    """Record spans and counts inside the with-block even where no profiler
    session runs."""
    _recorder.forced += 1
    try:
        yield
    finally:
        _recorder.forced -= 1
