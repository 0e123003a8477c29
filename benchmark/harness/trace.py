"""The traced run's readings: the device's operations from
``torch.profiler`` (CUDA activity only) over a bounded sub-window, the
harness's own spans and counters, and the per-layer metrics read from
them (``metrics/<name>.py``, each a ``read(reading)`` that returns a
number, or None where it finds nothing to read).

Nothing is written to disk: the trace is read in memory.
"""

from __future__ import annotations

import importlib.util
import time
from dataclasses import dataclass, field

from harness.cell import BENCH_DIR

B1_KERNEL = "glu_ff2_kernel"   # csrc/glu_ff.cu's __global__ function


@dataclass
class Op:
    name: str
    start_ns: int   # on time.monotonic_ns()'s clock
    dur_ns: int


class DeviceTrace:
    """Start and stop a CUDA-activity profile; ``ops`` are the device's
    operations (kernels, copies, fills) between the two."""

    def __init__(self):
        self.t0 = self.t1 = 0
        self._prof = None
        self._ops: list[Op] | None = None

    def prime(self) -> None:
        """Trace a moment of set-up once, so that the profiler's first start
        (which loads and starts CUPTI, seconds on the card) is not paid
        inside the window."""
        import torch

        self.start()
        torch.ones(1, device="cuda").add_(1)
        self.stop()
        self.t0 = self.t1 = 0
        self._prof, self._ops = None, None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._wall0, self.t0 = time.time_ns(), time.monotonic_ns()

    def stop(self) -> None:
        """Stop tracing; the operations are read when first asked for, so
        that the caller (a serving tick) is not held up by it."""
        import torch

        torch.cuda.synchronize()
        self.t1 = time.monotonic_ns()
        self._prof.stop()

    @property
    def ops(self) -> list[Op]:
        if self._ops is None:
            self._ops = self._read() if self._prof is not None else []
        return self._ops

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _read(self) -> list[Op]:
        from torch.autograd import DeviceType

        raw = [(e.name(), e.start_ns(), e.duration_ns())
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
        if not raw:
            return []
        # The profiler's clock is the wall clock or the monotonic one: move
        # its times onto the monotonic clock of the harness's spans.
        first = min(start for _, start, _ in raw)
        shift = (self._wall0 - self.t0) if abs(first - self._wall0) < abs(first - self.t0) else 0
        return sorted((Op(n, s - shift, d) for n, s, d in raw), key=lambda o: o.start_ns)

    def busy_ns(self) -> int:
        """Time in which some operation ran on the device (their union)."""
        busy, end = 0, None
        for op in self.ops:
            a, b = op.start_ns, op.start_ns + op.dur_ns
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy

    def idle_gaps(self) -> list[tuple[int, int]]:
        """(start, end) of each stretch with nothing on the device, the
        traced window's edges included."""
        gaps, end = [], self.t0
        for op in self.ops:
            if op.start_ns > end:
                gaps.append((end, op.start_ns))
            end = max(end, op.start_ns + op.dur_ns)
        if self.t1 > end:
            gaps.append((end, self.t1))
        return gaps


@dataclass
class Reading:
    """What a per-layer metric reads: the trace, the harness's spans
    (name -> [(start_ns, end_ns)] inside the traced window) and counters,
    the cell's sizes and the card's peaks."""

    cell: object
    sizes: object
    peaks: dict | None
    trace: DeviceTrace
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    def ops_named(self, part: str) -> list[Op]:
        return [op for op in self.trace.ops if part in op.name]


def read_metric(name: str, reading: Reading):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(reading)


def breakdown(reading: Reading, labels) -> dict:
    """The ten device operations that took most time, and the idle time of
    the device summed by what the host was doing (``labels(t_ns)`` of each
    gap's middle), the ten largest."""
    by_name: dict[str, int] = {}
    for op in reading.trace.ops:
        by_name[op.name] = by_name.get(op.name, 0) + op.dur_ns
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps: dict[str, int] = {}
    for a, b in reading.trace.idle_gaps():
        label = labels((a + b) // 2)
        gaps[label] = gaps.get(label, 0) + (b - a)
    longest = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, ns / 1e9] for n, ns in longest]}


def span_label(spans: dict, default: str):
    """``labels`` for ``breakdown``: the name of the span holding a time."""
    def label(t_ns):
        for name, intervals in spans.items():
            for a, b in intervals:
                if a <= t_ns < b:
                    return name
        return default
    return label
