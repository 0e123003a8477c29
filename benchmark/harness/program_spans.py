"""The program's own spans and counters (``tone_tpu_torch.profiling``)
over a traced run's window, for the per-layer metrics that assign the
card's idle time and the padded work to the program's phases.

The program records them while the traced run's profiler session runs,
on ``time.monotonic_ns()``'s clock, the clock the device's operations are
mapped onto (``trace.DeviceTrace``).  Each reading returns None where the
program recorded nothing of what it reads in the window (a program
without the recorder, or a run whose profiler left it off), never 0.
"""

from __future__ import annotations


def events(r) -> list:
    """The program's spans and counts recorded in the traced window."""
    try:
        from tone_tpu_torch.profiling import events as recorded
    except ImportError:
        return []
    return recorded(r.trace.t0, r.trace.t1)


def _union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap_ns(xs, ys) -> int:
    """Total length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(r, names) -> float | None:
    """Per cent of the traced window in which the card ran nothing while
    the host was inside one of the spans ``names`` (their union, so that a
    span nested in another counts once)."""
    t0, t1 = r.trace.t0, r.trace.t1
    spans = [(max(e.start_ns, t0), min(e.end_ns, t1)) for e in events(r)
             if hasattr(e, "end_ns") and e.name in names]
    if not spans or not r.trace.ops or t1 <= t0:
        return None
    return 100.0 * _overlap_ns(r.trace.idle_gaps(), _union(spans)) / (t1 - t0)


def useful_share(r, useful: str, computed: str) -> float | None:
    """Per cent of the computed samples that are the inputs' own: the sum of
    the counts ``useful`` over the sum of the counts ``computed``."""
    sums = {useful: 0, computed: 0}
    for e in events(r):
        if hasattr(e, "t_ns") and e.name in sums:
            sums[e.name] += e.n
    if not sums[computed]:
        return None
    return 100.0 * sums[useful] / sums[computed]
