"""Readings that several per-layer metrics share (``metrics/<name>.py``
each name one of them for its layer and cell).  Each returns None where
the traced run gives it nothing to read, never 0."""

from __future__ import annotations

from harness.flops import b1_bound_s


def idle_share(r) -> float | None:
    """Per cent of the traced window with nothing running on the device."""
    if not r.trace.ops or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_ns() / 1e9 / r.trace.window_s)


def b1_roofline(r) -> float | None:
    """Per cent of B1's least time that its launches took: the sum over
    the traced launches of the bound at each launch's rows (recorded in
    launch order by the harness) over the sum of their device times."""
    launches = r.ops_named(r.counters.get("b1_kernel", "\0"))
    rows = r.counters.get("b1_rows") or []
    if not launches or len(launches) != len(rows) or r.peaks is None:
        return None
    bound = sum(b1_bound_s(m, f, d, r.peaks) for m, f, d in rows)
    return 100.0 * bound / (sum(op.dur_ns for op in launches) / 1e9)


def audio_mfu(r, passes: float) -> float | None:
    """Per cent of the bf16 peak: the model operations of the audio seconds
    done in the traced window (``passes`` times the forward's) over the
    window."""
    if r.peaks is None or not r.counters.get("audio_s") or r.trace.window_s <= 0:
        return None
    ops = passes * r.counters["audio_s"] * r.counters["flops_per_audio_s"]
    return 100.0 * ops / (r.trace.window_s * r.peaks["bf16_flops"])
