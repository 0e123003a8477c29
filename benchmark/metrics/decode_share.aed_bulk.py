"""Layer AED decoder: greedy decode with a KV cache (core/aed.py
greedy_aed): the share of the traced window that the host spent in the
batches' ``aed.prefill`` and ``aed.decode`` spans (their union): the
cross-attention keys and values, the prompt's pass, the graphed steps'
replays and the host's checks of whether a row is still live (%)."""

from harness.program_spans import _union, events

SPANS = ("aed.prefill", "aed.decode")


def read(r):
    t0, t1 = r.trace.t0, r.trace.t1
    spans = [(max(e.start_ns, t0), min(e.end_ns, t1)) for e in events(r)
             if hasattr(e, "end_ns") and e.name in SPANS]
    if not spans or t1 <= t0:
        return None
    return 100.0 * sum(b - a for a, b in _union(spans) if b > a) / (t1 - t0)
