"""Layer AED decoder: greedy decode with a KV cache (core/aed.py
greedy_aed): the decode's share of its memory bound (%).  Its least time is
the bytes the live rows' steps must read (the sum of ``aed.step_bytes``,
``harness/bytes_aed.py``: the decoder's and head's weights once a step,
each live row's cross-attention keys and values and its self-attention
keys and values up to its position) at the card's memory bandwidth; its
time is the wall of the ``aed.decode`` spans.  It counts only bytes that
must move, so it cannot pass 100.  None where the program recorded
neither."""

from harness.program_spans import _union, events


def read(r):
    t0, t1 = r.trace.t0, r.trace.t1
    moved, spans = 0, []
    for e in events(r):
        if hasattr(e, "t_ns") and e.name == "aed.step_bytes":
            moved += e.n
        elif hasattr(e, "end_ns") and e.name == "aed.decode":
            spans.append((max(e.start_ns, t0), min(e.end_ns, t1)))
    wall = sum(b - a for a, b in _union(spans) if b > a)
    if not moved or not wall or r.peaks is None:
        return None
    return 100.0 * moved / r.peaks["hbm_bytes"] / (wall / 1e9)
