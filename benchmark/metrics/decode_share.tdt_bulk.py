"""Layer transducer: greedy TDT loop (core/transducer.py greedy_tdt): the
share of the traced window that the host spent in the batches'
``transducer.decode`` spans, the prediction network's and joint's
dispatch and the host's checks of whether a row still decodes (%)."""

from harness.program_spans import _union, events


def read(r):
    t0, t1 = r.trace.t0, r.trace.t1
    spans = [(max(e.start_ns, t0), min(e.end_ns, t1)) for e in events(r)
             if hasattr(e, "end_ns") and e.name == "transducer.decode"]
    if not spans or t1 <= t0:
        return None
    return 100.0 * sum(b - a for a, b in _union(spans) if b > a) / (t1 - t0)
