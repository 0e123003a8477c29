"""Layer FastConformer forward (core/fastconformer.py apply_fastconformer):
per cent of the card's bf16 peak, the useful operations of the traced
job's calls (each call alone, harness/flops_fastconformer.py) over the
traced window."""


def read(r):
    if r.peaks is None or not r.counters.get("flops") or r.trace.window_s <= 0:
        return None
    return 100.0 * r.counters["flops"] / (r.trace.window_s * r.peaks["bf16_flops"])
