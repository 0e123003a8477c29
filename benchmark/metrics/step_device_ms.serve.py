"""Layer step (runtime/arena.py, core/model.py apply_streaming): the
device's operation time in the traced window per tick that stepped the
arena (ms)."""


def read(r):
    if not r.counters.get("ticks") or not r.trace.ops:
        return None
    return sum(op.dur_ns for op in r.trace.ops) / 1e6 / r.counters["ticks"]
