"""Layer engine (runtime/engine.py): the mean wall time of
``MultiStreamEngine.tick`` over the measured window's ticks that stepped
the arena before the traced sub-window, from the harness's wrapper on the
engine (ms).  The traced ticks are left out: the profiler slows each
launch."""


def read(r):
    if not r.counters.get("window_ticks"):
        return None
    return 1000.0 * r.counters["window_tick_wall_s"] / r.counters["window_ticks"]
