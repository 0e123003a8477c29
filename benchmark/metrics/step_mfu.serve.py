"""Layer step: per cent of the card's bf16 peak that the arena's steps
reach over the ticks' wall time (the measured window's ticks that stepped
the arena before the traced sub-window).  The arena steps every slot each tick, so
a tick is the slots' model operations at one chunk each
(``harness.flops.chunk_flops``)."""


def read(r):
    if r.peaks is None or not r.counters.get("window_ticks"):
        return None
    ops = r.counters["step_flops"] * r.counters["window_ticks"]
    return 100.0 * ops / (r.counters["window_tick_wall_s"] * r.peaks["bf16_flops"])
