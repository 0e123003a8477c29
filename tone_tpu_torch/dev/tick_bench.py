"""Engine tick microbenchmark (port of ``dev/tick_bench.py``): host-side
cost at high stream counts.

Measures ``MultiStreamEngine.tick()`` broken into device step and host work
(staging, the vectorized splitter, bookkeeping) at a given slot count — the
serving scalability budget (300 ms per tick) — on the full ``ToneConfig()``
from the JAX bench's initial weights (``core/jax_random.py``).  Run:

    python -m tone_tpu_torch.dev.tick_bench --slots 1024 --ticks 30 [--speech-frac 0.3] [--device cpu]
    python -m tone_tpu_torch.dev.tick_bench --splitter-worst --slots 1024 [--phrase-ticks 40]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.profiling import device_label

TICK_BUDGET_MS = 300.0
WARM_TICKS = 3  # ticks left out of the percentiles


def splitter_worst_case(slots: int, phrase_ticks: int) -> dict:
    """Worst-case host tick for the batched splitter: EVERY slot closes a
    phrase on the same tick (synchronized utterance ends — what fixed-length
    load-test clients produce).  No device in the loop: this isolates the
    boundary branch of ``BatchLogprobSplitter.forward_batch``.
    """
    from tone_tpu_torch.splitter import BatchLogprobSplitter, StreamingLogprobSplitter

    split = BatchLogprobSplitter(slots)
    v = 35
    frames = 10  # per tick (300 ms)
    speech = np.full((frames, v), -8.0, np.float32)
    speech[:, 3] = -0.05          # confident character -> is_speech
    speech[:, -2:] = -12.0
    silence = np.full((frames, v), -8.0, np.float32)
    silence[:, -2:] = -0.7        # blank+space mass (p=0.99) -> silence
    slot_ids = np.arange(slots, dtype=np.int64)
    lasts = np.zeros(slots, bool)

    def tick(frame_block):
        batch = np.broadcast_to(frame_block, (slots, frames, v)).copy()
        t0 = time.monotonic()
        out = split.forward_batch(batch, slot_ids, lasts)
        return time.monotonic() - t0, out

    steady, boundary, n_phrases = [], None, 0
    # grow a phrase in every slot, then silence until every slot closes
    for _ in range(phrase_ticks):
        dt, _ = tick(speech)
        steady.append(dt)
    need = StreamingLogprobSplitter.MIN_SILENCE_DURATION // frames + 2
    for _ in range(need):
        dt, out = tick(silence)
        if out:
            boundary = dt
            n_phrases = sum(len(p) for p in out.values())
            break
        steady.append(dt)
    if boundary is None:
        raise RuntimeError("no phrases closed — bench setup broken")
    return {
        "slots": slots,
        "phrase_frames": phrase_ticks * frames,
        "steady_ms_p50": round(float(np.percentile(steady, 50)) * 1e3, 2),
        "boundary_tick_ms": round(boundary * 1e3, 2),
        "phrases_closed": n_phrases,
        "budget_ms": TICK_BUDGET_MS,
    }


def run_ticks(engine, ticks: int, speech_frac: float, seed: int = 0) -> dict:
    """Open every slot of ``engine`` and tick it ``ticks`` times, each slot
    fed a 300 Hz tone (with probability ``speech_frac``, from
    ``default_rng(seed)``) or silence per tick.  Returns the per-tick host,
    device and tick seconds (``engine.stats``, the first ``WARM_TICKS`` left
    out), the stream ids and the phrases each emitted, as (text, start,
    end)."""
    rng = np.random.default_rng(seed)
    sids = [engine.open_stream() for _ in range(engine.arena.n_slots)]
    n = engine.config.audio_chunk_samples
    # speech-like chunks for a fraction of streams, silence for the rest
    t = np.arange(n) / 8000
    speech = (8000 * np.sin(2 * np.pi * 300 * t)).astype(np.int32)
    silence = np.zeros(n, np.int32)

    host, device, total = [], [], []
    futures = {sid: [] for sid in sids}
    for tick in range(ticks):
        for sid in sids:
            talking = rng.random() < speech_frac
            engine.feed(sid, speech if talking else silence)
        for sid, futs in engine.tick().items():
            futures[sid].extend(futs)
        if tick >= WARM_TICKS:
            host.append(engine.stats.last_host_seconds)
            device.append(engine.stats.last_tick_seconds - engine.stats.last_host_seconds)
            total.append(engine.stats.last_tick_seconds)
    phrases = {sid: [(p.text, p.start_time, p.end_time)
                     for p in (f.result(timeout=120) for f in futs)]
               for sid, futs in futures.items()}
    return {"host": host, "device": device, "tick": total, "sids": sids, "phrases": phrases}


def _ms(xs: list[float], p: float) -> float:
    return round(float(np.percentile(xs, p)) * 1e3, 2)


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bench(slots: int = 1024, ticks: int = 30, speech_frac: float = 0.3, device=None,
          variables=None, config=None) -> dict:
    """The JAX script's measurement: an engine of ``slots`` slots (default:
    the full ``ToneConfig()`` from the JAX bench's initial weights), one
    warmup tick (``arena.warmup()``), then :func:`run_ticks`.  Returns the
    JAX report's keys plus the 95th percentiles, the card, the phrases and,
    on a card, the engine's memory: its resident bytes after warmup, the peak
    during the ticks, and per slot the state's bytes and the peak's share
    beyond the weights."""
    from tone_tpu_torch.bridge import tree_leaves
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    dev = resolve_device(device)
    if config is None:
        from tone_tpu_torch.config import ToneConfig
        from tone_tpu_torch.core.jax_random import jax_init_model_params

        config = ToneConfig()
        variables = jax_init_model_params(0, config)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
    engine = MultiStreamEngine(variables, config, n_slots=slots, device=dev)
    try:
        engine.arena.warmup()
        memory = {}
        if on_card:
            torch.cuda.synchronize(dev)
            resident = torch.cuda.memory_allocated(dev) - before
            torch.cuda.reset_peak_memory_stats(dev)
        out = run_ticks(engine, ticks, speech_frac)
        if on_card:
            peak = torch.cuda.max_memory_allocated(dev) - before
            weights = _tensor_bytes(tree_leaves(engine.arena.variables))
            state = []
            for s in engine.arena._states:
                s.map(lambda x, ax: state.append(x) or x)
            memory = {"resident_bytes": resident, "peak_bytes": peak,
                      "weight_bytes": weights,
                      "state_bytes_per_slot": _tensor_bytes(state) / slots,
                      "peak_bytes_per_slot": (peak - weights) / slots}
    finally:
        engine.shutdown()
    return {
        "slots": slots,
        "speech_frac": speech_frac,
        "host_ms_p50": _ms(out["host"], 50),
        "host_ms_p95": _ms(out["host"], 95),
        "device_ms_p50": _ms(out["device"], 50),
        "device_ms_p95": _ms(out["device"], 95),
        "tick_ms_p50": _ms(out["tick"], 50),
        "tick_ms_p95": _ms(out["tick"], 95),
        "tick_budget_ms": TICK_BUDGET_MS,
        "ticks": ticks,
        **memory,
        **device_label(dev),
        "phrases": out["phrases"],
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--slots", type=int, default=1024)
    parser.add_argument("--ticks", type=int, default=30)
    parser.add_argument("--speech-frac", type=float, default=0.3,
                        help="fraction of streams in active speech per tick")
    parser.add_argument("--cpu", action="store_true", help="same as --device cpu")
    parser.add_argument("--splitter-worst", action="store_true",
                        help="device-free worst case: all slots close a "
                             "phrase on the same tick")
    parser.add_argument("--phrase-ticks", type=int, default=40,
                        help="phrase length in ticks before the "
                             "synchronized close (with --splitter-worst)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    if args.splitter_worst:  # host only
        print(json.dumps({**splitter_worst_case(args.slots, args.phrase_ticks),
                          **device_label("cpu")}))
        return
    report = bench(args.slots, args.ticks, args.speech_frac,
                   "cpu" if args.cpu else args.device)
    del report["phrases"]
    print(json.dumps(report))


if __name__ == "__main__":
    main()
