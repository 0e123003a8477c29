"""Traffic kind ``voicebot``: real-time voice-bot turns through the port's
websocket server.

The server is the port's ``TranscriptionServer`` over a
``MultiStreamEngine`` of ``slots`` slots and the greedy decoder, on a free
loopback port of this process; its tick runs on one worker thread.  The
load comes from ``client_processes`` processes of ``voicebot_client.py``
(started with ``subprocess``), which play the open-loop schedule there.
Set-up is the process's start, the weights, the engine and its warm-up
tick, and the ramp: ``ramp_seconds`` in which the turns already under way
open.  The window is the next ``--seconds``.  End to end, over every turn
whose end-of-stream frame falls due in the window: the 95th percentile of
the time from that frame being due to the client seeing the server close
the socket after the final phrase, a turn that was refused, failed or
never closed sorting above every completed one.

The reference checks what the timed path produced: a wrapper on the
arena's tick records, from the window's start, the input chunks and
logprobs of ``sample_slots`` slots drawn from those in use, from each
stream's first tick (its reset) on.  The plain float32 step replays each
stream from a zero state, and the widest token gap is compared; each
recorded stream whose turn completed is matched to its turn by its audio,
and its chunks must be the turn's audio as sent and its finals the plain
splitter's and greedy decoder's over the program's logprobs.
"""

from __future__ import annotations

import asyncio
import gc
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from harness import audio, compare, program
from harness.flops import chunk_flops
from harness.report import Outcome
from harness.trace import B1_KERNEL, DeviceTrace
from reference import decode as ref_decode
from reference import model as ref_model
from traffic import voicebot_client as client

CLIENT = Path(client.__file__).resolve()


class Recorder:
    """The arena's ticks as the harness sees them: spans, the sampled
    slots' streams, and the traced sub-window's switch."""

    def __init__(self, engine, n_sample: int, seed: int, window_start: float, trace_at: float,
                 trace_seconds: float, dtrace, b1_rows: list, tracing: list):
        self.engine = engine
        self.n_sample = n_sample
        self.rng = np.random.default_rng([seed, 13])
        self.window_start, self.trace_at, self.trace_seconds = window_start, trace_at, trace_seconds
        self.dtrace, self.b1_rows, self.tracing = dtrace, b1_rows, tracing
        self.slots = None
        self.open: dict[int, dict] = {}     # slot -> its stream being recorded
        self.streams: list[dict] = []
        self.ticks: list[tuple] = []        # (start, arena start, arena end, end, stepped) ns
        self.pending: list[tuple] = []      # (queued chunks, streams) at each tick's start
        self.traced = None                  # [first tick, last tick] indices
        self.trace_cost: dict = {}          # s the profiler's start and stop held a tick
        self._arena_span = None

    def tick(self, real):
        def tick():
            now = time.monotonic()
            if self.dtrace is not None and self.traced is None and now >= self.trace_at:
                self.dtrace.start()
                self.tracing[0] = True
                self.traced = [len(self.ticks), None]
                self.trace_cost["start_s"] = time.monotonic() - now
            streams = list(self.engine._streams.values())
            self.pending.append((sum(len(s.pending) for s in streams), len(streams)))
            self._arena_span = None
            a = time.monotonic_ns()
            out = real()
            b = time.monotonic_ns()
            arena = self._arena_span or (b, b)
            self.ticks.append((a, arena[0], arena[1], b, self._arena_span is not None))
            if self.tracing[0] and time.monotonic() >= self.trace_at + self.trace_seconds:
                stop = time.monotonic()
                self.dtrace.stop()
                self.tracing[0] = False
                self.traced[1] = len(self.ticks)
                self.trace_cost["stop_s"] = time.monotonic() - stop
            return out
        return tick

    def arena_tick(self, real):
        def arena_tick(chunks, active, reset):
            a = time.monotonic_ns()
            out = real(chunks, active, reset)
            self._arena_span = (a, time.monotonic_ns())
            if self.slots is None and time.monotonic() >= self.window_start:
                live = np.flatnonzero(active)
                self.slots = np.sort(self.rng.choice(live, min(self.n_sample, len(live)),
                                                     replace=False))
            if self.slots is not None:
                for s in self.slots[active[self.slots]]:
                    s = int(s)
                    if reset[s]:
                        if s in self.open:
                            self.streams.append(self.open.pop(s))
                        self.open[s] = {"slot": s, "chunks": [], "logprobs": []}
                    if s in self.open:
                        self.open[s]["chunks"].append(np.array(chunks[s], np.int16))
                        self.open[s]["logprobs"].append(np.array(out[s], np.float32))
            return out
        return arena_tick

    def finished(self) -> list[dict]:
        return self.streams + list(self.open.values())


def _start_clients(c, seed: int, seconds: float, frame: int) -> list:
    p = c.params
    procs = []
    for k in range(p["client_processes"]):
        args = json.dumps({"params": p, "seed": seed, "seconds": seconds, "frame": frame,
                           "shard": k, "shards": p["client_processes"]})
        err = tempfile.TemporaryFile()
        proc = subprocess.Popen([sys.executable, str(CLIENT), args], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=err, text=True)
        proc.err_file = err
        procs.append(proc)
    return procs


def _client_error(proc) -> str:
    proc.err_file.seek(0)
    return proc.err_file.read()[-4000:].decode("utf-8", "replace")


def _stop_clients(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.err_file.close()


async def _serve(c, engine, procs, t_ready: list, sched, recorder, reader: ThreadPoolExecutor,
                 trace_at: float):
    """Serve the clients' turns; returns their output lines.  The traced
    sub-window starts ``trace_at`` seconds after the load's start."""
    import websockets
    from tone_tpu_torch.runtime.server import TranscriptionServer

    p = c.params
    loop = asyncio.get_running_loop()
    loop.set_default_executor(ThreadPoolExecutor(1, thread_name_prefix="tick"))
    server = TranscriptionServer(engine)
    ws = await websockets.serve(server.handle, "127.0.0.1", 0, max_size=2**22,
                                ping_interval=None)
    port = ws.sockets[0].getsockname()[1]
    if recorder.dtrace is not None:
        # the tick's own thread traces once before the load, as it will in it
        await loop.run_in_executor(None, recorder.dtrace.prime)
    tick_task = asyncio.create_task(server.tick_loop())
    try:
        for proc in procs:
            line = await loop.run_in_executor(reader, proc.stdout.readline)
            if line.strip() != "ready":
                raise RuntimeError(f"a client failed to start:\n{_client_error(proc)}")
        t0 = time.monotonic() + 0.2
        t_ready.append(t0)
        recorder.window_start = t0 + sched.window[0]
        recorder.trace_at = t0 + trace_at
        for proc in procs:
            proc.stdin.write(json.dumps({"t0": t0, "port": port}) + "\n")
            proc.stdin.flush()
        deadline = t0 + sched.window[1] + p["tail_seconds"] + 30
        outs = []
        for proc in procs:
            out = await loop.run_in_executor(
                reader, lambda pr=proc: pr.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            if proc.returncode != 0:
                raise RuntimeError(f"a client failed (exit {proc.returncode}):\n"
                                   f"{_client_error(proc)}")
            outs.append(out)
    finally:
        # The sessions still open (their clients gone) finish with the
        # server's own drain while the tick runs, then the server stops.
        server.begin_drain()
        try:
            await asyncio.wait_for(server.wait_drained(), timeout=20)
        except asyncio.TimeoutError:
            pass
        ws.close()
        try:
            await asyncio.wait_for(ws.wait_closed(), timeout=10)
        except asyncio.TimeoutError:
            pass
        tick_task.cancel()
        try:
            await tick_task
        except asyncio.CancelledError:
            pass
    return outs


def _expected_chunks(speech, turn, padding: int, chunk: int) -> np.ndarray:
    """The chunks the server should hand the engine for a turn: the leading
    and trailing zeros it adds, then its last part padded."""
    stream = np.concatenate([np.zeros(padding, np.int16), client.turn_audio(speech, turn),
                             np.zeros(padding, np.int16)])
    n = len(stream) // chunk
    last = np.zeros(chunk, np.int16)
    last[: len(stream) - n * chunk] = stream[n * chunk:]
    return np.concatenate([stream[: n * chunk].reshape(n, chunk), last[None]])


def _key(chunk: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(chunk, np.int16).tobytes()).hexdigest()


def run(c, *, seed, seconds, trace, device, started, control=False, faults=None):
    from tone_tpu_torch.core import encoder as port_encoder
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    from harness.weights import make_variables

    faults = faults or {}
    p = c.params
    dev = torch.device(device)
    cfg = program.tone_config(c.model)
    gc_pauses: list = []    # ms of each full collection while serving
    gc_start = {}

    def gc_watch(phase, info):
        if phase == "start":
            gc_start["t"] = time.monotonic()
        elif info["generation"] == 2:
            gc_pauses.append(round((time.monotonic() - gc_start["t"]) * 1000, 2))

    procs = _start_clients(c, seed, seconds, cfg.audio_chunk_samples)
    reader = ThreadPoolExecutor(len(procs), thread_name_prefix="clients")
    b1_rows, tracing = [], [False]
    glu = port_encoder.glu_ff2

    def counted_glu(av, p2, dtype=torch.bfloat16):
        if tracing[0]:
            b1_rows.append((av.numel() // av.shape[-1], p2["w"].shape[0], p2["w"].shape[1]))
        return glu(av, p2, dtype)

    try:
        variables = make_variables(c.model, seed, dev)
        engine = MultiStreamEngine(variables, cfg, n_slots=p["slots"], device=dev)
        engine.warmup()
        engine.warmup()
        program.start_memory(dev)
        speech = audio.pool(seed, p["pool_seconds"])
        sched = client.schedule(p, seed, seconds, len(speech))
        dtrace = DeviceTrace() if trace and dev.type == "cuda" else None
        # The traced sub-window closes the window: the profiler's stop holds
        # the tick for seconds, and nothing the window measures comes later.
        trace_at = sched.window[1] - min(seconds, p["trace_seconds"])
        rec = Recorder(engine, p["sample_slots"], seed, float("inf"), float("inf"),
                       p["trace_seconds"], dtrace, b1_rows, tracing)
        _break(engine, faults)
        engine.arena.tick = rec.arena_tick(engine.arena.tick)
        engine.tick = rec.tick(engine.tick)
        port_encoder.glu_ff2 = counted_glu
        t_ready: list = []
        gc.callbacks.append(gc_watch)
        outs = asyncio.run(_serve(c, engine, procs, t_ready, sched, rec, reader, trace_at))
        if tracing[0]:   # the load ended inside the traced sub-window
            dtrace.stop()
            tracing[0] = False
            rec.traced[1] = len(rec.ticks)
        peak = program.memory_peak(dev)
    finally:
        if gc_watch in gc.callbacks:
            gc.callbacks.remove(gc_watch)
        port_encoder.glu_ff2 = glu
        _stop_clients(procs)
        reader.shutdown()
    engine.shutdown()
    t0 = t_ready[0]
    setup_s = t0 + sched.window[0] - started

    played, lateness = {}, []
    for out in outs:
        for line in out.splitlines():
            row = json.loads(line)
            if "lateness" in row:
                lateness.append(row["lateness"])
            else:
                played[row["i"]] = row
    start_w, end_w = sched.window
    in_window = [t for t in sched.turns if start_w <= t.end < end_w]
    latencies = final_latencies(in_window, played, sched, p)
    failed = sum(played[t.index]["status"] != "ok" for t in in_window)
    lat = np.sort(latencies) * 1000.0
    p95 = nearest_rank(lat, 0.95)

    per_layer, busy, wsec, brk = {}, None, None, None
    if dtrace is not None and rec.traced and rec.traced[1] is not None:
        a, b = rec.traced
        ticks = [tk for tk in rec.ticks[a:b] if tk[4]]
        # the window's ticks before the traced ones: the profiler slows each launch
        plain = [tk for tk in rec.ticks[:a] if tk[4] and start_w <= tk[0] / 1e9 - t0 < end_w]
        spans = {"engine.tick before the step (bind, assemble)": [(tk[0], tk[1]) for tk in ticks],
                 "arena.tick (step, copies)": [(tk[1], tk[2]) for tk in ticks],
                 "engine.tick after the step (splitter, decode submit)": [(tk[2], tk[3]) for tk in ticks]}
        counters = {"ticks": len(ticks), "window_ticks": len(plain),
                    "window_tick_wall_s": sum(tk[3] - tk[0] for tk in plain) / 1e9,
                    "b1_rows": b1_rows, "b1_kernel": B1_KERNEL,
                    "step_flops": p["slots"] * chunk_flops(ref_model.sizes(c.model))}
        per_layer, busy, wsec, brk = program.per_layer(c, dev, dtrace, spans, counters,
                                                       "between ticks (transport, tick loop)")

    streams = rec.finished()
    ticks_all, pending, trace_cost = rec.ticks, rec.pending, rec.trace_cost
    del engine, rec
    program.release(dev)
    compared, notes = _check(c, variables, speech, sched, streams, played, dev, control)
    win = [k for k, tk in enumerate(ticks_all) if tk[4] and start_w <= (tk[0] / 1e9 - t0) < end_w]
    win_ticks = [ticks_all[k] for k in win]
    half = len(lat) // 2
    by_time = np.asarray([x for _, x in sorted(zip([t.end for t in in_window], latencies))]) * 1000
    notes.update({
        "turns_in_window": len(in_window), "turns_played": len(played),
        "status": {s: sum(r["status"] == s for r in played.values())
                   for s in ("ok", "refused", "failed", "dropped")},
        "latency_ms": {"p50": float(np.percentile(lat, 50)), "p95": p95,
                       "p99": float(np.percentile(lat, 99)), "max": float(lat.max()),
                       "p95_first_half": float(np.percentile(by_time[:half], 95)),
                       "p95_second_half": float(np.percentile(by_time[half:], 95))},
        "ticks_in_window": len(win_ticks),
        "tick_ms_mean": float(np.mean([(tk[3] - tk[0]) / 1e6 for tk in win_ticks])) if win else None,
        "tick_ms_p10_p50_p90": [float(np.percentile([(tk[3] - tk[0]) / 1e6 for tk in win_ticks], q))
                                for q in (10, 50, 90)] if win else None,
        # ms of each phase of the window's ticks (p50, p90): before the
        # step, the arena's step, after it, and the loop until the next tick
        "tick_phases_ms": {name: [float(np.percentile(v, q)) for q in (50, 90)] for name, v in (
            ("before", [(tk[1] - tk[0]) / 1e6 for tk in win_ticks]),
            ("arena", [(tk[2] - tk[1]) / 1e6 for tk in win_ticks]),
            ("after", [(tk[3] - tk[2]) / 1e6 for tk in win_ticks]),
            ("loop", [(ticks_all[k + 1][0] - tk[3]) / 1e6
                      for k, tk in zip(win, win_ticks) if k + 1 < len(ticks_all)]))} if win else None,
        "gc_pauses_ms": gc_pauses,
        "pending_per_stream_max": max((pending[k][0] / max(pending[k][1], 1) for k in win),
                                      default=None),
        "client_lateness_s": lateness, "arrival_rate_per_s": sched.rate,
        "trace_cost_s": trace_cost,
        "mean_turn_s": sched.mean_seconds})
    return Outcome(attempted=len(in_window), failed=failed,
                   end_to_end={"setup_s": setup_s, "final_latency_p95_ms": p95},
                   compared=compared, memory_peak_bytes=peak,
                   device_kind=program.device_kind(dev), per_layer=per_layer, busy_s=busy,
                   window_s=wsec, breakdown=brk, notes=notes)


def final_latencies(turns: list, played: dict, sched, p: dict) -> np.ndarray:
    """Seconds from each turn's end-of-stream frame being due to the close
    its client saw.  A turn that did not complete counts as longer than any
    that did: the time it was waited for, and a second more."""
    out = []
    for t in turns:
        row = played[t.index]
        if row["status"] == "ok":
            out.append(row["close"] - t.end)
        else:
            out.append(client.stop_time(t, sched, p) - t.end + 1.0)
    return np.asarray(out, dtype=np.float64)


def nearest_rank(sorted_values: np.ndarray, q: float) -> float:
    """The q-quantile by nearest rank: the smallest value with at least a
    share q of the values at or below it."""
    return float(sorted_values[max(0, int(np.ceil(q * len(sorted_values))) - 1)])


def _break(engine, faults: dict) -> None:
    """Faults the tests plant under the timed path."""
    arena = engine.arena
    if faults.get("state_unchanged"):
        step = arena._step

        def unchanged(k, *args):
            old = arena._states[k]
            out = step(k, *args)
            arena._states[k] = old
            return out
        arena._step = unchanged
    if faults.get("half_batch"):
        tick = arena.tick

        def half(chunks, active, reset):
            out = tick(chunks, active, reset)
            n = len(out) // 2
            out[n:] = out[: len(out) - n]
            return out
        arena.tick = half
    if faults.get("token_altered"):
        forward = engine.decoder.forward

        class Altered:
            def forward(self, logprobs):
                return forward(logprobs) + "а"
        engine.decoder = Altered()


def _check(c, variables, speech, sched, streams, played, dev, control):
    """The sampled streams against the plain step, and their turns' chunks
    and finals against what was sent and the plain decoding."""
    s = ref_model.sizes(c.model)
    labels = c.model["labels"]
    # Each turn's key: its second chunk as the server hands it over (a key
    # that two turns share names neither).
    keys = {}
    for t in sched.turns:
        head = _expected_chunks(speech, client.Turn(t.index, t.start, min(t.samples, 2 * s.chunk_samples),
                                                    t.offset, t.gain), s.padding, s.chunk_samples)
        k = _key(head[1])
        keys[k] = None if k in keys else t
    streams = [st for st in streams if len(st["chunks"]) >= 2]
    gaps, low_gaps, mismatched, checked = [], [], {"audio": 0, "texts": 0}, 0
    err, low_err = compare.SquaredError(), compare.SquaredError()
    if streams:
        n = max(len(st["chunks"]) for st in streams)
        chunks = np.zeros((len(streams), n, s.chunk_samples), np.int16)
        for k, st in enumerate(streams):
            chunks[k, : len(st["chunks"])] = np.stack(st["chunks"])
        sides = {"float32": ref_model.FLOAT32}
        if control:
            sides["fp8"] = ref_model.Precision("fp8")
        logprobs = {}
        with ref_model.float32_exactly(), torch.no_grad():
            for name, pr in sides.items():
                state = ref_model.zero_state(s, len(streams), dev)
                rows = []
                for j in range(n):
                    lp, state = ref_model.streaming_step(
                        variables, s, torch.from_numpy(chunks[:, j]).to(dev), state, pr)
                    rows.append(lp.cpu().numpy())
                logprobs[name] = np.stack(rows, axis=1)
        for k, st in enumerate(streams):
            m = len(st["chunks"])
            prog = np.concatenate(st["logprobs"])
            ref = logprobs["float32"][k, :m].reshape(-1, s.vocab)
            gaps.append(compare.token_gap(prog, ref))
            err.add(prog, ref)
            if control:
                low = logprobs["fp8"][k, :m].reshape(-1, s.vocab)
                low_gaps.append(compare.token_gap(low, ref))
                low_err.add(low, ref)
            turn = keys.get(_key(st["chunks"][1]))
            if turn is None or played.get(turn.index, {}).get("status") != "ok":
                continue
            checked += 1
            sent = _expected_chunks(speech, turn, s.padding, s.chunk_samples)
            same_audio = sent.shape == (m, s.chunk_samples) and np.array_equal(sent, np.stack(st["chunks"]))
            same_text = played[turn.index]["texts"] == ref_decode.phrase_texts(prog, labels)
            mismatched["audio"] += not same_audio
            mismatched["texts"] += same_audio and not same_text
    compared = {"logprob_rms": err.rms(),
                "finals_mismatched": sum(mismatched.values()) if checked else None}
    notes = {"streams_compared": len(gaps), "turns_checked": checked,
             "mismatched": mismatched, "token_gap": max(gaps) if gaps else None,
             "steps_compared": int(sum(len(st["chunks"]) for st in streams))}
    if control:
        notes["control"] = {"logprob_rms": low_err.rms()}
        notes["control_token_gap"] = max(low_gaps) if low_gaps else None
    return compared, notes
