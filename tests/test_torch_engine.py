"""The port's MultiStreamEngine lifecycle (tone_tpu_torch/runtime/engine.py).

* a differential fuzz: the same random script of open / feed / tick /
  close / suspend / resume ops, with slot pressure and candidates, drives
  the JAX engine and the port's; every op must have the same outcome (the
  same stream ids, the same refusals) and every tick the same phrases,
  and the port's slot accounting must hold after every op (the invariants
  of tests/test_engine_fuzz.py);
* idle eviction, force eviction under slot pressure, and candidates, each
  on its own.
"""

import random
import time

import numpy as np
import pytest
from test_torch_common import tiny_configs, tiny_variables

from tone_tpu.runtime.engine import MultiStreamEngine as JaxEngine
from tone_tpu.runtime.engine import UnknownStreamError as JaxUnknown
from tone_tpu_torch.runtime.engine import MultiStreamEngine, UnknownStreamError

N = 2400
N_SLOTS = 3
MAX_CANDIDATES = 2


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc)
    return jc, tc, jv, tv


def _check_invariants(engine: MultiStreamEngine, n_slots: int) -> None:
    with engine._lock:
        slotted = [s.slot for s in engine._streams.values() if s.slot is not None]
        assert len(slotted) == len(set(slotted)), "slot double-assigned"
        assert set(slotted).isdisjoint(engine._free_slots)
        assert len(slotted) + len(engine._free_slots) == n_slots
        pending = list(engine._pending_bind)
        assert len(pending) == len(set(pending))
        slotless = {sid for sid, s in engine._streams.items() if s.slot is None}
        assert slotless == {sid for sid in pending if sid in engine._streams}
        if engine._free_slots and not engine._inflight:
            assert not any(sid in engine._streams for sid in pending)


def _outcome(fn):
    """('ok', value) or the exception's kind and message."""
    try:
        return ("ok", fn())
    except (UnknownStreamError, JaxUnknown) as e:
        return ("unknown", str(e))
    except RuntimeError as e:
        return ("refused", str(e))


def test_engine_lifecycle_matches_jax_engine(tiny):
    jc, tc, jv, tv = tiny
    kw = dict(n_slots=N_SLOTS, max_candidates=MAX_CANDIDATES, candidate_buffer_chunks=6,
              idle_evict_seconds=3600.0, force_evict_grace=0.0)
    engines = {"jax": JaxEngine(jv, jc, **kw),
               "port": MultiStreamEngine(tv, tc, device="cpu", **kw)}
    rng = random.Random(20261016)
    nprng = np.random.default_rng(7)
    live: set[int] = set()
    snapshots: list[dict] = []
    ops = ["open", "feed", "feed", "feed", "tick", "tick", "close", "suspend", "resume"]
    try:
        for step in range(160):
            op = rng.choice(ops)
            if op == "feed" and live:
                sid = rng.choice(sorted(live))
                chunk = nprng.integers(-20000, 20000, rng.randrange(1, N + 1)).astype(np.int16)
                last = rng.random() < 0.1
                calls = {k: (lambda e=e: e.feed(sid, chunk, is_last=last))
                         for k, e in engines.items()}
            elif op == "open":
                calls = {k: e.open_stream for k, e in engines.items()}
            elif op == "tick":
                calls = {k: (lambda e=e: {s: [(p.text, p.start_time, p.end_time) for p in
                                              (f.result(timeout=30) for f in futs)]
                                          for s, futs in e.tick().items()})
                         for k, e in engines.items()}
            elif op == "close" and live:
                sid = rng.choice(sorted(live))
                calls = {k: (lambda e=e: e.close_stream(sid)) for k, e in engines.items()}
            elif op == "suspend" and live:
                sid = rng.choice(sorted(live))
                calls = {k: (lambda e=e: e.suspend_stream(sid)) for k, e in engines.items()}
            elif op == "resume" and snapshots:
                snap = snapshots.pop(rng.randrange(len(snapshots)))
                # each engine resumes its own snapshot of the same stream
                calls = {k: (lambda e=e, s=snap[k]: e.resume_stream(s))
                         for k, e in engines.items()}
            else:
                continue
            raw = {k: _outcome(c) for k, c in calls.items()}
            out = dict(raw)
            if op == "suspend":  # compare the snapshots' keys; each engine resumes its own
                out = {k: (kind, sorted(v) if kind == "ok" else v)
                       for k, (kind, v) in raw.items()}
            assert out["port"] == out["jax"], (step, op)
            if op == "suspend" and out["port"][0] == "ok":
                snapshots.append({k: v for k, (_, v) in raw.items()})
                live.discard(sid)
            if op in ("open", "resume") and out["port"][0] == "ok":
                live.add(out["port"][1])
            finished = {k: sorted(e.pop_finished()) for k, e in engines.items()}
            evicted = {k: sorted(e.pop_evicted()) for k, e in engines.items()}
            assert finished["port"] == finished["jax"] and evicted["port"] == evicted["jax"]
            live -= set(finished["port"]) | set(evicted["port"])
            _check_invariants(engines["port"], N_SLOTS)
    finally:
        for e in engines.values():
            e.shutdown()


def test_idle_stream_is_evicted(tiny):
    _, tc, _, tv = tiny
    engine = MultiStreamEngine(tv, tc, n_slots=2, device="cpu", idle_evict_seconds=0.05)
    try:
        sid = engine.open_stream()
        time.sleep(0.1)
        assert engine.tick() == {}
        assert engine.pop_evicted() == [sid]
        with pytest.raises(UnknownStreamError):
            engine.feed(sid, np.zeros(N, np.int16))
    finally:
        engine.shutdown()


def test_slot_pressure_steals_the_quiet_stream(tiny):
    _, tc, _, tv = tiny
    engine = MultiStreamEngine(tv, tc, n_slots=1, device="cpu", force_evict_grace=0.0)
    try:
        quiet = engine.open_stream()
        time.sleep(0.01)
        newcomer = engine.open_stream()
        assert engine.pop_evicted() == [quiet]
        engine.feed(newcomer, np.zeros(N, np.int16))
        assert engine.has_backlog()
    finally:
        engine.shutdown()


def test_candidate_binds_when_a_slot_frees(tiny):
    _, tc, _, tv = tiny
    engine = MultiStreamEngine(tv, tc, n_slots=1, device="cpu", max_candidates=1)
    try:
        first = engine.open_stream()
        waiting = engine.open_stream()  # all slots busy: queued as a candidate
        with pytest.raises(RuntimeError, match="no free stream slots"):
            engine.open_stream()
        engine.feed(waiting, np.ones(N, np.int16))
        assert not engine.has_backlog()  # a candidate cannot tick yet
        engine.close(first)
        assert engine.has_backlog()      # bound to the freed slot
        engine.tick()
        assert engine.stats.chunks_processed == 1 and not engine.has_backlog()
    finally:
        engine.shutdown()
