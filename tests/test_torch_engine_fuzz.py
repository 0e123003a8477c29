"""The port's engine lifecycle under randomized interleavings (port of
tests/test_engine_fuzz.py, on tone_tpu_torch/runtime/engine.py).

Open / feed / tick / close / suspend / resume, candidate binds and
evictions in random order, with invariants checked after every operation:
slots are never double-assigned, candidates queue FIFO, and every accepted
stream ends in exactly one of {finished, evicted, suspended}.

* the flagship serving configuration: device-beam batched finals, interim
  device beams, per-request hotwords and n-best overrides as fuzz ops; a
  new, reused or resumed slot's first tick resets its interim beam row, and
  every batched final equals a replay of its phrase on a decoder built with
  that stream's hotwords and n-best alone;
* the same on a stream arena split over two data devices (``[cpu, cpu]``);
* heavier candidate churn: more streams than slots and queue, constant
  feeding (the buffer cap and force eviction).

The hotword settings of a replayed final are looked up by its tables
object, and every tables object is held until the replay, so that an id
freed mid-run cannot be reused by another stream's tables.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
from test_torch_common import tiny_configs, tiny_variables

from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder, GreedyCTCDecoder
from tone_tpu_torch.parallel.mesh import arena_shardings, make_mesh
from tone_tpu_torch.runtime.engine import MultiStreamEngine, UnknownStreamError

# tests/test_engine_fuzz.py's model.
FUZZ_ENCODER = dict(
    n_layers=2, d_model=64, n_heads=4, rope_dim=16, ff_expansion_factor=2,
    conv_kernel_size=7, subsampling_conv_channels=(4, 8), mhsa_stateless_layers=1,
    reduction_position=0, upsample_position=1, should_recompute_att_scores=(True, True))
MAX_CANDIDATES = 3
LEGAL_REFUSALS = ("no free stream slots", "in flight", "waiting candidate", "mid-suspend")


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_configs(encoder=FUZZ_ENCODER)
    _, tv = tiny_variables(jc, tc)
    return tc, tv


def _check_invariants(engine: MultiStreamEngine, n_slots: int) -> None:
    with engine._lock:
        slotted = [s.slot for s in engine._streams.values() if s.slot is not None]
        # no slot double-assignment, no slot both free and assigned,
        # accounting sums to the arena size
        assert len(slotted) == len(set(slotted)), "slot double-assigned"
        assert set(slotted).isdisjoint(engine._free_slots), \
            "slot simultaneously free and assigned"
        assert len(slotted) + len(engine._free_slots) == n_slots
        # candidates are exactly the slotless live streams, FIFO-unique
        pending = list(engine._pending_bind)
        assert len(pending) == len(set(pending))
        slotless = {sid for sid, s in engine._streams.items() if s.slot is None}
        assert slotless == {sid for sid in pending if sid in engine._streams}
        # a free slot with candidates waiting would mean the binder stalled
        if engine._free_slots and not engine._inflight:
            assert not any(sid in engine._streams for sid in pending), \
                "free slot while candidates wait"


@pytest.mark.parametrize("n_data, n_slots", [(1, 3), (2, 4)], ids=["one_device", "two_devices"])
def test_engine_lifecycle_fuzz_flagship_config(tiny, n_data, n_slots):
    cfg, variables = tiny
    rng = random.Random(20260820)
    nprng = np.random.default_rng(2)
    beam_w = 4
    placement = ({"device": "cpu"} if n_data == 1 else
                 {"sharding": arena_shardings(make_mesh(devices=["cpu"] * n_data), cfg,
                                              n_slots)})
    engine = MultiStreamEngine(
        variables, cfg, n_slots=n_slots,
        decoder=DeviceBeamSearchCTCDecoder(beam_width=beam_w, device="cpu"),
        interim_device_beam=True, interim_beam_width=4, final_decode_batch=4,
        max_candidates=MAX_CANDIDATES, candidate_buffer_chunks=8,
        idle_evict_seconds=3600.0, force_evict_grace=0.0,
        hotword_warmup_buckets=(), **placement)
    assert engine.arena.slots_per_device == n_slots // n_data
    # The lazy hotword warm runs a whole frame-bucket ladder per node bucket
    # (tested elsewhere): a no-op here, so the fuzz exercises semantics.
    engine._warm_decode_buckets = lambda *a, **k: None
    n = cfg.audio_chunk_samples

    # -- invariant hooks ----------------------------------------------------
    captured: list[tuple] = []  # (future, logprobs, nbest, hotword tables)
    orig_decode_batch = engine._decode_batch

    def capturing_decode_batch(items):
        for fut, phrase, nb, hw in items:
            captured.append((fut, np.array(phrase.logprobs, np.float32), nb, hw))
        orig_decode_batch(items)

    engine._decode_batch = capturing_decode_batch

    orig_beam_tick = engine._tick_device_beams

    def reset_checking_beam_tick(logprobs, ticking, by_slot, beam_reset):
        for sid, stream, _ in ticking:
            if stream.ticks == 0:  # first tick after open/bind/resume
                assert beam_reset[stream.slot], (
                    f"slot {stream.slot} reused without an interim beam reset (sid {sid})")
        return orig_beam_tick(logprobs, ticking, by_slot, beam_reset)

    engine._tick_device_beams = reset_checking_beam_tick

    hotword_lists = [["мир"], ["дом", "лес"], ["привет"]]
    # id(tables) -> (tables, words, weight): the tables are held, so no id
    # is reused by other tables while the replay may still look it up
    hw_words: dict[int, tuple] = {}

    live: set[int] = set()
    opened: set[int] = set()
    finished: set[int] = set()
    evicted: set[int] = set()
    suspended: set[int] = set()
    snapshots: list[dict] = []
    futures = []

    def poll():
        for sid in engine.pop_finished():
            assert sid not in finished, "stream finished twice"
            finished.add(sid)
            live.discard(sid)
        for sid in engine.pop_evicted():
            assert sid not in evicted, "stream evicted twice"
            assert sid not in finished, "finished stream evicted"
            evicted.add(sid)
            live.discard(sid)

    def note_tables(sid, words, weight):
        tables = engine._streams[sid].hotword_tables
        if tables is not None:
            hw_words[id(tables)] = (tables, words, weight)

    ops = ["open", "feed", "feed", "tick", "tick", "close",
           "suspend", "resume", "hotwords", "nbest"]
    for _ in range(300):
        op = rng.choice(ops)
        try:
            if op == "open":
                sid = engine.open_stream()
                live.add(sid)
                opened.add(sid)
            elif op == "feed" and live:
                sid = rng.choice(sorted(live))
                chunk = nprng.integers(-20000, 20000, rng.randrange(1, n + 1)).astype(np.int16)
                engine.feed(sid, chunk, is_last=rng.random() < 0.1)
            elif op == "tick":
                for sid, futs in engine.tick().items():
                    futures.extend(futs)
            elif op == "close" and live:
                engine.close_stream(rng.choice(sorted(live)))
            elif op == "suspend" and live:
                sid = rng.choice(sorted(live))
                snapshots.append(engine.suspend_stream(sid))
                suspended.add(sid)
                live.discard(sid)
            elif op == "resume" and snapshots:
                sid = engine.resume_stream(snapshots.pop(rng.randrange(len(snapshots))))
                live.add(sid)
                opened.add(sid)
                if sid in engine._streams:  # re-applied biasing at resume
                    s = engine._streams[sid]
                    if s.hotwords:
                        note_tables(sid, list(s.hotwords[0]), s.hotwords[1])
            elif op == "hotwords" and live:
                sid = rng.choice(sorted(live))
                if rng.random() < 0.25:
                    engine.set_stream_hotwords(sid, [])  # clear
                else:
                    words = rng.choice(hotword_lists)
                    engine.set_stream_hotwords(sid, words, 2.0)
                    note_tables(sid, words, 2.0)
            elif op == "nbest" and live:
                sid = rng.choice(sorted(live))
                engine.set_stream_nbest(sid, rng.choice([0, 2, 3]))
        except UnknownStreamError:
            pass  # stream ended (eviction/finish) before the op landed
        except RuntimeError as e:
            assert any(t in str(e) for t in LEGAL_REFUSALS), e
        poll()
        _check_invariants(engine, n_slots)
        # interims only ever surface for streams that were live this tick
        assert not (set(engine.last_interims) - opened)

    for sid in sorted(live):
        engine.close_stream(sid)
    for _ in range(200):
        for sid, futs in engine.tick().items():
            futures.extend(futs)
        poll()
        _check_invariants(engine, n_slots)
        if not live and not engine.has_backlog():
            break
    assert not live, f"streams never terminated: {live}"
    assert opened == (finished | evicted | suspended)
    assert not (finished & evicted) and not (finished & suspended)
    assert not (suspended & evicted)

    for fut in futures:
        phrase = fut.result(timeout=60) if hasattr(fut, "result") else fut
        assert hasattr(phrase, "text")

    engine.shutdown()

    # -- replay: every batched final vs a dedicated decoder ------------------
    assert captured, "fuzz never exercised the batched finals path"
    assert any(hw is not None for _, _, _, hw in captured), \
        "fuzz never exercised a biased batched final"
    assert any(nb > 1 for _, _, nb, _ in captured), \
        "fuzz never exercised an n-best batched final"
    dedicated: dict = {None: DeviceBeamSearchCTCDecoder(beam_width=beam_w, device="cpu")}
    for fut, logprobs, nb, tables in captured:
        key = None if tables is None else id(tables)
        if key not in dedicated:
            held, words, weight = hw_words[key]
            assert held is tables
            dedicated[key] = DeviceBeamSearchCTCDecoder(
                beam_width=beam_w, hotwords=words, hotword_weight=weight, device="cpu")
        dec = dedicated[key]
        got = fut.result(timeout=60)
        if nb > 1:
            expect = dec.nbest(logprobs, nb)
            assert got.text == (expect[0][0] if expect else "")
            assert list(got.nbest) == expect
        else:
            assert got.text == dec.forward(logprobs)


def test_engine_fuzz_with_candidates_churn(tiny):
    """More streams than slots + queue, constant feeding: the buffer cap and
    the force-evict paths."""
    cfg, variables = tiny
    rng = random.Random(7)
    nprng = np.random.default_rng(1)
    engine = MultiStreamEngine(
        variables, cfg, n_slots=2, decoder=GreedyCTCDecoder(), device="cpu",
        max_candidates=2, candidate_buffer_chunks=3,
        idle_evict_seconds=3600.0, force_evict_grace=0.0)
    n = cfg.audio_chunk_samples

    live: list[int] = []
    opened = finished = evicted = 0
    for _ in range(250):
        r = rng.random()
        try:
            if r < 0.3:
                live.append(engine.open_stream())
                opened += 1
            elif r < 0.8 and live:
                sid = rng.choice(live)
                engine.feed(sid, nprng.integers(-100, 100, n).astype(np.int16),
                            is_last=rng.random() < 0.15)
            else:
                engine.tick()
        except UnknownStreamError:
            pass
        except RuntimeError as e:
            assert "no free stream slots" in str(e), e
        finished += len(engine.pop_finished())
        evicted += len(engine.pop_evicted())
        live = [s for s in live if s in engine._streams]
        with engine._lock:
            slotted = [s.slot for s in engine._streams.values() if s.slot is not None]
            assert len(slotted) == len(set(slotted))
            assert len(slotted) + len(engine._free_slots) == 2

    for sid in list(live):
        engine.close_stream(sid)
    for _ in range(100):
        engine.tick()
        finished += len(engine.pop_finished())
        evicted += len(engine.pop_evicted())
        if not engine._streams and not engine.has_backlog():
            break
    assert not engine._streams
    assert finished + evicted == opened
    engine.shutdown()
