"""The port's span and counter recorder (tone_tpu_torch/profiling.py) in
the bulk, training and serving paths, and the benchmark's readers of it
(benchmark/metrics/idle_in_*.py, useful_share.*.py), on the CPU with the
tiny model.

* off (no profiler session, no ``record()``): nothing is recorded and no
  ``record_function`` is entered;
* under a CPU profiler: every span, nested under its parent, with its
  request's id, on ``time.monotonic_ns``'s clock inside the session;
* the counters against the padded and unpadded samples worked out here;
* recording changes no transcript, logprob, loss or parameter;
* the readers on a hand-made reading.
"""

import functools
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_common import tiny_configs, tiny_variables_with_stats
from torch.profiler import ProfilerActivity, profile

from tone_tpu_torch import profiling
from tone_tpu_torch.bridge import tree_leaves
from tone_tpu_torch.offline import OfflineTranscriber
from tone_tpu_torch.runtime.engine import MultiStreamEngine
from tone_tpu_torch.training.collator import DataCollatorCTCWithPadding
from tone_tpu_torch.training.train import Trainer, TrainerConfig

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
LENGTHS = (5000, 7200, 1200, 4807)   # two batches of two, reordered by length

OFFLINE = {"offline.assemble", "offline.forward", "offline.wait", "offline.split",
           "offline.decode", "offline.align"}
TRAIN = {"train.batch", "train.forward", "train.loss", "train.backward", "train.optimizer"}
TICK = {"engine.tick": None, "engine.bind": "engine.tick", "engine.step": "engine.tick",
        "arena.upload": "engine.step", "arena.dispatch": "engine.step",
        "arena.readback": "engine.step", "engine.split": "engine.tick",
        "engine.finish": "engine.tick", "engine.decode_wait": None, "engine.decode": None}


@functools.lru_cache(maxsize=None)
def _tiny():
    jc, tc = tiny_configs()
    _, tv = tiny_variables_with_stats(jc, tc, seed=2)
    return tc, tv


def _audios(lengths=LENGTHS, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(-20000, 20000, n).astype(np.int32) for n in lengths]


def _transcriber(**kw):
    tc, tv = _tiny()
    return OfflineTranscriber(tv, tc, batch_size=2, device="cpu", **kw)


def _train_batch(seed=0, lengths=(4000, 6000, 2500)):
    rng = np.random.default_rng(seed)
    return DataCollatorCTCWithPadding()(
        [{"input_values": rng.normal(0, 0.1, n).astype(np.float32), "labels": t}
         for n, t in zip(lengths, ("да нет", "привет мир", "ёж"))])


def _train(steps=2):
    """(losses, parameters) after ``steps`` steps of a fresh trainer."""
    tc, tv = _tiny()
    trainer = Trainer(tc, TrainerConfig(total_steps=10, learning_rate=1e-3), device="cpu")
    state = trainer.create_state(tv)
    losses = []
    for k in range(steps):
        state, loss = trainer.train_step(state, _train_batch(k))
        losses.append(loss)
    return losses, [p.detach().clone() for p in tree_leaves(state.params)]


def _serve(ticks=4):
    """Two streams of ``ticks`` chunks through a two-slot engine; the texts
    of their final phrases."""
    tc, tv = _tiny()
    engine = MultiStreamEngine(tv, tc, n_slots=2, device="cpu")
    rng = np.random.default_rng(0)
    try:
        sids = [engine.open_stream() for _ in range(2)]
        for k in range(ticks):
            for sid in sids:
                engine.feed(sid, rng.integers(-20000, 20000, tc.audio_chunk_samples)
                            .astype(np.int16), is_last=k == ticks - 1)
        futures = []
        while engine.has_backlog():
            futures += [f for fs in engine.tick().values() for f in fs]
        return [f.result(timeout=60).text for f in futures]
    finally:
        engine.shutdown()


def _spans(t0, t1):
    return [e for e in profiling.events(t0, t1) if isinstance(e, profiling.Span)]


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with recording off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.recording()
    assert profiling.span("a", 1) is profiling.span("b")   # the shared no-op
    t0 = time.monotonic_ns()
    _transcriber(word_timestamps=True).transcribe(_audios())
    _train(1)
    assert _serve()
    assert profiling.events(t0, time.monotonic_ns()) == []


def test_spans_nest_with_their_ids_under_a_cpu_profiler():
    t0 = time.monotonic_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        inside = time.monotonic_ns()
        _transcriber(word_timestamps=True).transcribe(_audios())
        _train(2)
        texts = _serve()
        done = time.monotonic_ns()
    assert not profiling.recording()
    spans = _spans(t0, time.monotonic_ns())
    assert spans and all(inside <= s.start_ns <= s.end_ns <= done for s in spans)
    by_name: dict = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert set(by_name) == OFFLINE | TRAIN | set(TICK)

    # Bulk: one span of each phase per batch, the batch's index their id.
    for name in OFFLINE:
        assert sorted(s.id for s in by_name[name]) == [0, 1], name
        assert all(s.parent is None for s in by_name[name])
    # Training: one of each per step, the state's step their id.
    for name in TRAIN:
        assert sorted(s.id for s in by_name[name]) == [0, 1], name
    # The tick: phases inside their parent, all with the tick's count.
    ticks = {s.id: s for s in by_name["engine.tick"]}
    assert sorted(ticks) == [0, 1, 2, 3]
    for name, parent in TICK.items():
        for s in by_name[name]:
            assert s.parent == parent, name
            tick = ticks[s.id]
            if name.startswith("arena."):
                step = next(p for p in by_name["engine.step"] if p.id == s.id)
                assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
            if parent is not None:
                assert tick.start_ns <= s.start_ns <= s.end_ns <= tick.end_ns, name
    # The finals decode on the pool after the last tick queued them.
    assert len(by_name["engine.decode"]) == len(texts) == 2
    for wait, work in zip(sorted(by_name["engine.decode_wait"], key=lambda s: s.start_ns),
                          sorted(by_name["engine.decode"], key=lambda s: s.start_ns)):
        assert wait.id == work.id == 3
        assert ticks[3].start_ns <= wait.start_ns <= wait.end_ns <= work.start_ns


def _padded_samples():
    """The samples the tiny transcriber computes for ``_audios()``, worked
    out apart from it: rows sorted by length in batches of two, each padded
    by the config's padding on both sides and to the batch's longest row, in
    whole buckets of eight chunks."""
    tc, _ = _tiny()
    chunk, pad = tc.audio_chunk_samples, tc.padding
    rows = sorted(LENGTHS)
    padded = 0
    for batch in (rows[:2], rows[2:]):
        n_chunks = max(-(-(n + 2 * pad) // chunk) for n in batch)
        padded += len(batch) * -(-n_chunks // 8) * 8 * chunk
    return padded


def _counts(run):
    """{name: [n, ...]} of the counts recorded while ``run()`` runs under
    ``record()``."""
    t0 = time.monotonic_ns()
    with profiling.record():
        run()
    counts: dict = {}
    for e in profiling.events(t0, time.monotonic_ns()):
        if isinstance(e, profiling.Count):
            counts.setdefault(e.name, []).append(e.n)
    return counts


def test_counters_are_the_unpadded_and_computed_samples():
    rows = sorted(LENGTHS)
    padded = _padded_samples()
    train_batches = [_train_batch(k) for k in range(2)]

    counts = _counts(lambda: (_transcriber().transcribe(_audios()), _train(2)))
    assert counts["offline.audio_samples"] == [sum(rows[:2]), sum(rows[2:])]
    assert sum(counts["offline.padded_samples"]) == padded
    assert counts["train.audio_samples"] == [int(b["input_lengths"].sum())
                                             for b in train_batches]
    assert counts["train.padded_samples"] == [b["input_values"].size for b in train_batches]
    assert not profiling.recording()


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_upload_counters_are_the_rows_own_bytes(dtype):
    audios = [a.astype(dtype) for a in _audios()]
    rows = sorted(LENGTHS)
    tr = _transcriber()
    counts = _counts(lambda: tr.transcribe(audios))
    # Only the calls' own samples are sent, in their own width (int16 calls
    # as int16, others as int32), batch by batch.
    width = np.dtype(dtype).itemsize
    assert counts["offline.upload_bytes"] == [sum(rows[:2]) * width, sum(rows[2:]) * width]
    assert counts["offline.audio_samples"] == [sum(rows[:2]), sum(rows[2:])]
    assert sum(counts["offline.padded_samples"]) == _padded_samples()
    assert sum(counts["offline.staging_allocs"]) == 2   # a buffer for each batch
    again = _counts(lambda: tr.transcribe(audios))
    assert again["offline.upload_bytes"] == counts["offline.upload_bytes"]
    assert "offline.staging_allocs" not in again        # both reused
    # Off: nothing is recorded.
    t0 = time.monotonic_ns()
    tr.transcribe(audios)
    assert profiling.events(t0, time.monotonic_ns()) == []


def test_recording_changes_no_result():
    def run():
        tr = _transcriber(word_timestamps=True)
        texts = [[(p.text, p.start_time, p.end_time, p.words) for p in u]
                 for u in tr.transcribe(_audios())]
        return texts, tr.logprobs(_audios()), _train(2)

    texts, logprobs, (losses, params) = run()
    with profiling.record():
        texts_on, logprobs_on, (losses_on, params_on) = run()
    assert texts_on == texts
    for a, b in zip(logprobs, logprobs_on):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(losses + params, losses_on + params_on):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The benchmark's readers, on a hand-made reading
# ---------------------------------------------------------------------------


@pytest.fixture
def bench(monkeypatch):
    """The benchmark's trace reader and an empty recorder of the port's."""
    monkeypatch.syspath_prepend(str(BENCH))
    from harness import trace

    monkeypatch.setattr(profiling, "_recorder", profiling.Recorder())
    return trace


def _reading(trace, ops_us, t0=10**12, window_us=1000):
    """A reading whose traced window is [t0, t0 + window_us] with device
    operations at ``ops_us`` ((start, end) µs after t0)."""
    dtrace = trace.DeviceTrace()
    dtrace.t0, dtrace.t1 = t0, t0 + window_us * 1000
    dtrace._ops = [trace.Op("kernel", t0 + a * 1000, (b - a) * 1000) for a, b in ops_us]
    return trace.Reading(cell=None, sizes=None, peaks=None, trace=dtrace)


def _place(t0, name, a_us, b_us, id=0, parent=None):
    profiling._recorder.append(
        profiling.Span(name, t0 + a_us * 1000, t0 + b_us * 1000, id, parent))


METRICS = ("idle_in_finish.bulk", "idle_in_launch.bulk", "useful_share.bulk",
           "idle_in_upload.train", "idle_in_dispatch.train", "useful_share.train")


def test_readers_give_none_without_the_programs_events(bench):
    r = _reading(bench, [(100, 300)])
    assert [bench.read_metric(m, r) for m in METRICS] == [None] * 6
    _place(r.trace.t0, "offline.split", 0, 50)          # a span, but no device op
    assert bench.read_metric("idle_in_finish.bulk", _reading(bench, [])) is None


def test_bulk_readers_on_hand_placed_spans(bench):
    # The card runs [100, 300] and [500, 600] µs of a 1,000 µs window: idle
    # 70 %, in [0, 100], [300, 500] and [600, 1000].
    r = _reading(bench, [(100, 300), (500, 600)])
    t0 = r.trace.t0
    _place(t0, "offline.assemble", 0, 50)               # idle 50
    _place(t0, "offline.forward", 50, 150)              # idle 50 (50-100)
    _place(t0, "offline.split", 300, 400, id=1)         # with decode: idle 150 once
    _place(t0, "offline.decode", 350, 450, id=1)
    _place(t0, "offline.align", 360, 380, id=1, parent="offline.decode")   # nested
    _place(t0, "offline.wait", 450, 520, id=1)          # no reader's
    _place(t0, "offline.decode", 650, 700, id=2)        # idle 50
    _place(t0, "offline.forward", 950, 1100, id=3)      # idle 50 inside the window
    _place(t0, "train.batch", 600, 640)                 # another cell's
    for n, at_us in ((3, 10), (5, 20), (8, -5)):        # the last before the window
        profiling._recorder.append(profiling.Count("offline.audio_samples", t0 + at_us * 1000, n))
    for n, at_us in ((8, 10), (12, 20), (16, -5)):
        profiling._recorder.append(profiling.Count("offline.padded_samples", t0 + at_us * 1000, n))
    idle = bench.read_metric("device_idle_share.bulk", r)
    finish = bench.read_metric("idle_in_finish.bulk", r)
    launch = bench.read_metric("idle_in_launch.bulk", r)
    assert idle == pytest.approx(70.0)
    assert finish == pytest.approx(20.0)
    assert launch == pytest.approx(15.0)
    assert finish + launch <= idle + 0.1
    assert bench.read_metric("useful_share.bulk", r) == pytest.approx(40.0)
    assert bench.read_metric("idle_in_upload.train", r) == pytest.approx(4.0)


def test_train_readers_on_hand_placed_spans(bench):
    # One step: upload [0, 40] while the card is idle, then the card runs
    # [60, 500] while the host dispatches forward [40, 200], loss [200, 260]
    # and backward [260, 700], the optimizer [700, 900]; idle 60 + 500 µs.
    r = _reading(bench, [(40, 60), (60, 300), (250, 500)])
    t0 = r.trace.t0
    _place(t0, "train.batch", 0, 40)                    # idle 40
    _place(t0, "train.forward", 40, 200)                # idle 0 (40-60 busy)
    _place(t0, "train.loss", 200, 260)
    _place(t0, "train.backward", 260, 700)              # idle 200
    _place(t0, "train.optimizer", 700, 900)             # idle 200
    profiling._recorder.append(profiling.Count("train.audio_samples", t0 + 10_000, 475))
    profiling._recorder.append(profiling.Count("train.padded_samples", t0 + 10_000, 1000))
    idle = bench.read_metric("device_idle_share.train", r)
    upload = bench.read_metric("idle_in_upload.train", r)
    dispatch = bench.read_metric("idle_in_dispatch.train", r)
    assert idle == pytest.approx(54.0)
    assert upload == pytest.approx(4.0)
    assert dispatch == pytest.approx(40.0)
    assert upload + dispatch <= idle + 0.1
    assert bench.read_metric("useful_share.train", r) == pytest.approx(47.5)
    assert bench.read_metric("idle_in_finish.bulk", r) is None


def test_recorder_drops_the_oldest_past_its_capacity():
    rec = profiling.Recorder(capacity=3)
    for k in range(5):
        rec.append(profiling.Count("n", k, 1))
    assert [e.t_ns for e in rec.events()] == [2, 3, 4] and rec.dropped == 2
