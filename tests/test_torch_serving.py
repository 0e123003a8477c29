"""The port's serving path (tone_tpu_torch/runtime, pipeline) on the CPU.

* the arena's reset and active masks, as tests/test_runtime.py:45-97
  specifies them for the JAX arena (float32, 1e-4);
* the port's engine and the JAX engine, given the same tiny float32 weights
  and audio, give the same texts and timestamps (and the same interim text);
* suspend/resume, the options still to port, the metrics, the CLI;
* an in-process websocket round trip through the port's server.
"""

import asyncio
import json

import jax
import numpy as np
import pytest
from test_torch_common import audio, tiny_configs, tiny_variables

from tone_tpu.acoustic import StreamingCTCModel as JaxModel
from tone_tpu.core import model as JM
from tone_tpu.decoder import GreedyCTCDecoder as JaxGreedy
from tone_tpu.pipeline import StreamingCTCPipeline as JaxPipeline
from tone_tpu.runtime.engine import MultiStreamEngine as JaxEngine
from tone_tpu.splitter import StreamingLogprobSplitter as JaxSplitter
from tone_tpu_torch.acoustic import StreamingCTCModel
from tone_tpu_torch.core import model as TM
from tone_tpu_torch.pipeline import StreamingCTCPipeline
from tone_tpu_torch.runtime.arena import StreamArena
from tone_tpu_torch.runtime.engine import MultiStreamEngine
from tone_tpu_torch.runtime.metrics import HealthState, render_metrics

N = 2400


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc)
    return jc, tc, jv, tv


def _jax_logprobs(jv, jc, wav):
    """Single-stream logprobs through the JAX streaming step."""
    state = JM.init_streaming_state(jc, 1)
    step = jax.jit(lambda v, a, s: JM.apply_streaming(v, jc, a, s))
    out = []
    for i in range(len(wav) // N):
        lp, state = step(jv, wav[None, i * N:(i + 1) * N], state)
        out.append(np.asarray(lp)[0])
    return np.concatenate(out, axis=0)


def test_arena_masked_update_and_reset(tiny):
    """Inactive slots keep their state; reset slots behave like new streams."""
    jc, tc, jv, tv = tiny
    wav = audio(N * 4)
    ref = _jax_logprobs(jv, jc, wav)
    arena = StreamArena(tv, tc, n_slots=3, device="cpu")
    chunks = np.zeros((3, N), np.int32)
    got = {0: [], 2: []}
    step_for_slot2 = 0
    # slot0: a chunk every tick; slot2: the same audio on every other tick;
    # slot1: idle throughout.
    for i in range(8):
        active = np.zeros(3, bool)
        reset = np.zeros(3, bool)
        if i == 0:
            reset[[0, 2]] = True
        if i < 4:
            chunks[0] = wav[i * N:(i + 1) * N]
            active[0] = True
        if i % 2 == 0 and step_for_slot2 < 4:
            chunks[2] = wav[step_for_slot2 * N:(step_for_slot2 + 1) * N]
            active[2] = True
            step_for_slot2 += 1
        logprobs = arena.tick(chunks, active, reset)
        for slot in (0, 2):
            if active[slot]:
                got[slot].append(logprobs[slot])
    np.testing.assert_allclose(np.concatenate(got[0]), ref, atol=1e-4)
    np.testing.assert_allclose(np.concatenate(got[2]), ref, atol=1e-4)
    # slot1 never ticked: its state is still all zeros
    idle = TM.unpack_state(arena.read_slot(1)[None], tc)
    assert float(idle.encoder.conv.abs().max()) == 0.0


def test_arena_slot_reuse_is_clean(tiny):
    jc, tc, jv, tv = tiny
    wav = audio(N * 2, seed=1)
    ref = _jax_logprobs(jv, jc, wav)
    arena = StreamArena(tv, tc, n_slots=1, device="cpu")
    for _round in range(2):
        outs = [arena.tick(wav[None, i * N:(i + 1) * N], np.array([True]),
                           np.array([i == 0]))[0] for i in range(2)]
        np.testing.assert_allclose(np.concatenate(outs), ref, atol=1e-4)


def test_arena_slot_blob_moves_between_slots(tiny):
    """write_slot(read_slot(a)) into slot b continues the stream exactly as
    slot a does (up to the fp16 blob)."""
    _, tc, _, tv = tiny
    wav = audio(N * 3, seed=2)
    arena = StreamArena(tv, tc, n_slots=2, device="cpu")
    arena.tick(np.stack([wav[:N], wav[:N]]), np.array([True, False]), np.array([True, True]))
    arena.write_slot(1, arena.read_slot(0))
    np.testing.assert_array_equal(arena.read_slot(1), arena.read_slot(0))
    lp = arena.tick(np.stack([wav[N:2 * N]] * 2), np.array([True, True]), np.zeros(2, bool))
    np.testing.assert_allclose(lp[0], lp[1], atol=5e-2)


def _padded(wav, cfg):
    out = np.pad(wav, (cfg.padding, cfg.padding))
    return np.pad(out, (0, -len(out) % N))


def _drive(engine, streams, cfg, words=False):
    """Open one stream per audio, feed it all, close, tick until done.
    Returns ([(text, start, end), ...] per stream, interims per tick) and,
    with ``words``, the word timings of every phrase in order as tuples."""
    sids = []
    for wav in streams:
        sid = engine.open_stream()
        padded = _padded(wav, cfg)
        for i in range(len(padded) // N):
            engine.feed(sid, padded[i * N:(i + 1) * N])
        engine.close_stream(sid)
        sids.append(sid)
    phrases = {sid: [] for sid in sids}
    interims = []
    for _ in range(max(len(_padded(w, cfg)) for w in streams) // N + 2):
        for sid, futs in engine.tick().items():
            phrases[sid].extend(f.result(timeout=30) for f in futs)
        interims.append({sids.index(s): t for s, t in engine.last_interims.items()})
    texts = [[(p.text, p.start_time, p.end_time) for p in phrases[s]] for s in sids]
    if words:
        return texts, interims, [[(w.word, w.start_time, w.end_time, w.confidence)
                                  for w in p.words or ()]
                                 for s in sids for p in phrases[s]]
    return texts, interims


def test_engine_matches_jax_engine(tiny):
    jc, tc, jv, tv = tiny
    streams = [audio(N * 5, seed=10), audio(N * 7, seed=11)]
    jeng = JaxEngine(jv, jc, n_slots=4, interim_transcripts=True)
    teng = MultiStreamEngine(tv, tc, n_slots=4, device="cpu", interim_transcripts=True)
    try:
        expected, jinterims = _drive(jeng, streams, jc)
        got, tinterims = _drive(teng, streams, tc)
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert all(expected) and got == expected
    assert tinterims == jinterims
    assert teng.stats.phrases_decoded == sum(len(x) for x in got)


def test_pipeline_matches_jax_pipeline(tiny):
    jc, tc, jv, tv = tiny
    wav = audio(N * 5 + 700, seed=12)
    jpipe = JaxPipeline(JaxModel(jv, jc), JaxSplitter(), JaxGreedy())
    tpipe = StreamingCTCPipeline(StreamingCTCModel(tv, tc, device="cpu"))
    expected = [(p.text, p.start_time, p.end_time) for p in jpipe.forward_offline(wav)]
    got = [(p.text, p.start_time, p.end_time) for p in tpipe.forward_offline(wav)]
    assert expected and got == expected
    # chunked streaming + finalize: the same phrases as the JAX pipeline's
    padded = _padded(wav, tc)

    def stream(pipe):
        state, out = None, []
        for i in range(len(padded) // N):
            phrases, state = pipe.forward(padded[i * N:(i + 1) * N], state)
            out.extend(phrases)
        out.extend(pipe.finalize(state)[0])
        return [(p.text, p.start_time, p.end_time) for p in out]

    streamed = stream(tpipe)
    assert streamed and streamed == stream(jpipe)


def test_engine_suspend_resume_continues_the_stream(tiny):
    _, tc, _, tv = tiny
    wav = _padded(audio(N * 6, seed=13), tc)
    chunks = [wav[i * N:(i + 1) * N] for i in range(len(wav) // N)]

    def run(suspend_after):
        eng = MultiStreamEngine(tv, tc, n_slots=2, device="cpu")
        try:
            sid = eng.open_stream()
            futures = []
            for i, chunk in enumerate(chunks):
                eng.feed(sid, chunk, is_last=i == len(chunks) - 1)
                for futs in eng.tick().values():
                    futures.extend(futs)
                if i == suspend_after:
                    sid = eng.resume_stream(eng.suspend_stream(sid))
            for futs in eng.tick().values():
                futures.extend(futs)
            return [(p.text, p.start_time, p.end_time) for p in
                    (f.result(timeout=30) for f in futures)]
        finally:
            eng.shutdown()

    straight = run(suspend_after=-1)
    assert straight
    # the fp16 blob rounds the state: same phrase spans, texts may differ by a char
    moved = run(suspend_after=3)
    assert [p[1:] for p in moved] == [p[1:] for p in straight]


@pytest.mark.parametrize("option, error, match", [
    ({"interim_beam": True}, None, None),
    ({"decoder": object()}, TypeError, "no forward"),
    ({"nbest": 2}, ValueError, "needs a beam decoder"),
    ({"nbest": 1}, ValueError, "ambiguous"),
    ({"nbest": 33}, ValueError, "0..32")])
def test_engine_options_not_ported_raise(tiny, option, error, match):
    """What the port's engine refuses: a decoder with no ``forward``, and
    the JAX engine's n-best checks on a greedy decoder.  ``interim_beam``
    is ported; a greedy engine has no carried search, so it reports the
    greedy interims, as the JAX engine does."""
    _, tc, _, tv = tiny
    if error is None:
        eng = MultiStreamEngine(tv, tc, n_slots=1, device="cpu", **option)
        jeng = JaxEngine(tiny[2], tiny[0], n_slots=1, **option)
        try:
            assert (eng.interim_beam, eng.interim_transcripts) == (
                jeng.interim_beam, jeng.interim_transcripts) == (False, True)
        finally:
            eng.shutdown()
            jeng.shutdown()
        return
    with pytest.raises(error, match=match):
        MultiStreamEngine(tv, tc, n_slots=1, device="cpu", **option)


@pytest.mark.parametrize("option", ["interim_device_beam", "word_timestamps"])
def test_engine_beam_interims_and_word_times_with_greedy_finals(tiny, option):
    """Options that no longer raise: with greedy finals, the interim device
    beam arena and word timestamps give the JAX engine's texts, times,
    words and interims."""
    jc, tc, jv, tv = tiny
    streams = [audio(N * 5, seed=20), audio(N * 6, seed=21)]
    jeng = JaxEngine(jv, jc, n_slots=3, **{option: True})
    teng = MultiStreamEngine(tv, tc, n_slots=3, device="cpu", **{option: True})
    try:
        expected, jinterims, jwords = _drive(jeng, streams, jc, words=True)
        got, tinterims, twords = _drive(teng, streams, tc, words=True)
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert all(expected) and got == expected and tinterims == jinterims
    if option == "word_timestamps":
        assert any(jwords)
        for jw, tw in zip(jwords, twords):
            assert [w[:3] for w in tw] == [w[:3] for w in jw]
            np.testing.assert_allclose([w[3] for w in tw], [w[3] for w in jw], atol=1e-4)
    else:
        assert any(jinterims) and not any(jwords) and not any(twords)


def test_metrics_and_health(tiny):
    _, tc, _, tv = tiny
    eng = MultiStreamEngine(tv, tc, n_slots=2, device="cpu")
    try:
        health = HealthState()
        assert health.status()[0] == 503
        health.record_success()
        assert health.status() == (200, "ok\n")
        text = render_metrics(eng, health)
        assert "tone_slots_total 2" in text and "tone_ready 1" in text
    finally:
        eng.shutdown()


def test_cli_serve_flags_and_checkpoint():
    from tone_tpu_torch.__main__ import build_parser, main

    args = build_parser().parse_args(
        ["serve", "--port", "0", "--slots", "4", "--interim", "--max-candidates", "0",
         "--idle-evict-seconds", "5", "--force-evict-grace", "2", "--drain-grace", "1",
         "--metrics-port", "0", "--host", "127.0.0.1"])
    assert (args.slots, args.interim, args.max_candidates) == (4, True, 0)
    with pytest.raises(FileNotFoundError, match="no_such_model"):
        main(["serve", "--checkpoint", "no_such_model", "--device", "cpu"])


def test_websocket_round_trip(tiny):
    websockets = pytest.importorskip("websockets")
    from tone_tpu_torch.runtime.server import TranscriptionServer

    _, tc, _, tv = tiny
    wav = audio(N * 4, seed=14).astype(np.int16)

    async def client(port):
        events = []
        async with websockets.connect(f"ws://127.0.0.1:{port}/api/ws") as ws:
            assert json.loads(await ws.recv())["event"] == "ready"
            for frame in ({"nbest": 2}, {"hotwords": ["да"]}, {"hotwords": [], "nbest": 0}):
                await ws.send(json.dumps(frame))
                events.append(json.loads(await ws.recv()))
            pcm = wav.astype("<i2").tobytes()
            for i in range(0, len(pcm), 3000):
                await ws.send(pcm[i:i + 3000])
            await ws.send(b"")
            try:
                while True:
                    events.append(json.loads(await asyncio.wait_for(ws.recv(), 30)))
            except websockets.ConnectionClosed:
                pass
        return events

    async def main():
        engine = MultiStreamEngine(tv, tc, n_slots=2, device="cpu")
        server = TranscriptionServer(engine, tick_seconds=0.01)
        tick = asyncio.create_task(server.tick_loop())
        try:
            async with websockets.serve(server.handle, "127.0.0.1", 0) as ws_server:
                return await client(ws_server.sockets[0].getsockname()[1])
        finally:
            tick.cancel()
            engine.shutdown()

    events = asyncio.run(main())
    nbest_err, hotword_ok, cleared = events[:3]
    assert cleared == {"event": "config", "hotwords": 0, "nbest": 0}
    assert nbest_err == {"event": "error", "error": "bad config: the configured decoder has "
                         "no n-best support (greedy decodes a single hypothesis; use a "
                         "beam decoder)"}
    # a greedy engine biases with a host beam decoder of the stream's own
    assert hotword_ok == {"event": "config", "hotwords": 1}
    transcripts = [e for e in events[3:] if e["event"] == "transcript"]
    assert transcripts and all(e["start_time"] <= e["end_time"] for e in transcripts)

    # the same audio through the engine directly gives the same text (the
    # server's flush feeds one more zero chunk, so the end time differs)
    eng = MultiStreamEngine(tv, tc, n_slots=2, device="cpu")
    try:
        direct, _ = _drive(eng, [wav.astype(np.int32)], tc)
    finally:
        eng.shutdown()
    assert [e["text"] for e in transcripts] == [p[0] for p in direct[0]]


def test_serve_sigterm_drains_and_exits(tiny):
    """serve() end to end: SIGTERM mid-stream -> the live client gets its
    full transcript and a 4503 close, and serve() returns within the grace
    period (as tests/test_server.py asks of the JAX server)."""
    import os
    import signal

    websockets = pytest.importorskip("websockets")
    from tone_tpu_torch.runtime.server import serve

    _, tc, _, tv = tiny

    async def main():
        engine = MultiStreamEngine(tv, tc, n_slots=2, device="cpu")
        port_box: asyncio.Queue = asyncio.Queue()
        serve_task = asyncio.create_task(serve(
            engine, "127.0.0.1", 0, metrics_port=None, drain_grace=30.0,
            on_started=port_box.put_nowait))
        try:
            port = await asyncio.wait_for(port_box.get(), timeout=60)
            client = await websockets.connect(f"ws://127.0.0.1:{port}/api/ws")
            assert json.loads(await client.recv())["event"] == "ready"
            await client.send(audio(N * 4, seed=15).astype("<i2").tobytes())
            os.kill(os.getpid(), signal.SIGTERM)
            transcripts = []
            with pytest.raises(websockets.ConnectionClosed) as err:
                while True:
                    msg = json.loads(await asyncio.wait_for(client.recv(), timeout=30))
                    if msg["event"] == "transcript":
                        transcripts.append(msg["text"])
            assert err.value.rcvd.code == 4503
            assert transcripts, "SIGTERM dropped the buffered audio"
            await asyncio.wait_for(serve_task, timeout=30)
        finally:
            if not serve_task.done():
                serve_task.cancel()
            engine.shutdown()

    asyncio.run(main())


def test_cli_serve_starts_and_drains_on_sigterm():
    """``python -m tone_tpu_torch serve`` at the full width (random weights,
    on the CPU here): it starts listening, and SIGTERM drains it to exit 0."""
    import signal
    import subprocess
    import sys
    from pathlib import Path

    pytest.importorskip("websockets")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tone_tpu_torch", "serve", "--device", "cpu", "--slots", "2",
         "--port", "0", "--metrics-port", "0", "--host", "127.0.0.1"],
        cwd=Path(__file__).resolve().parent.parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "listening on ws://" in line:
                break
        assert any("listening on ws://" in ln for ln in lines), "".join(lines)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decoder_matches_jax(seed):
    from tone_tpu_torch.decoder import GreedyCTCDecoder

    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((60, 35)).astype(np.float32) * 3
    logits[rng.random(60) < 0.5, 34] += 6  # plenty of blanks, as CTC emits
    logprobs = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    assert GreedyCTCDecoder().forward(logprobs) == JaxGreedy().forward(logprobs)


def test_beam_decoders_are_not_ported_yet(tmp_path):
    """Every decoder of the JAX factory is built: the host beam, the fused-LM
    device search and the device beam, on the device asked for."""
    from tone_tpu_torch.decoder import (
        BeamSearchCTCDecoder,
        DecoderType,
        DeviceBeamSearchCTCDecoder,
        build_decoder,
    )
    from tone_tpu_torch.decoding.estimate import estimate_ngram_lm, write_arpa

    blanks = np.full((3, 35), -10.0, np.float32)
    blanks[:, 34] = 0.0
    assert build_decoder("greedy").forward(blanks) == ""
    for kind in (DecoderType.BEAM_SEARCH, "beam"):
        host = build_decoder(kind)
        assert isinstance(host, BeamSearchCTCDecoder) and host.forward(blanks) == ""
    write_arpa(estimate_ngram_lm([["да", "нет"], ["нет"]], order=2), tmp_path / "lm.arpa")
    fused = build_decoder("device-beam", lm=tmp_path / "lm.arpa", fused_lm=True, device="cpu")
    assert fused.fusion and fused.forward(blanks) == ""
    decoder = build_decoder("device-beam", beam_width=4, device="cpu")
    assert isinstance(decoder, DeviceBeamSearchCTCDecoder)
    assert (decoder.beam_width, decoder.device.type) == (4, "cpu")
    assert decoder.forward(blanks) == ""
    with pytest.raises(ValueError):
        build_decoder("viterbi")
