"""The port's engine, pipeline, server and CLI with the device-beam decoder,
against the JAX package on the CPU.

With ``DeviceBeamSearchCTCDecoder(beam_width=8)``, the interim device beam
arena, word timestamps, n-best and per-request hotwords, the port's engine
gives the JAX engine's final texts, phrase times, words (confidences within
1e-4), alternatives (scores within 1e-4) and interim texts, on the tiny
model of tests/test_torch_serving.py with the same weights and audio.
"""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest
from test_torch_common import audio, tiny_configs, tiny_variables

from tone_tpu.acoustic import StreamingCTCModel as JaxModel
from tone_tpu.decoder import DeviceBeamSearchCTCDecoder as JaxDecoder
from tone_tpu.decoding.estimate import estimate_ngram_lm
from tone_tpu.decoding.lm import ArpaLM as JaxArpa
from tone_tpu.pipeline import StreamingCTCPipeline as JaxPipeline
from tone_tpu.runtime.engine import MultiStreamEngine as JaxEngine
from tone_tpu.splitter import StreamingLogprobSplitter as JaxSplitter
from tone_tpu_torch.acoustic import StreamingCTCModel
from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder
from tone_tpu_torch.decoding.lm import ArpaLM
from tone_tpu_torch.pipeline import StreamingCTCPipeline
from tone_tpu_torch.runtime.engine import MultiStreamEngine, UnknownStreamError

N = 2400
BATCH = 4      # final_decode_batch of both engines: small device batches
ALL_BUCKETS = {1 << k for k in range(12)}


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc)
    rng = np.random.default_rng(0)
    letters = list("абвгдеёжзийклмнопрстуфхцчшщъыьэюя")
    words = ["".join(rng.choice(letters, rng.integers(1, 5))) for _ in range(40)]
    sents = [[words[i] for i in rng.integers(0, 40, rng.integers(1, 6))] for _ in range(200)]
    tables = estimate_ngram_lm(sents, order=3)
    return jc, tc, jv, tv, tables


def _decoders(tables, **kw):
    kw = {"beam_width": 8, "nbest": 6, "max_len": 256, **kw}
    lm = tables is not None
    return (JaxDecoder(JaxArpa(tables) if lm else None, **kw),
            DeviceBeamSearchCTCDecoder(ArpaLM(tables) if lm else None, device="cpu", **kw))


def _padded(wav, cfg):
    out = np.pad(wav, (cfg.padding, cfg.padding))
    return np.pad(out, (0, -len(out) % N))


def _phrase(p):
    words = [(w.word, w.start_time, w.end_time, w.confidence) for w in p.words or ()]
    return (p.text, p.start_time, p.end_time, words, list(p.nbest) if p.nbest else None)


def _drive(engine, streams, cfg, setup):
    """Open one stream per audio, apply ``setup(engine, sids)``, feed all
    audio, close, tick until done.  Returns (phrases per stream as tuples,
    interims per tick)."""
    # Skip the lazy warm of the finals ladder that set_stream_hotwords
    # starts on the pool (every frame bucket up to 2048 frames).
    engine._warmed_hotword_buckets.update(ALL_BUCKETS)
    sids = [engine.open_stream() for _ in streams]
    setup(engine, sids)
    for sid, wav in zip(sids, streams):
        padded = _padded(wav, cfg)
        for i in range(len(padded) // N):
            engine.feed(sid, padded[i * N:(i + 1) * N])
        engine.close_stream(sid)
    phrases = {sid: [] for sid in sids}
    interims = []
    for _ in range(max(len(_padded(w, cfg)) for w in streams) // N + 2):
        for sid, futs in engine.tick().items():
            phrases[sid].extend(f.result(timeout=60) for f in futs)
        interims.append({sids.index(s): t for s, t in engine.last_interims.items()})
    return [[_phrase(p) for p in phrases[s]] for s in sids], interims


def assert_phrases_match(got, want):
    assert all(want) and len(got) == len(want)
    for gs, ws in zip(got, want):
        assert [g[:3] for g in gs] == [w[:3] for w in ws]
        for g, w in zip(gs, ws):
            assert [x[:3] for x in g[3]] == [x[:3] for x in w[3]]
            np.testing.assert_allclose([x[3] for x in g[3]], [x[3] for x in w[3]], atol=1e-4)
            assert (g[4] is None) == (w[4] is None)
            if w[4]:
                assert [t for t, _ in g[4]] == [t for t, _ in w[4]]
                np.testing.assert_allclose([s for _, s in g[4]], [s for _, s in w[4]],
                                           atol=1e-4)


def _per_request(engine, sids):
    engine.set_stream_hotwords(sids[1], ["ой", "да нет"], 4.0)
    engine.set_stream_nbest(sids[2], 4)


def _plain(engine, sids):
    pass


@pytest.mark.parametrize("variant", ["lm_per_request", "decoder_hotwords_nbest",
                                     "no_lm_word_times"])
def test_engine_matches_jax_engine(tiny, variant):
    jc, tc, jv, tv, tables = tiny
    streams = [audio(N * 6, seed=30), audio(N * 8, seed=31), audio(N * 5, seed=32)]
    opts = dict(n_slots=4, final_decode_batch=BATCH, interim_device_beam=True,
                word_timestamps=True)
    setup = _per_request
    if variant == "lm_per_request":
        jdec, tdec = _decoders(tables)
    elif variant == "decoder_hotwords_nbest":
        jdec, tdec = _decoders(tables, hotwords=["ой", "ты"], hotword_weight=3.0)
        opts.update(nbest=3, word_timestamps=False)
        setup = _plain
    else:
        jdec, tdec = _decoders(None)
        opts.update(interim_device_beam=False, interim_transcripts=True)
    jeng = JaxEngine(jv, jc, decoder=jdec, **opts)
    teng = MultiStreamEngine(tv, tc, decoder=tdec, device="cpu", **opts)
    try:
        want, jinterims = _drive(jeng, streams, jc, setup)
        got, tinterims = _drive(teng, streams, tc, setup)
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert_phrases_match(got, want)
    assert tinterims == jinterims and any(jinterims)
    flat = [p for ps in got for p in ps]
    assert any(p[3] for p in flat) == opts["word_timestamps"]
    if variant != "no_lm_word_times":
        assert any(p[4] for p in flat)
        assert all(p[4][0][0] == p[0] for p in flat if p[4])
    # the engine decodes with its own copy of the decoder
    assert teng.decoder is not tdec and (tdec.batch_floor, tdec.max_batch) == (1, None)
    assert teng.decoder.batch_floor == teng.decoder.max_batch == BATCH


def test_per_request_options_on_streams(tiny):
    _, tc, _, tv, tables = tiny
    _, tdec = _decoders(tables)
    eng = MultiStreamEngine(tv, tc, n_slots=2, decoder=tdec, device="cpu",
                            final_decode_batch=BATCH)
    try:
        eng._warmed_hotword_buckets.update(ALL_BUCKETS)
        sid = eng.open_stream()
        eng.set_stream_hotwords(sid, ["мир"], 2.0)
        stream = eng._streams[sid]
        assert stream.decoder is None and stream.hotword_tables is not None
        assert stream.hotwords == (("мир",), 2.0)
        eng.set_stream_hotwords(sid, [])
        assert stream.hotword_tables is None and stream.hotwords is None
        eng.set_stream_nbest(sid, 4)
        assert stream.nbest == 4
        eng.set_stream_nbest(sid, 1)
        assert stream.nbest == 0
        with pytest.raises(ValueError, match="0..32"):
            eng.set_stream_nbest(sid, 99)
        with pytest.raises(UnknownStreamError):
            eng.set_stream_hotwords(12345, ["мир"])
        with pytest.raises(UnknownStreamError):
            eng.set_stream_nbest(12345, 2)
    finally:
        eng.shutdown()


def test_oversized_hotword_list_gets_its_own_decoder(tiny):
    """Past MAX_STACKED_HOTWORD_BYTES a request gets a per-stream device
    decoder (per-phrase decodes) that gives the stacked path's texts."""
    _, tc, _, tv, tables = tiny
    wav = audio(N * 6, seed=33)
    out, overrides = {}, {}

    def setup(engine, sids):
        engine.set_stream_hotwords(sids[0], ["ой да"], 5.0)
        overrides[engine.MAX_STACKED_HOTWORD_BYTES] = engine._streams[sids[0]].decoder

    for cap in (MultiStreamEngine.MAX_STACKED_HOTWORD_BYTES, 0):
        _, tdec = _decoders(tables)
        eng = MultiStreamEngine(tv, tc, n_slots=2, decoder=tdec, device="cpu",
                                final_decode_batch=BATCH)
        eng.MAX_STACKED_HOTWORD_BYTES = cap
        try:
            out[cap], _ = _drive(eng, [wav], tc, setup)
        finally:
            eng.shutdown()
    assert overrides[MultiStreamEngine.MAX_STACKED_HOTWORD_BYTES] is None
    assert isinstance(overrides[0], DeviceBeamSearchCTCDecoder)
    assert overrides[0].hotword_tables is not None
    assert out[0] == out[MultiStreamEngine.MAX_STACKED_HOTWORD_BYTES] and out[0][0]


def test_suspend_resume_carries_nbest_and_hotwords(tiny):
    _, tc, _, tv, tables = tiny
    _, tdec = _decoders(tables)
    wav = _padded(audio(N * 6, seed=34), tc)
    chunks = [wav[i * N:(i + 1) * N] for i in range(len(wav) // N)]
    eng = MultiStreamEngine(tv, tc, n_slots=2, decoder=tdec, device="cpu",
                            final_decode_batch=BATCH, interim_device_beam=True)
    try:
        eng._warmed_hotword_buckets.update(ALL_BUCKETS)
        sid = eng.open_stream()
        eng.set_stream_nbest(sid, 3)
        eng.set_stream_hotwords(sid, ["ой"], 2.0)
        futures = []
        for i, chunk in enumerate(chunks):
            eng.feed(sid, chunk, is_last=i == len(chunks) - 1)
            for futs in eng.tick().values():
                futures.extend(futs)
            if i == 2:
                snap = eng.suspend_stream(sid)
                assert snap["nbest"] == 3 and snap["hotwords"] == (("ой",), 2.0)
                sid = eng.resume_stream(snap)
                assert eng._streams[sid].nbest == 3
                assert eng._streams[sid].hotword_tables is not None
                assert eng._beam_force_reset[eng._streams[sid].slot]
        for futs in eng.tick().values():
            futures.extend(futs)
        phrases = [f.result(timeout=60) for f in futures]
    finally:
        eng.shutdown()
    assert phrases and all(p.nbest and p.nbest[0][0] == p.text for p in phrases)


def test_greedy_engine_refuses_hotwords(tiny):
    """A greedy engine serves request hotwords with a host beam decoder of
    the stream's own (as the JAX engine does), also after a resume; an
    empty list clears it."""
    from tone_tpu_torch.decoder import BeamSearchCTCDecoder

    _, tc, _, tv, _ = tiny
    eng = MultiStreamEngine(tv, tc, n_slots=2, device="cpu")
    try:
        sid = eng.open_stream()
        eng.set_stream_hotwords(sid, ["да"])
        over = eng._streams[sid].decoder
        assert isinstance(over, BeamSearchCTCDecoder) and over._hotwords is not None
        eng.set_stream_hotwords(sid, [])  # clearing is fine
        assert eng._streams[sid].decoder is None
        eng.set_stream_hotwords(sid, ["да"], 2.0)
        eng.feed(sid, np.zeros(N, np.int16))
        eng.tick()
        sid = eng.resume_stream(eng.suspend_stream(sid))
        assert isinstance(eng._streams[sid].decoder, BeamSearchCTCDecoder)
        assert eng._streams[sid].hotwords == (("да",), 2.0)
    finally:
        eng.shutdown()


def test_warmup_runs_every_decode_bucket(tiny):
    """warmup() runs the finals call at every frame bucket (64 … 2048) and
    for each hotword warmup bucket, and the interim arena once."""
    _, tc, _, tv, _ = tiny
    _, tdec = _decoders(None, max_len=2048)
    tdec.beam_width = 2
    eng = MultiStreamEngine(tv, tc, n_slots=2, decoder=tdec, device="cpu", final_decode_batch=1,
                            interim_device_beam=True, interim_beam_width=2,
                            hotword_warmup_buckets=(8,))
    seen = []
    real = eng.decoder._decode_bucket

    def spy(lps, t_pad, n=1, rows=None):
        seen.append((t_pad, rows is not None))
        return real(lps, t_pad, n, rows)

    eng.decoder._decode_bucket = spy
    try:
        eng.warmup()
    finally:
        eng.shutdown()
    ladder = [64, 128, 256, 512, 1024, 2048]
    assert seen == [(t, False) for t in ladder] + [(t, True) for t in ladder]
    assert eng._warmed_hotword_buckets == {8}
    assert eng._device_beams is not None


@pytest.mark.parametrize("options", [{"word_timestamps": True, "nbest": 3},
                                     {"word_timestamps": False, "nbest": 0}])
def test_pipeline_matches_jax_pipeline(tiny, options):
    jc, tc, jv, tv, tables = tiny
    wav = audio(N * 7 + 500, seed=35)
    jdec, tdec = _decoders(tables)
    jpipe = JaxPipeline(JaxModel(jv, jc), JaxSplitter(), jdec, **options)
    tpipe = StreamingCTCPipeline(StreamingCTCModel(tv, tc, device="cpu"), decoder=tdec,
                                 **options)
    want = [_phrase(p) for p in jpipe.forward_offline(wav)]
    got = [_phrase(p) for p in tpipe.forward_offline(wav)]
    assert_phrases_match([got], [want])
    assert all(bool(p[3]) == (options["word_timestamps"] and bool(p[0])) for p in got)


def test_pipeline_option_checks(tiny):
    _, tc, _, tv, _ = tiny
    model = StreamingCTCModel(tv, tc, device="cpu")
    with pytest.raises(ValueError, match="ambiguous"):
        StreamingCTCPipeline(model, nbest=1)
    with pytest.raises(ValueError, match="beam decoder"):
        StreamingCTCPipeline(model, nbest=2)


def test_cli_serve_builds_a_device_beam_engine(tmp_path):
    """``serve --decoder device-beam --lm ... --device cpu`` builds the
    engine with every option, and so do ``--fused-lm``, ``--decoder beam``
    and ``--interim-beam``."""
    from tone_tpu_torch.__main__ import build_engine, build_parser
    from tone_tpu_torch.decoder import BeamSearchCTCDecoder
    from tone_tpu_torch.decoding.estimate import estimate_ngram_lm as est
    from tone_tpu_torch.decoding.estimate import write_arpa

    write_arpa(est([["да", "нет"], ["нет"]], order=2), tmp_path / "lm.arpa")
    args = build_parser().parse_args(
        ["serve", "--decoder", "device-beam", "--lm", str(tmp_path / "lm.arpa"),
         "--hotwords", "да,нет", "--nbest", "2", "--word-times", "--interim-device-beam",
         "--interim-beam-width", "4", "--beam-width", "16", "--hotword-warmup-buckets",
         "--slots", "2", "--device", "cpu"])
    engine = build_engine(args)
    try:
        dec = engine.decoder
        assert isinstance(dec, DeviceBeamSearchCTCDecoder) and dec.beam_width == 16
        assert dec.hotword_tables is not None and dec._lm is not None
        assert (engine.default_nbest, engine.word_timestamps) == (2, True)
        assert engine.interim_device_beam and engine._device_beam_width == 4
        assert engine._hotword_warmup_buckets == ()
    finally:
        engine.shutdown()
    lm = str(tmp_path / "lm.arpa")
    for flags, check in (
            (["--decoder", "device-beam", "--lm", lm, "--fused-lm"],
             lambda e: e.decoder.fusion and e.device_finals),
            (["--decoder", "beam"],
             lambda e: isinstance(e.decoder, BeamSearchCTCDecoder) and not e.interim_beam),
            (["--decoder", "beam", "--lm", lm, "--interim-beam"],
             lambda e: e.interim_beam and e.decoder._native_lm is not None),
            (["--interim-beam"],   # greedy has no carried search: greedy interims
             lambda e: not e.interim_beam and e.interim_transcripts)):
        engine = build_engine(build_parser().parse_args(
            ["serve", "--device", "cpu", "--slots", "1", *flags]))
        try:
            assert check(engine), flags
        finally:
            engine.shutdown()


def test_websocket_transcripts_carry_words_and_nbest(tiny):
    websockets = pytest.importorskip("websockets")
    from tone_tpu_torch.runtime.server import TranscriptionServer

    _, tc, _, tv, tables = tiny
    wav = audio(N * 5, seed=36).astype(np.int16)
    _, tdec = _decoders(tables)

    async def client(port):
        events = []
        async with websockets.connect(f"ws://127.0.0.1:{port}/api/ws") as ws:
            assert json.loads(await ws.recv())["event"] == "ready"
            await ws.send(json.dumps({"nbest": 3, "hotwords": ["ой"]}))
            events.append(json.loads(await ws.recv()))
            await ws.send(wav.astype("<i2").tobytes())
            await ws.send(b"")
            try:
                while True:
                    events.append(json.loads(await asyncio.wait_for(ws.recv(), 60)))
            except websockets.ConnectionClosed:
                pass
        return events

    async def main():
        engine = MultiStreamEngine(tv, tc, n_slots=2, decoder=tdec, device="cpu",
                                   final_decode_batch=BATCH, word_timestamps=True)
        engine._warmed_hotword_buckets.update(ALL_BUCKETS)
        server = TranscriptionServer(engine, tick_seconds=0.01)
        tick = asyncio.create_task(server.tick_loop())
        try:
            async with websockets.serve(server.handle, "127.0.0.1", 0) as ws_server:
                return await client(ws_server.sockets[0].getsockname()[1])
        finally:
            tick.cancel()
            engine.shutdown()

    events = asyncio.run(main())
    assert events[0] == {"event": "config", "hotwords": 1, "nbest": 3}
    transcripts = [e for e in events[1:] if e["event"] == "transcript"]
    assert transcripts
    for e in transcripts:
        assert e["nbest"][0]["text"] == e["text"] and len(e["nbest"]) <= 3
        if e["text"]:
            assert [w["word"] for w in e["words"]] == e["text"].split()
