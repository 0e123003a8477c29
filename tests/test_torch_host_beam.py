"""The port's host beam decoder (tone_tpu_torch/decoding/beam.py, the C++
decoder of tone_tpu_torch/decoding/native, ``BeamSearchCTCDecoder``) and
the engine's host-decoder half (``interim_beam``, per-request hotwords on a
host or greedy engine) against the JAX package on the CPU.

The same seeded logprobs, LMs (estimated and written by the JAX package)
and audio go through both: texts are equal, scores within 1e-4, the
streaming search equals the batch search, the native search equals the
Python one, and the port's engine gives the JAX engine's finals, phrase
times and interim texts.  The port builds its own native library from its
own copy of the source, under tone_tpu_torch/.
"""

from __future__ import annotations

from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
from test_torch_common import audio, tiny_configs, tiny_variables

from tone_tpu.config import BLANK_ID, LABELS
from tone_tpu.decoder import BeamSearchCTCDecoder as JaxDecoder
from tone_tpu.decoding import beam as JB
from tone_tpu.decoding import estimate as JE
from tone_tpu.decoding import hotwords as JH
from tone_tpu.decoding import kenlm_binary as JKB
from tone_tpu.decoding import kenlm_trie as JKT
from tone_tpu.decoding import lm as JLM
from tone_tpu_torch.decoder import BeamSearchCTCDecoder, DecoderType, build_decoder
from tone_tpu_torch.decoding import beam as TB
from tone_tpu_torch.decoding import hotwords as TH
from tone_tpu_torch.decoding import lm as TLM
from tone_tpu_torch.decoding.native import beamsearch as NB

REPO = Path(__file__).resolve().parent.parent
V = len(LABELS) + 1
N = 2400
WORDS = ["да", "нет", "мир", "привет", "вот", "так", "ёж", "я", "она", "был"]
HOTWORDS = ["вот так", "ёж"]


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    rng = np.random.default_rng(0)
    sents = [[WORDS[i] for i in rng.integers(0, len(WORDS), rng.integers(1, 7))]
             for _ in range(300)]
    tables = JE.estimate_ngram_lm(sents, order=3)
    d = tmp_path_factory.mktemp("lms")
    files = {"arpa": d / "lm.arpa", "probing": d / "lm.bin", "trie": d / "trie.bin"}
    JE.write_arpa(tables, files["arpa"])
    JKB.write_kenlm_binary(tables, files["probing"])
    JKT.write_kenlm_trie(tables, files["trie"])
    return tables, files


def _logprobs(seed, t=50, words=True):
    """Blank-heavy frames that spell words of the LM, with noise."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, (t, V))
    logits[:, BLANK_ID] += 2.5
    if words:
        text = " ".join(rng.choice(WORDS, 3))
        for i, ch in enumerate(text[: t // 2 - 1]):
            logits[1 + 2 * i, LABELS.index(ch)] += 5.0
    x = logits - logits.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def test_native_library_is_the_ports_own():
    assert NB.build_native() and NB.native_available()
    lib = NB.library_path().resolve()
    assert lib.is_relative_to(REPO / "tone_tpu_torch") and lib.exists()
    assert NB._SRC.resolve() == REPO / "tone_tpu_torch/decoding/native/src/tone_decode.cpp"
    assert lib.name != "libtone_decode.so"
    import ctypes

    assert NB._load()._name == str(NB.library_path())
    assert isinstance(NB._load(), ctypes.CDLL)


@pytest.mark.parametrize("variant", ["no_lm", "lm", "hotwords", "lm_hotwords"])
@pytest.mark.parametrize("seed", [0, 1])
def test_python_search_matches_jax(lm_files, variant, seed):
    tables, _ = lm_files
    lp = _logprobs(seed).astype(np.float64)
    use_lm, use_hw = "lm" in variant, "hotwords" in variant
    kw = dict(beam_width=24)
    want = JB.ctc_beam_search(lp, LABELS, JLM.ArpaLM(tables) if use_lm else None,
                              hotwords=JH.HotwordScorer(HOTWORDS, 4.0) if use_hw else None, **kw)
    got = TB.ctc_beam_search(lp, LABELS, TLM.ArpaLM(tables) if use_lm else None,
                             hotwords=TH.HotwordScorer(HOTWORDS, 4.0) if use_hw else None, **kw)
    assert got == want and got


@pytest.mark.parametrize("lm", ["none", "arpa", "probing"])
@pytest.mark.parametrize("hot", [False, True])
def test_native_search_matches_jax_and_python(lm_files, lm, hot):
    tables, files = lm_files
    py_lm = TLM.load_lm(files[lm]) if lm != "none" else None
    na_lm = NB.NativeLM(files[lm]) if lm != "none" else None
    j_lm = JLM.load_lm(files[lm]) if lm != "none" else None
    for seed in range(3):
        lp = _logprobs(10 + seed)
        kw = dict(beam_width=32)
        want = JB.ctc_beam_search(lp.astype(np.float64), LABELS, j_lm,
                                  hotwords=JH.HotwordScorer(HOTWORDS) if hot else None, **kw)
        py = TB.ctc_beam_search(lp.astype(np.float64), LABELS, py_lm,
                                hotwords=TH.HotwordScorer(HOTWORDS) if hot else None, **kw)
        na = NB.ctc_beam_search_native(lp, LABELS, na_lm, **kw,
                                       hotwords=NB.NativeHotwords(LABELS, HOTWORDS)
                                       if hot else None)
        assert na == py == want


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("use_lm", [False, True])
def test_streaming_equals_batch(lm_files, native, use_lm):
    """Advancing chunk by chunk gives the batch search exactly; ``result``
    does not disturb the search; ``reset`` restarts it."""
    tables, files = lm_files
    lp = _logprobs(20, t=70)
    if native:
        search = NB.NativeStreamingBeam(LABELS, NB.NativeLM(files["arpa"]) if use_lm else None,
                                        beam_width=16)
        batch = NB.ctc_beam_search_native(lp, LABELS, NB.NativeLM(files["arpa"])
                                          if use_lm else None, beam_width=16)
    else:
        lm = TLM.ArpaLM(tables) if use_lm else None
        search = TB.StreamingBeamSearch(LABELS, lm, beam_width=16)
        batch = TB.ctc_beam_search(lp.astype(np.float64), LABELS, lm, beam_width=16)
    for lo, hi in ((0, 11), (11, 40), (40, 70)):
        search.advance(lp[lo:hi] if native else lp[lo:hi].astype(np.float64))
        search.result()
    assert search.result() == batch
    nbest = search.nbest(4)
    assert nbest[0][0] == batch and len({t for t, _ in nbest}) == len(nbest)
    search.reset()
    search.advance(lp if native else lp.astype(np.float64))
    assert search.result() == batch


@pytest.mark.parametrize("fmt", ["none", "arpa", "probing", "trie"])
def test_decoder_matches_jax(lm_files, fmt):
    """forward, nbest and streaming of BeamSearchCTCDecoder, native (the
    trie binary converted to a probing one for the C++ scorer) and Python."""
    _, files = lm_files
    if fmt == "none":
        jdec, tdec = JaxDecoder(beam_width=32), BeamSearchCTCDecoder(beam_width=32)
    else:
        jdec, tdec = JaxDecoder.from_local(files[fmt]), BeamSearchCTCDecoder.from_local(files[fmt])
        jdec.beam_width = tdec.beam_width = 32
    py = BeamSearchCTCDecoder(tdec._lm, beam_width=32)
    assert tdec._use_native and py._use_native == (fmt == "none")
    py._use_native = False            # the Python search
    for seed in range(2):
        lp = _logprobs(30 + seed)
        assert tdec.forward(lp) == jdec.forward(lp) == py.forward(lp)
        got, want = tdec.nbest(lp, 5), jdec.nbest(lp, 5)
        assert [t for t, _ in got] == [t for t, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-4)
        assert [t for t, _ in py.nbest(lp, 5)] == [t for t, _ in want]
        s = tdec.streaming()
        s.advance(lp[:20])
        s.advance(lp[20:])
        assert s.result() == jdec.forward(lp)
    with pytest.raises(ValueError):
        tdec.forward(lp.astype(np.float64))


@pytest.mark.parametrize("prebuilt", [False, True])
def test_decoder_hotwords_match_jax(lm_files, prebuilt):
    _, files = lm_files
    hw_j = JH.HotwordScorer(HOTWORDS, 6.0) if prebuilt else HOTWORDS
    hw_t = TH.HotwordScorer(HOTWORDS, 6.0) if prebuilt else HOTWORDS
    jdec = JaxDecoder.from_local(files["arpa"], hotwords=hw_j, hotword_weight=6.0)
    tdec = BeamSearchCTCDecoder.from_local(files["arpa"], hotwords=hw_t, hotword_weight=6.0)
    assert tdec._use_native and tdec._native_hotwords is not None
    for seed in range(3):
        lp = _logprobs(40 + seed)
        assert tdec.forward(lp) == jdec.forward(lp)
        assert [t for t, _ in tdec.nbest(lp, 3)] == [t for t, _ in jdec.nbest(lp, 3)]
    with pytest.raises(TypeError):
        BeamSearchCTCDecoder(hotwords="да")
    with pytest.raises(ValueError, match="label set"):
        BeamSearchCTCDecoder(hotwords=["latin"])


def test_build_decoder_beam(lm_files):
    _, files = lm_files
    for kind in ("beam", DecoderType.BEAM_SEARCH):
        dec = build_decoder(kind, lm=files["probing"], beam_width=50,
                            hotwords=["да"], hotword_weight=2.0)
        assert isinstance(dec, BeamSearchCTCDecoder) and dec.beam_width == 50
        assert dec._use_native and dec._native_lm is not None and dec._hotwords is not None
    plain = build_decoder("beam")
    assert plain.beam_width == BeamSearchCTCDecoder.BEAM_WIDTH == 200 and plain._lm is None


# ---------------------------------------------------------------------------
# The engine with host decoders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc)
    return jc, tc, jv, tv


def _padded(wav, cfg):
    out = np.pad(wav, (cfg.padding, cfg.padding))
    return np.pad(out, (0, -len(out) % N))


class _AfterTick:
    """A decode pool that runs what a tick submitted only once the tick has
    returned (``run``), so an interim beam result always surfaces on the
    next tick, however loaded the machine is."""

    def __init__(self) -> None:
        self.pending = []

    def submit(self, fn, *args, **kwargs) -> Future:
        fut = Future()
        self.pending.append((fut, fn, args, kwargs))
        return fut

    def run(self) -> None:
        while self.pending:
            fut, fn, args, kwargs = self.pending.pop(0)
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — handed to the future
                fut.set_exception(e)

    def shutdown(self, wait: bool = True, **_) -> None:
        self.run()


def _drive(engine, streams, cfg, setup):
    """Feed every stream one chunk per tick; the pool's tasks run between
    ticks, so the interims a tick reports are deterministic.  Returns
    (finals per stream, interims per tick)."""
    engine._decode_pool.shutdown()
    engine._decode_pool = pool = _AfterTick()
    sids = [engine.open_stream() for _ in streams]
    setup(engine, sids)
    chunks = [_padded(w, cfg).reshape(-1, N) for w in streams]
    phrases = {sid: [] for sid in sids}
    interims = []
    for i in range(max(len(c) for c in chunks) + 2):
        for sid, c in zip(sids, chunks):
            if i < len(c):
                engine.feed(sid, c[i], is_last=i == len(c) - 1)
        results = engine.tick()
        interims.append({sids.index(s): t for s, t in engine.last_interims.items()})
        pool.run()
        for sid, futs in results.items():
            phrases[sid].extend(f.result(timeout=60) for f in futs)
    return [[(p.text, p.start_time, p.end_time, [t for t, _ in p.nbest] if p.nbest else None)
             for p in phrases[s]] for s in sids], interims


def _per_request(engine, sids):
    engine.set_stream_hotwords(sids[0], ["ой", "да нет"], 4.0)
    engine.set_stream_nbest(sids[1], 3)


@pytest.mark.parametrize("variant", ["host_beam_interim_beam", "greedy_request_hotwords"])
def test_engine_matches_jax_engine(tiny, lm_files, variant):
    """Host-decoder finals per phrase on the pool, LM-quality interims from
    the carried host beam (interim_beam), and per-request hotwords as a
    host beam override: the JAX engine's finals, times and interims."""
    from tone_tpu.runtime.engine import MultiStreamEngine as JaxEngine
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    jc, tc, jv, tv = tiny
    _, files = lm_files
    streams = [audio(N * 6, seed=50), audio(N * 7, seed=51), audio(N * 5, seed=52)]
    if variant == "host_beam_interim_beam":
        jdec = JaxDecoder.from_local(files["arpa"])
        tdec = BeamSearchCTCDecoder.from_local(files["arpa"])
        jdec.beam_width = tdec.beam_width = 24
        opts, setup = dict(n_slots=4, interim_beam=True), _per_request
    else:
        jdec = tdec = None
        opts = dict(n_slots=4, interim_transcripts=True)

        def setup(engine, sids):
            engine.set_stream_hotwords(sids[2], ["ой"], 3.0)

    jeng = JaxEngine(jv, jc, decoder=jdec, **opts)
    teng = MultiStreamEngine(tv, tc, decoder=tdec, device="cpu", **opts)
    try:
        want, jint = _drive(jeng, streams, jc, setup)
        got, tint = _drive(teng, streams, tc, setup)
        assert teng.interim_beam == (variant == "host_beam_interim_beam") == jeng.interim_beam
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert all(want) and got == want
    assert tint == jint and any(jint)
    if variant == "host_beam_interim_beam":
        assert any(p[3] for p in got[1])


def test_greedy_engine_hotword_override_and_resume(tiny):
    """On a greedy engine, request hotwords build a host beam decoder of
    the stream's own; a suspended biased stream resumes with it."""
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    _, tc, _, tv = tiny
    wav = _padded(audio(N * 6, seed=53), tc).reshape(-1, N)
    eng = MultiStreamEngine(tv, tc, n_slots=2, device="cpu")
    try:
        sid = eng.open_stream()
        eng.set_stream_hotwords(sid, ["да"], 3.0)
        over = eng._streams[sid].decoder
        assert isinstance(over, BeamSearchCTCDecoder) and over._hotwords is not None
        assert over.beam_width == BeamSearchCTCDecoder.BEAM_WIDTH and over._use_native
        futures = []
        for i, chunk in enumerate(wav):
            eng.feed(sid, chunk, is_last=i == len(wav) - 1)
            futures += [f for fs in eng.tick().values() for f in fs]
            if i == 2:
                snap = eng.suspend_stream(sid)
                assert snap["hotwords"] == (("да",), 3.0)
                sid = eng.resume_stream(snap)
                assert isinstance(eng._streams[sid].decoder, BeamSearchCTCDecoder)
        futures += [f for fs in eng.tick().values() for f in fs]
        assert [f.result(timeout=60) for f in futures]
        eng.set_stream_hotwords(eng.open_stream(), [])   # clearing is fine
    finally:
        eng.shutdown()


def test_interim_beam_one_task_in_flight(tiny):
    """At most one advance per stream runs on the pool; frames fed meanwhile
    queue and are consumed in order by the next task."""
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    _, tc, _, tv = tiny
    eng = MultiStreamEngine(tv, tc, n_slots=1, device="cpu",
                            decoder=BeamSearchCTCDecoder(beam_width=20), interim_beam=True)
    try:
        sid = eng.open_stream()
        stream = eng._streams[sid]
        lp = _logprobs(60, t=30, words=False)
        stream.beam_frames.append(lp[:10])
        eng._maybe_submit_interim_locked(sid, stream)
        stream.beam_task.result()
        stream.beam_frames += [lp[10:20], lp[20:]]
        eng._maybe_submit_interim_locked(sid, stream)
        stream.beam_task.result()
        assert stream.beam_frames == []
        want = JB.ctc_beam_search(lp.astype(np.float64), LABELS, None, beam_width=20)
        assert stream.beam.result() == want
        with eng._interim_lock:
            assert eng._interim_results[sid] == (stream.beam_gen, want)
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# The CLI: both decoders serve a stream end to end at the full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--decoder", "device-beam", "--fused-lm", "--hotwords", "да", "--nbest", "2"],
    ["--decoder", "beam", "--interim-beam", "--beam-width", "16", "--hotwords", "да"]],
    ids=["fused_lm", "host_beam_interim_beam"])
def test_cli_serve_streams_end_to_end(lm_files, flags):
    """``serve`` builds the engine these flags ask for (random full-width
    weights, on the CPU), and it transcribes a stream to its end."""
    from tone_tpu_torch.__main__ import build_engine, build_parser
    from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder

    _, files = lm_files
    args = build_parser().parse_args(["serve", "--lm", str(files["arpa"]), "--slots", "2",
                                      "--hotword-warmup-buckets", "--device", "cpu", *flags])
    engine = build_engine(args)
    try:
        dec = engine.decoder
        if "--fused-lm" in flags:
            assert isinstance(dec, DeviceBeamSearchCTCDecoder) and dec.fusion
            assert engine.device_finals and engine.default_nbest == 2
        else:
            assert isinstance(dec, BeamSearchCTCDecoder) and dec.beam_width == 16
            assert engine.interim_beam and dec._use_native and dec._native_lm is not None
        sid = engine.open_stream()
        pcm = np.random.default_rng(1).integers(-20000, 20000, 8 * N).astype(np.int16)
        wav = _padded(pcm, engine.config)
        for i in range(len(wav) // N):
            engine.feed(sid, wav[i * N:(i + 1) * N])
        engine.close_stream(sid)
        futures, done = [], []
        for _ in range(len(wav) // N + 2):
            futures += [f for fs in engine.tick().values() for f in fs]
            done += engine.pop_finished()
        phrases = [f.result(timeout=120) for f in futures]
        assert done == [sid] and phrases
        assert all(p.start_time <= p.end_time for p in phrases)
    finally:
        engine.shutdown()
