"""The port's audio I/O (tone_tpu_torch/audio), WER (training/wer.py),
corpus evaluation (eval.py) and the ``transcribe``, ``eval`` and ``align``
subcommands, on the CPU.

The audio modules and the WER are copies of the JAX package's: their
outputs are held equal to its outputs (the example FLACs byte for byte).
``evaluate_pipeline`` gives the JAX package's WER and counts on the same
tiny float32 weights; ``evaluate_server`` runs against the port's own
websocket server.  The subcommands run at the full width on random
weights with ``--device cpu``.
"""

import asyncio
import json
import threading
import wave

import numpy as np
import pytest
from test_torch_common import tiny_configs, tiny_variables

from tone_tpu import audio as jaudio
from tone_tpu.acoustic import StreamingCTCModel as JaxModel
from tone_tpu.audio import examples as jexamples
from tone_tpu.decoder import GreedyCTCDecoder as JaxGreedy
from tone_tpu.eval import evaluate_pipeline as jax_evaluate
from tone_tpu.offline import OfflineTranscriber as JaxTranscriber
from tone_tpu.pipeline import StreamingCTCPipeline as JaxPipeline
from tone_tpu.splitter import StreamingLogprobSplitter as JaxSplitter
from tone_tpu.training.wer import word_error_rate as jax_wer
from tone_tpu_torch import audio as taudio
from tone_tpu_torch.acoustic import StreamingCTCModel
from tone_tpu_torch.audio import examples as texamples
from tone_tpu_torch.audio.flac import decode_flac, read_flac_info
from tone_tpu_torch.audio.flac_write import encode_flac
from tone_tpu_torch.eval import evaluate_pipeline, evaluate_server, read_manifest
from tone_tpu_torch.offline import OfflineTranscriber
from tone_tpu_torch.pipeline import StreamingCTCPipeline
from tone_tpu_torch.training.wer import edit_distance, normalize_text, word_error_rate

EXAMPLES = ("audio_short.flac", "audio_long.flac")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_flacs_equal_jax(name):
    path = texamples.example_path(name)
    assert "tone_tpu_torch" in path.parts  # the port's own examples directory
    assert path.read_bytes() == jexamples.example_path(name).read_bytes()
    info = read_flac_info(path)
    samples, sr = decode_flac(path, verify_crc=True)
    assert sr == 8000 and samples.shape == (info.total_samples, 1)
    np.testing.assert_array_equal(taudio.read_example_audio(long_audio=name == EXAMPLES[1]),
                                  jaudio.read_example_audio(long_audio=name == EXAMPLES[1]))


@pytest.mark.parametrize("channels", [1, 2])
def test_flac_round_trip_and_crc(tmp_path, channels):
    pcm = np.random.default_rng(3).integers(-32768, 32768, (10000, channels)).astype(np.int16)
    encode_flac(tmp_path / "a.flac", pcm, 8000)
    encode_flac(tmp_path / "b.flac", pcm, 8000)
    assert (tmp_path / "a.flac").read_bytes() == (tmp_path / "b.flac").read_bytes()
    decoded, sr = decode_flac(tmp_path / "a.flac", verify_crc=True)
    assert sr == 8000
    np.testing.assert_array_equal(decoded, pcm.astype(np.int64))
    # a flipped byte of the audio fails the frame CRC
    data = bytearray((tmp_path / "a.flac").read_bytes())
    data[-100] ^= 0xFF
    (tmp_path / "bad.flac").write_bytes(bytes(data))
    with pytest.raises(ValueError):
        decode_flac(tmp_path / "bad.flac", verify_crc=True)


def _write_wav(path, data, sr, width=2):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(data.shape[1] if data.ndim == 2 else 1)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


@pytest.mark.parametrize("case", ["mono_8k", "stereo_16k", "u8_11025", "int32_8k"])
def test_read_audio_equals_jax(tmp_path, case):
    """WAV read, mix-down and resampling give the JAX package's samples."""
    rng = np.random.default_rng(0)
    path = tmp_path / f"{case}.wav"
    if case == "mono_8k":
        _write_wav(path, rng.integers(-30000, 30000, 8000).astype(np.int16), 8000)
    elif case == "stereo_16k":
        t = np.arange(16000) / 16000
        tone = (10000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16)
        _write_wav(path, np.stack([tone, tone // 2], axis=1), 16000)
    elif case == "u8_11025":
        _write_wav(path, rng.integers(0, 256, 11025).astype(np.uint8), 11025, width=1)
    else:
        _write_wav(path, rng.integers(-2**30, 2**30, 8000).astype(np.int32), 8000, width=4)
    got, want = taudio.read_audio(path), jaudio.read_audio(path)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk_size", [None, 1000])
def test_read_stream_audio_equals_jax(chunk_size):
    path = texamples.example_path(EXAMPLES[0])
    got = list(taudio.read_stream_audio(path, chunk_size))
    want = list(jaudio.read_stream_audio(path, chunk_size))
    assert len(got) == len(want) and all(c.shape == (chunk_size or 2400,) for c in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    examples = list(taudio.read_stream_example_audio(chunk_size=chunk_size))
    assert len(examples) == len(got)


WER_PAIRS = [
    (["привет мир"], ["привет мир"]),
    (["привет"], ["привет мир"]),
    (["Ёлка зелёная", ""], ["елка зеленая", "да"]),
    (["а б в г", "раз два три"], ["а в г д", "раз три"]),
    ([""], [""]),
    (["лишнее"], [""]),
]


@pytest.mark.parametrize("hyps, refs", WER_PAIRS)
def test_word_error_rate_equals_jax(hyps, refs):
    for normalize in (True, False):
        assert word_error_rate(hyps, refs, normalize) == jax_wer(hyps, refs, normalize)
    assert normalize_text(" Ёж ") == "еж"
    assert edit_distance(["a", "b"], ["b"]) == 1
    with pytest.raises(ValueError):
        word_error_rate(["a"], [])


# ---------------------------------------------------------------------------
# Corpus evaluation.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc, seed=1)
    return jc, tc, jv, tv


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """The two examples and a WAV of the short one's first 2 s."""
    tmp = tmp_path_factory.mktemp("manifest")
    short = taudio.read_example_audio()
    _write_wav(tmp / "head.wav", short[:16000].astype(np.int16), 8000)
    items = [{"audio_filepath": str(texamples.example_path(EXAMPLES[0])), "text": "да нет"},
             {"audio_filepath": str(tmp / "head.wav"), "text": "Ёлка"},
             {"audio_filepath": str(texamples.example_path(EXAMPLES[1])),
              "text": "привет мир как дела"}]
    path = tmp / "manifest.jsonl"
    path.write_text("".join(json.dumps(it, ensure_ascii=False) + "\n\n" for it in items),
                    encoding="utf-8")
    return path


@pytest.mark.parametrize("kind", ["pipeline", "transcriber"])
def test_evaluate_pipeline_equals_jax(tiny, manifest, kind):
    jc, tc, jv, tv = tiny
    if kind == "pipeline":
        ours = StreamingCTCPipeline(StreamingCTCModel(tv, tc, device="cpu"))
        theirs = JaxPipeline(JaxModel(jv, jc), JaxSplitter(), JaxGreedy())
    else:
        ours = OfflineTranscriber(tv, tc, device="cpu")
        theirs = JaxTranscriber(jv, jc)
    assert len(read_manifest(manifest)) == 3
    for limit in (None, 2):
        got, want = evaluate_pipeline(ours, manifest, limit), jax_evaluate(theirs, manifest, limit)
        assert (got.wer, got.n_utterances, got.audio_seconds) == \
            (want.wer, want.n_utterances, want.audio_seconds)
        assert got.rtfx > 0
    # items may carry their audio instead of a path
    items = [{"audio": taudio.read_example_audio(), "text": "да"}]
    assert evaluate_pipeline(ours, items).wer == jax_evaluate(theirs, items).wer


def test_evaluate_server_against_the_ports_server(tiny, manifest):
    websockets = pytest.importorskip("websockets")
    from tone_tpu_torch.runtime.engine import MultiStreamEngine
    from tone_tpu_torch.runtime.server import TranscriptionServer

    _, tc, _, tv = tiny
    engine = MultiStreamEngine(tv, tc, n_slots=4, device="cpu")
    loop = asyncio.new_event_loop()
    started, stop = threading.Event(), asyncio.Event()
    port = []

    async def serve():
        server = TranscriptionServer(engine, tick_seconds=0.01)
        tick = asyncio.create_task(server.tick_loop())
        try:
            async with websockets.serve(server.handle, "127.0.0.1", 0) as ws:
                port.append(ws.sockets[0].getsockname()[1])
                started.set()
                await stop.wait()
        finally:
            tick.cancel()

    thread = threading.Thread(target=loop.run_until_complete, args=(serve(),), daemon=True)
    thread.start()
    try:
        assert started.wait(60)
        result = evaluate_server(f"ws://127.0.0.1:{port[0]}/api/ws", manifest, limit=2,
                                 concurrency=2)
    finally:
        loop.call_soon_threadsafe(stop.set)
        thread.join(60)
        engine.shutdown()
    assert not thread.is_alive()
    local = evaluate_pipeline(StreamingCTCPipeline(StreamingCTCModel(tv, tc, device="cpu")),
                              manifest, limit=2)
    assert (result.n_utterances, result.audio_seconds) == (2, local.audio_seconds)
    assert result.wer == local.wer


# ---------------------------------------------------------------------------
# The subcommands (full width, random weights, --device cpu).
# ---------------------------------------------------------------------------


def _json_lines(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("flags", [[], ["--batch-size", "2", "--word-times"],
                                   ["--batch-size", "2", "--offline-forward"]])
def test_cli_transcribe(tmp_path, capsys, flags):
    from tone_tpu_torch.__main__ import main

    short = taudio.read_example_audio()[:24000]
    files = [tmp_path / "a.flac", tmp_path / "b.wav"]
    encode_flac(files[0], short.astype(np.int16), 8000)
    _write_wav(files[1], short[:12000].astype(np.int16), 8000)
    main(["transcribe", *map(str, files), "--json", "--device", "cpu", *flags])
    records = _json_lines(capsys.readouterr().out)
    assert [r["file"] for r in records] == list(map(str, files))
    for r in records:
        assert r["phrases"]
        for p in r["phrases"]:
            assert 0 <= p["start_time"] <= p["end_time"]
            assert ("words" in p) == ("--word-times" in flags and bool(p["text"].split()))


@pytest.mark.parametrize("argv, error, match", [
    (["transcribe", "x.wav", "--offline-forward"], SystemExit, "--batch-size"),
    (["transcribe", "x.wav", "--batch-size", "2", "--nbest", "2"], SystemExit, "--nbest"),
    (["transcribe", "x.wav", "--batch-size", "2", "--data-parallel"], NotImplementedError, "A14"),
    (["transcribe", "x.wav", "--checkpoint", "m"], NotImplementedError, "A14"),
    (["transcribe", "x.wav", "--nbest", "2"], SystemExit, "beam decoder"),
    (["eval", "m.jsonl", "--server", "ws://x", "--batch-size", "2"], SystemExit, "--server"),
    (["eval", "m.jsonl", "--offline-forward"], SystemExit, "--batch-size"),
    (["eval", "m.jsonl", "--batch-size", "2", "--data-parallel"], NotImplementedError, "A14"),
    (["align", "m.jsonl", "--checkpoint", "m"], NotImplementedError, "A14"),
])
def test_cli_guards(argv, error, match):
    from tone_tpu_torch.__main__ import main

    with pytest.raises(error, match=match):
        main([*argv, "--device", "cpu"])


def test_cli_eval(tmp_path, capsys):
    from tone_tpu_torch.__main__ import main

    short = taudio.read_example_audio()[:16000]
    _write_wav(tmp_path / "a.wav", short.astype(np.int16), 8000)
    manifest = tmp_path / "m.jsonl"
    manifest.write_text(json.dumps({"audio_filepath": str(tmp_path / "a.wav"),
                                    "text": "да"}) + "\n", encoding="utf-8")
    main(["eval", str(manifest), "--batch-size", "2", "--offline-forward", "--device", "cpu"])
    (report,) = _json_lines(capsys.readouterr().out)
    assert report["utterances"] == 1 and report["audio_seconds"] == 2.0
    assert report["wer"] >= 0 and report["rtfx"] > 0


def test_cli_align(tmp_path, capsys):
    from tone_tpu_torch.__main__ import main

    short = taudio.read_example_audio()[:16000]
    _write_wav(tmp_path / "a.wav", short.astype(np.int16), 8000)
    items = [{"audio_filepath": str(tmp_path / "a.wav"), "text": "Да, нет — 42 yes"},
             {"audio": short[:2400].tolist(), "text": " ".join(["абвгд"] * 20)}]
    manifest = tmp_path / "m.jsonl"
    manifest.write_text("".join(json.dumps(it, ensure_ascii=False) + "\n" for it in items),
                        encoding="utf-8")
    out = tmp_path / "words.jsonl"
    main(["align", str(manifest), "--out", str(out), "--batch-size", "2", "--device", "cpu"])
    assert _json_lines(capsys.readouterr().out) == [
        {"out": str(out), "utterances": 1, "failed": 1}]
    ok, failed = [json.loads(ln) for ln in out.read_text(encoding="utf-8").splitlines()]
    assert [w["word"] for w in ok["words"]] == ["Да,", "нет", "—", "42", "yes"]
    for w in ok["words"]:
        timed = w["word"] in ("Да,", "нет")
        assert (w["start_time"] is not None) == timed
        if timed:
            assert 0 <= w["start_time"] <= w["end_time"] and 0 < w["confidence"] <= 1
    assert "cannot align" in failed["error"] and failed["audio_filepath"] is None
    # without --out the records go to stdout
    manifest.write_text(json.dumps(items[0], ensure_ascii=False) + "\n", encoding="utf-8")
    main(["align", str(manifest), "--device", "cpu"])
    (record,) = _json_lines(capsys.readouterr().out)
    assert record["words"] == ok["words"]
