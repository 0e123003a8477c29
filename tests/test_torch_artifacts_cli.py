"""Loading models and the deployment CLI of the port against the JAX
package: ``StreamingCTCModel.from_local`` on every artifact format,
``StreamingCTCPipeline.from_local``, the ``--checkpoint`` /
``$TONE_TPU_MODEL_DIR`` / ``--chunk-ms`` model flags, the ``lm`` and
``export`` subcommands, and the browser page of the server."""

import asyncio
import json
import re
import sys
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tone_tpu.__main__ as JMAIN
import tone_tpu.acoustic as JA
import tone_tpu.checkpoint as JC
import tone_tpu.interop as JI
import tone_tpu.pipeline as JP
import tone_tpu_torch.checkpoint as TC
import tone_tpu_torch.interop as TI
from test_torch_common import ARTIFACT_ENCODER, audio, tiny_configs, tiny_variables
from test_torch_onnx_import import onnx_from_state_dict
from tone_tpu_torch import __main__ as TMAIN
from tone_tpu_torch.acoustic import StreamingCTCModel
from tone_tpu_torch.decoder import DecoderType, GreedyCTCDecoder
from tone_tpu_torch.pipeline import StreamingCTCPipeline

FORMATS = ["directory", "safetensors", "safetensors_tone_prefix", "bin", "onnx"]
TOL = {"float32": 1e-4, "bfloat16": 0.05}  # bf16: the stated B1 gate departure (ROADMAP §C)


def _artifacts(tmp: Path, fmt: str, jc, tc, jv, tv) -> tuple[Path, Path]:
    """(JAX's artifact, the port's artifact) of the same weights: one file
    both read, or each package's checkpoint directory."""
    jnp_vars = jax.tree.map(np.asarray, jv)
    if fmt == "directory":
        JC.save_checkpoint(tmp / "jax_model", jv, jc)
        TC.save_checkpoint(tmp / "port_model", tv, tc)
        return tmp / "jax_model", tmp / "port_model"
    if fmt.startswith("safetensors"):
        path = tmp / "model.safetensors"
        TI.save_torch_checkpoint(path, tv, tc, prefix="tone." if "prefix" in fmt else "")
    elif fmt == "bin":
        path = tmp / "model.bin"
        torch.save(TI.to_torch_state_dict(tv, tc), path)
    else:
        path = tmp / "model.onnx"
        path.write_bytes(onnx_from_state_dict(JI.to_torch_state_dict(jnp_vars, jc)))
    return path, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_from_local_matches_jax(tmp_path, fmt, dtype):
    """Both packages' ``from_local`` on the same artifact give step logprobs
    within 1e-4 (float32) or 0.05 (bf16); a lossless artifact gives the port
    the directly built model to the bit."""
    jc, tc = tiny_configs(dtype, ARTIFACT_ENCODER)
    jv, tv = tiny_variables(jc, tc, seed=9)
    jax_path, port_path = _artifacts(tmp_path, fmt, jc, tc, jv, tv)
    directory = fmt == "directory"
    jm = JA.StreamingCTCModel.from_local(jax_path, config=None if directory else jc)
    tm = StreamingCTCModel.from_local(port_path, config=None if directory else tc,
                                      device="cpu")
    assert tm.config == tc and tm.device.type == "cpu"
    direct = StreamingCTCModel(tv, tc, device="cpu")
    js, ts, ds = None, None, None
    for chunk in np.split(audio(tc.audio_chunk_samples * 2, batch=2, seed=3), 2, axis=1):
        jlp, js = jm.forward_native(chunk, js)
        tlp, ts = tm.forward_native(chunk, ts)
        dlp, ds = direct.forward_native(chunk, ds)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=TOL[dtype], rtol=0)
        if fmt != "onnx":  # the ONNX file holds some weights in fp16 and bf16
            torch.testing.assert_close(tlp, dlp, rtol=0, atol=0)


def test_from_local_needs_the_network_for_the_hub(tmp_path, monkeypatch):
    """The Hub entry points fetch through ``$HF_ENDPOINT``: one that cannot
    be reached, with an empty cache, raises naming the endpoint and the file
    (tests/test_torch_hub.py holds them to the JAX package's)."""
    from test_torch_common import dead_endpoint

    from tone_tpu_torch.dev.local_hub import hub_env
    from tone_tpu_torch.hub import HubError

    dead = dead_endpoint()
    with hub_env(HF_ENDPOINT=dead, HF_HOME=tmp_path / "hf"):
        with pytest.raises(HubError, match=re.escape(f"model.onnx at main from {dead}")):
            StreamingCTCModel.from_hugging_face(device="cpu")
        with pytest.raises(HubError, match=re.escape(dead)):
            StreamingCTCPipeline.download_from_hugging_face(tmp_path)
    assert list(tmp_path.iterdir()) == []   # neither a cache nor a copied file


def _corpus(path: Path, seed: int = 0, lines: int = 300) -> Path:
    words = "да нет привет спасибо пожалуйста хорошо алло слушаю вас завтра утром".split()
    rng = np.random.default_rng(seed)
    path.write_text("\n".join(" ".join(rng.choice(words, rng.integers(2, 7)))
                              for _ in range(lines)) + "\n", encoding="utf-8")
    return path


@pytest.mark.parametrize("decoder_type", ["greedy", "beam_search"])
def test_pipeline_from_local_matches_jax(tmp_path, decoder_type):
    """The candidate files (model.safetensors, lm.arpa) give the JAX
    pipeline's phrases."""
    jc, tc = tiny_configs("float32", ARTIFACT_ENCODER)
    jv, tv = tiny_variables(jc, tc, seed=10)
    TI.save_torch_checkpoint(tmp_path / "model.safetensors", tv, tc)
    TMAIN.main(["lm", str(_corpus(tmp_path / "corpus.txt")), str(tmp_path / "lm.arpa")])
    jpipe = JP.StreamingCTCPipeline.from_local(
        tmp_path, decoder_type=JP.DecoderType(decoder_type), config=jc)
    tpipe = StreamingCTCPipeline.from_local(
        tmp_path, decoder_type=DecoderType(decoder_type), config=tc, device="cpu")
    assert tpipe.model.config == tc
    if decoder_type == "beam_search":
        assert tpipe.decoder._lm is not None
    wav = audio(tc.audio_chunk_samples * 6, seed=4)
    got = [(p.text, p.start_time, p.end_time) for p in tpipe.forward_offline(wav)]
    assert got == [(p.text, p.start_time, p.end_time) for p in jpipe.forward_offline(wav)]
    with pytest.raises(FileNotFoundError):
        StreamingCTCPipeline.from_local(tmp_path / "corpus.txt", device="cpu")


def _jax_cli(monkeypatch, capsys, argv) -> str:
    monkeypatch.setattr(sys, "argv", ["tone_tpu", *argv])
    JMAIN.main()
    return capsys.readouterr().out


def _port_cli(capsys, argv) -> str:
    TMAIN.main(argv)
    return capsys.readouterr().out


LM_OUTPUTS = {"arpa": ("lm.arpa", []), "arpa_gz": ("lm.arpa.gz", []),
              "probing": ("lm.bin", []), "trie": ("lm.trie", ["--binary", "trie"]),
              "trie_quant": ("lm.trie", ["--binary", "trie", "--quant", "8", "8",
                                         "--bhiksha", "6"])}


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("kind", list(LM_OUTPUTS))
def test_cli_lm_byte_equal_to_jax(tmp_path, monkeypatch, capsys, kind, native):
    corpus = _corpus(tmp_path / "corpus.txt")
    held_out = _corpus(tmp_path / "held_out.txt", seed=1, lines=20)
    name, flags = LM_OUTPUTS[kind]
    flags = [*flags, "--order", "3", "--ppl", str(held_out), *(["--native"] if native else [])]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_out = _jax_cli(monkeypatch, capsys, ["lm", str(corpus), str(tmp_path / "jax" / name),
                                             *flags])
    port_out = _port_cli(capsys, ["lm", str(corpus), str(tmp_path / "port" / name), *flags])
    jax_report, port_report = json.loads(jax_out), json.loads(port_out)
    assert port_report.pop("out").endswith(f"port/{name}")
    assert jax_report.pop("out").endswith(f"jax/{name}")
    assert port_report == jax_report and "ppl" in port_report
    if name.endswith(".gz"):  # gzip stamps the file name and time: compare the text
        import gzip

        assert (gzip.decompress((tmp_path / "port" / name).read_bytes())
                == gzip.decompress((tmp_path / "jax" / name).read_bytes()))
    else:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_cli_lm_native_arpa_without_ppl(tmp_path, monkeypatch, capsys):
    """The native estimator writes the ARPA itself; the counts come from its
    header, as in the JAX CLI."""
    corpus = _corpus(tmp_path / "corpus.txt", seed=2)
    jax_out = _jax_cli(monkeypatch, capsys, ["lm", str(corpus), str(tmp_path / "j.arpa"),
                                             "--native", "--prune", "0", "1"])
    port_out = _port_cli(capsys, ["lm", str(corpus), str(tmp_path / "t.arpa"), "--native",
                                  "--prune", "0", "1"])
    assert json.loads(port_out)["ngrams"] == json.loads(jax_out)["ngrams"]
    assert (tmp_path / "t.arpa").read_bytes() == (tmp_path / "j.arpa").read_bytes()


def test_cli_lm_argument_errors_before_counting(tmp_path):
    with pytest.raises(SystemExit, match="--quant/--bhiksha"):
        TMAIN.main(["lm", str(tmp_path / "no_corpus.txt"), str(tmp_path / "lm.arpa"),
                    "--quant", "8", "8"])


def _write_wav(path: Path, samples: np.ndarray) -> Path:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(samples.astype("<i2").tobytes())
    return path


@pytest.fixture
def tiny_dirs(tmp_path):
    """(JAX orbax dir, port dir, wav) of the same tiny float32 weights."""
    jc, tc = tiny_configs("float32", ARTIFACT_ENCODER)
    jv, tv = tiny_variables(jc, tc, seed=11)
    JC.save_checkpoint(tmp_path / "jax_model", jv, jc)
    TC.save_checkpoint(tmp_path / "port_model", tv, tc)
    wav = _write_wav(tmp_path / "a.wav", audio(12000, seed=5))
    return tmp_path / "jax_model", tmp_path / "port_model", wav


@pytest.mark.parametrize("source", ["flag", "env"])
def test_cli_transcribe_checkpoint(tiny_dirs, capsys, monkeypatch, source):
    """``--checkpoint`` (or ``$TONE_TPU_MODEL_DIR``) serves the checkpoint's
    model: the CLI's phrases are the pipeline's on the same weights."""
    _, port_dir, wav = tiny_dirs
    args = ["transcribe", str(wav), "--json", "--device", "cpu"]
    if source == "flag":
        args += ["--checkpoint", str(port_dir)]
    else:
        monkeypatch.setenv("TONE_TPU_MODEL_DIR", str(port_dir))
    out = _port_cli(capsys, args)
    assert "RANDOM" not in out
    (record,) = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    pipe = StreamingCTCPipeline(StreamingCTCModel.from_local(port_dir, device="cpu"),
                                decoder=GreedyCTCDecoder())
    from tone_tpu_torch.audio import read_audio

    want = [{"text": p.text, "start_time": p.start_time, "end_time": p.end_time}
            for p in pipe.forward_offline(read_audio(wav))]
    assert record["phrases"] == want


def test_cli_chunk_ms_matches_jax(tiny_dirs, capsys, monkeypatch):
    """``--chunk-ms 200`` over the same weights: the JAX CLI's phrases."""
    jax_dir, port_dir, wav = tiny_dirs
    flags = ["--chunk-ms", "200", "--json"]
    jax_out = _jax_cli(monkeypatch, capsys, ["transcribe", str(wav), "--checkpoint",
                                             str(jax_dir), *flags])
    port_out = _port_cli(capsys, ["transcribe", str(wav), "--checkpoint", str(port_dir),
                                  *flags, "--device", "cpu"])
    records = [[json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
               for out in (jax_out, port_out)]
    assert records[1] == records[0] and records[1][0]["phrases"]
    args = TMAIN.build_parser().parse_args(["transcribe", "x", "--chunk-ms", "200",
                                            "--checkpoint", str(port_dir), "--device", "cpu"])
    _, config, _ = TMAIN.build_model(args)
    assert config.audio_chunk_samples == 1600


def test_cli_export_writes_its_files(tiny_dirs, tmp_path, capsys):
    _, port_dir, _ = tiny_dirs
    out = _port_cli(capsys, ["export", str(tmp_path / "out"), "--batch-sizes", "2",
                             "--nemo", "--checkpoint", str(port_dir), "--device", "cpu"])
    assert out.split() == [str(tmp_path / "out" / "streaming_b2.pt2"),
                           str(tmp_path / "out" / "model.nemo")]
    assert json.loads((tmp_path / "out" / "export_config.json").read_text())["batch_sizes"] == [2]
    variables, config = JI.load_nemo_archive(tmp_path / "out" / "model.nemo")
    port_vars, _ = TC.load_checkpoint(port_dir)
    from test_torch_common import assert_trees_equal

    assert_trees_equal(variables, port_vars)
    assert config.encoder.n_layers == ARTIFACT_ENCODER["n_layers"]


def test_compile_cache_flag_builds_there(tiny_dirs, tmp_path, capsys, monkeypatch):
    """``--compile-cache`` points the build directory at the given path (an
    unusable one warns and keeps the default)."""
    from tone_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    args = TMAIN.build_parser().parse_args(
        ["transcribe", "x", "--compile-cache", str(tmp_path / "cache"), "--device", "cpu"])
    TMAIN.build_model(args)
    assert _build.BUILD_DIR == (tmp_path / "cache").resolve()
    monkeypatch.setenv("TONE_TPU_COMPILE_CACHE", str(tmp_path / "env_cache"))
    assert TMAIN.build_parser().parse_args(["transcribe", "x"]).compile_cache == \
        tmp_path / "env_cache"


def test_browser_page_and_websocket(tmp_path):
    """``GET /`` returns the JAX package's page, another path 404, and the
    websocket upgrade still reaches the transcription handler."""
    websockets = pytest.importorskip("websockets")
    from tone_tpu_torch.runtime.engine import MultiStreamEngine
    from tone_tpu_torch.runtime.server import TranscriptionServer, _static_page_handler

    jc, tc = tiny_configs("float32", ARTIFACT_ENCODER)
    _, tv = tiny_variables(jc, tc, seed=12)
    page = (Path(JMAIN.__file__).parent / "runtime" / "static" / "index.html").read_bytes()

    async def http_get(port, path):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"GET {path} HTTP/1.1\r\nHost: localhost\r\n\r\n".encode())
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        length = int(next(ln.split(b":")[1] for ln in head.split(b"\r\n")
                          if ln.lower().startswith(b"content-length")))
        body = await reader.readexactly(length)
        writer.close()
        return int(head.split()[1]), body

    async def main():
        engine = MultiStreamEngine(tv, tc, n_slots=2, device="cpu")
        server = TranscriptionServer(engine, tick_seconds=0.01)
        tick = asyncio.create_task(server.tick_loop())
        try:
            async with websockets.serve(server.handle, "127.0.0.1", 0,
                                        process_request=_static_page_handler()) as ws_server:
                port = ws_server.sockets[0].getsockname()[1]
                results = [await http_get(port, "/"), await http_get(port, "/index.html"),
                           await http_get(port, "/nope")]
                async with websockets.connect(f"ws://127.0.0.1:{port}/api/ws") as ws:
                    results.append(json.loads(await ws.recv()))
                return results
        finally:
            tick.cancel()
            engine.shutdown()

    root, index, missing, ready = asyncio.run(main())
    assert root == (200, page) and index == (200, page)
    assert missing == (404, b"")
    assert ready["event"] == "ready"
