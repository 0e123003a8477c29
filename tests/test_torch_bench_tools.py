"""The port's measurement tools and notebooks (tone_tpu_torch/bench.py,
tone_tpu_torch/dev/{tick_bench,load_test,train_bench,align_bench}.py, the
notebooks under tone_tpu_torch/examples/ and tone_tpu_torch/dev/) against
the JAX package's (bench.py, dev/*.py, examples/*.ipynb) on the CPU.

The JAX scripts are loaded from their files; JAX runs on the CPU devices of
tests/conftest.py.  Small sizes: the tiny float32 model of
tests/test_torch_common.py, but for the bench's first step (the full
``ToneConfig()`` at B = 2, as the bench runs it) and the spawned server of
the shutdown and soak checks (the CLI's full width).  Tolerances:

* the bench's first step: logprobs within 0.05 (bf16, as
  tests/test_torch_model.py holds the bf16 step);
* the splitter's worst case, the tick bench's phrases, ``make_phrases`` and
  the aligners' words, the train bench's batch, ``run_round``'s deliveries:
  equal;
* the train bench's first float32 loss: within 1e-4 relative of JAX's
  ``Trainer`` (tests/test_torch_training.py);
* the 400 ms step the notebooks stream: float32 logprobs within 1e-4
  (tests/test_model_core.py).
"""

import ast
import asyncio
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import jax
import nbformat
import numpy as np
import pytest
import torch
from test_torch_common import audio, tiny_configs, tiny_variables

from tone_tpu.acoustic import StreamingCTCModel as JaxModel
from tone_tpu.core import model as JM
from tone_tpu.core.model import init_model_params as jax_init
from tone_tpu.parallel.mesh import make_mesh
from tone_tpu.runtime.engine import MultiStreamEngine as JaxEngine
from tone_tpu_torch import bench
from tone_tpu_torch.core import model as TM
from tone_tpu_torch.core.jax_random import jax_init_model_params
from tone_tpu_torch.dev import align_bench, load_test, tick_bench, train_bench
from tone_tpu_torch.runtime.engine import MultiStreamEngine

REPO = Path(__file__).resolve().parent.parent
NOTEBOOKS = [REPO / "tone_tpu_torch/examples/finetune_example.ipynb",
             REPO / "tone_tpu_torch/examples/serving_request_example.ipynb",
             REPO / "tone_tpu_torch/examples/research_400ms.ipynb",
             REPO / "tone_tpu_torch/dev/research_400ms.ipynb"]


def _jax_script(relpath: str):
    """A JAX tool loaded from its file (they are scripts, not a package)."""
    name = "jax_tool_" + relpath.replace("/", "_").removesuffix(".py")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, REPO / relpath)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[name] = module
    return sys.modules[name]


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc)
    return jc, tc, jv, tv


# -- bench.py ---------------------------------------------------------------


def test_bench_first_step_matches_jax():
    """The bench's model (full width, bf16, the JAX bench's PRNGKey(0)
    weights drawn in numpy) gives JAX's first step at B = 2."""
    import tone_tpu.config as jcfg

    jbench = _jax_script("bench.py")
    assert (bench.BASELINE_RTFX, bench.CHUNK_SECONDS) == (jbench.BASELINE_RTFX,
                                                          jbench.CHUNK_SECONDS)
    chunk = audio(2400, 2, seed=5)
    jmodel = JaxModel(jax_init(jax.random.PRNGKey(0), jcfg.ToneConfig()), jcfg.ToneConfig())
    jl, _ = jmodel.forward_native(chunk)
    tl, _ = bench.bench_model(torch.device("cpu")).forward_native(chunk)
    assert tl.shape == (2, 10, 35)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < 0.05


def test_bench_sweep_and_headline(tiny):
    """The sweep's rows and the JAX bench's JSON keys, with the device."""
    from tone_tpu_torch.acoustic import StreamingCTCModel

    _, tc, _, tv = tiny
    rows = bench.sweep(StreamingCTCModel(tv, tc, device="cpu"), [2, 3], steps=(1, 2))
    assert [r["batch"] for r in rows] == [2, 3]
    for r in rows:
        assert r["ms_per_step"] > 0 and r["rtfx"] == pytest.approx(
            r["batch"] * 0.3 / (r["ms_per_step"] / 1e3))
    line = bench.headline(rows, torch.device("cpu"))
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "device", "power_limit"}
    assert line["value"] == round(max(r["rtfx"] for r in rows), 1)
    assert (line["device"], line["power_limit"], line["unit"]) == ("cpu", None, "x realtime")


def test_bench_sweep_stops_only_at_out_of_memory(monkeypatch):
    """The sweep stops at the card's OutOfMemoryError, and only there: any
    other error (a kernel that fails to build or launch) fails the run."""
    model = type("M", (), {"device": torch.device("cpu")})()

    def oom_at_3(m, batch, steps):
        if batch == 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return 0.1

    monkeypatch.setattr(bench, "measure_batch", oom_at_3)
    rows = bench.sweep(model, [2, 3, 4])
    assert [r["batch"] for r in rows] == [2, 3] and "oom" in rows[1]

    def broken(m, batch, steps):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(bench, "measure_batch", broken)
    with pytest.raises(RuntimeError, match="nvcc"):
        bench.sweep(model, [2])


# -- dev/tick_bench.py ------------------------------------------------------


def test_splitter_worst_case_matches_jax(capsys):
    jtick = _jax_script("dev/tick_bench.py")
    jtick.splitter_worst_case(64, 40)
    jax_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = tick_bench.splitter_worst_case(64, 40)
    assert set(jax_report) <= set(report)
    assert report["phrases_closed"] == jax_report["phrases_closed"] == 64
    assert report["phrase_frames"] == jax_report["phrase_frames"] == 400


def _jax_ticks(engine, ticks, speech_frac):
    """The JAX script's feeding loop (dev/tick_bench.py main); returns the
    stream ids and the phrases each emitted."""
    rng = np.random.default_rng(0)
    sids = [engine.open_stream() for _ in range(engine.arena.n_slots)]
    n = engine.config.audio_chunk_samples
    t = np.arange(n) / 8000
    speech = (8000 * np.sin(2 * np.pi * 300 * t)).astype(np.int32)
    silence = np.zeros(n, np.int32)
    futures = {sid: [] for sid in sids}
    for _ in range(ticks):
        for sid in sids:
            talking = rng.random() < speech_frac
            engine.feed(sid, speech if talking else silence)
        for sid, futs in engine.tick().items():
            futures[sid].extend(futs)
    return sids, {sid: [_phrase(f) for f in futs] for sid, futs in futures.items()}


def _phrase(future):
    p = future.result(timeout=60)
    return (p.text, p.start_time, p.end_time)


def _flush(engine, sids):
    """Close every stream and tick until each has flushed: its final phrases."""
    for sid in sids:
        engine.close_stream(sid)
    futures, done = {sid: [] for sid in sids}, set()
    for _ in range(10):
        for sid, futs in engine.tick().items():
            futures[sid].extend(futs)
        done.update(engine.pop_finished())
        if done >= set(sids):
            break
    assert done >= set(sids)
    return [[_phrase(f) for f in futures[sid]] for sid in sids]


def _assert_same_phrases(got, expected):
    assert [[p[0] for p in s] for s in got] == [[p[0] for p in s] for s in expected]
    for g, e in zip(got, expected):
        np.testing.assert_allclose(np.reshape([p[1:] for p in g], (-1, 2)),
                                   np.reshape([p[1:] for p in e], (-1, 2)), atol=1e-9)


def test_tick_bench_emits_the_jax_engines_phrases(tiny):
    """4 slots, 6 ticks: the port's ticks emit the phrases the JAX engine
    emits fed the same sequence, and so do both engines' flushes after them;
    the bench's report has the JAX keys."""
    jc, tc, jv, tv = tiny
    engine = MultiStreamEngine(tv, tc, n_slots=4, device="cpu")
    jengine = JaxEngine(jv, jc, n_slots=4)
    try:
        engine.arena.warmup()
        jengine.arena.warmup()
        out = tick_bench.run_ticks(engine, 6, 0.3)
        jsids, jphrases = _jax_ticks(jengine, 6, 0.3)
        assert out["sids"] == jsids
        assert len(out["host"]) == len(out["device"]) == len(out["tick"]) == 6 - 3
        _assert_same_phrases([out["phrases"][s] for s in jsids], [jphrases[s] for s in jsids])
        finals, jfinals = _flush(engine, jsids), _flush(jengine, jsids)
    finally:
        engine.shutdown()
        jengine.shutdown()
    assert sum(map(len, jfinals)) > 0, "no phrase to compare"
    _assert_same_phrases(finals, jfinals)
    report = tick_bench.bench(slots=4, ticks=6, device="cpu", variables=tv, config=tc)
    for key in ("slots", "speech_frac", "host_ms_p50", "host_ms_p95", "device_ms_p50",
                "tick_ms_p50", "tick_budget_ms", "device", "power_limit"):
        assert key in report
    assert report["slots"] == 4 and report["device"] == "cpu"
    assert report["phrases"] == {sid: out["phrases"][sid] for sid in report["phrases"]}


# -- dev/align_bench.py -----------------------------------------------------


def test_align_bench_phrases_and_words_match_jax():
    from tone_tpu.ops.align_device import align_words_batch as jax_align

    jalign = _jax_script("dev/align_bench.py")
    lps, texts = align_bench.make_phrases(8, 64, 3)
    jlps, jtexts = jalign.make_phrases(8, 64, 3)
    assert texts == jtexts
    for a, b in zip(lps, jlps):
        np.testing.assert_array_equal(a, b)
    jwords = [[w[:3] for w in p] for p in jax_align(jlps, jtexts)]
    report = align_bench.measure(8, 64, 3, iters=1, kernel=True, device="cpu")
    from tone_tpu_torch.align import align_words
    from tone_tpu_torch.ops.align_device import align_words_batch

    assert [[w[:3] for w in p] for p in align_words_batch(lps, texts, device="cpu")] == jwords
    assert [[w[:3] for w in align_words(lp, tx)] for lp, tx in zip(lps, texts)] == jwords
    assert report["backend"] == "cpu" and report["kernel_ms_per_batch"] > 0
    assert {"device_ms_per_batch", "host_ms_per_phrase", "kernel_audio_rtfx",
            "device", "power_limit"} <= set(report)


# -- dev/train_bench.py -----------------------------------------------------


def _jax_train_batch(batch, seconds, label_len):
    """The JAX script's batch (dev/train_bench.py main)."""
    from tone_tpu.config import LABELS, ToneConfig

    cfg = ToneConfig()
    rng = np.random.default_rng(0)
    n_samples = int(seconds * cfg.frontend.sample_rate)
    return {
        "input_values": rng.normal(0, 0.1, (batch, n_samples)).astype(np.float32),
        "input_lengths": np.full(batch, n_samples, np.int32),
        "labels": rng.integers(0, len(LABELS), (batch, label_len)).astype(np.int32),
    }


def test_train_bench_batch_and_first_loss_match_jax():
    from tone_tpu.training import train as JTR

    # dropout 0: the two packages draw their masks from different generators
    from test_torch_common import TINY_ENCODER

    jc, tc = tiny_configs(encoder=dict(TINY_ENCODER, dropout=0.0, dropout_att=0.0))
    jv = jax_init(jax.random.PRNGKey(0), jc)
    jbatch = _jax_train_batch(16, 10.0, 100)
    batch = train_bench.make_batch(16, 10.0, 100)
    assert sorted(batch) == sorted(jbatch)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    # a small batch through both trainers from the same initial weights
    small = _jax_train_batch(4, 2.0, 10)
    jt = JTR.Trainer(jc, JTR.TrainerConfig(), mesh=make_mesh(n_data=1, n_model=1))
    _, jloss = jt.train_step(jt.create_state(jv), small)
    report = train_bench.measure(4, 2.0, 10, steps=1, device="cpu", config=tc,
                                 variables=jax_init_model_params(0, tc))
    assert report["first_loss"] == pytest.approx(float(jloss), rel=1e-4)
    assert report["devices"] == 1 and report["device"] == "cpu"
    for key in ("params_m", "batch", "clip_s", "step_ms", "audio_s_per_s", "samples_per_s",
                "compile_s", "loss"):
        assert key in report


def test_trainer_takes_a_batch_staged_on_its_device(tiny):
    """``Trainer.train_step`` takes tensors as well as numpy arrays (the
    train bench stages its batch on the device once): the same loss."""
    from tone_tpu_torch.training.train import Trainer, TrainerConfig

    _, tc, _, tv = tiny
    batch = train_bench.make_batch(2, 1.0, 5)
    losses = []
    for b in (batch, {k: torch.from_numpy(v) for k, v in batch.items()}):
        trainer = Trainer(tc, TrainerConfig(), device="cpu")
        _, loss = trainer.train_step(trainer.create_state(tv), b)
        losses.append(float(loss))
    assert losses[0] == losses[1]


# -- dev/load_test.py -------------------------------------------------------


async def _in_process_round(engine, server_cls, round_fn, n_streams, seconds):
    import websockets

    server = server_cls(engine, tick_seconds=0.01)
    await asyncio.to_thread(engine.arena.warmup)
    tick = asyncio.create_task(server.tick_loop())
    try:
        async with websockets.serve(server.handle, "127.0.0.1", 0) as ws:
            port = ws.sockets[0].getsockname()[1]
            return await round_fn(f"ws://127.0.0.1:{port}/api/ws", n_streams, seconds,
                                  realtime=False)
    finally:
        tick.cancel()
        engine.shutdown()


def test_run_round_delivers_as_the_jax_server_does(tiny):
    """Two firehose streams through the port's tool and server, and through
    the JAX tool and server: the same deliveries and phrase count."""
    pytest.importorskip("websockets")
    from tone_tpu.runtime.server import TranscriptionServer as JaxServer
    from tone_tpu_torch.runtime.server import TranscriptionServer

    jc, tc, jv, tv = tiny
    jload = _jax_script("dev/load_test.py")
    assert load_test.HOTWORD_POOL == jload.HOTWORD_POOL
    port = asyncio.run(_in_process_round(MultiStreamEngine(tv, tc, n_slots=2, device="cpu"),
                                         TranscriptionServer, load_test.run_round, 2, 2.4))
    ref = asyncio.run(_in_process_round(JaxEngine(jv, jc, n_slots=2), JaxServer,
                                        jload.run_round, 2, 2.4))
    assert port["delivered"] == ref["delivered"] == 2
    assert port["phrases_total"] == ref["phrases_total"] > 0
    assert port["completed"] == 2
    assert set(ref) <= set(port)


def test_run_round_with_nbest_and_hotwords_on_a_device_beam_engine(tiny):
    """The round the card runs on a device-beam server: every stream asks
    for 4 alternatives, the first also for 3 hotwords; both are accepted and
    every stream ends cleanly."""
    pytest.importorskip("websockets")
    from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder
    from tone_tpu_torch.runtime.server import TranscriptionServer

    _, tc, _, tv = tiny
    engine = MultiStreamEngine(tv, tc, n_slots=2, device="cpu",
                               decoder=DeviceBeamSearchCTCDecoder(beam_width=8, device="cpu"))

    async def round_fn(url, n, seconds, realtime):
        return await load_test.run_round(url, n, seconds, realtime, nbest=4, hotword_streams=1)

    report = asyncio.run(_in_process_round(engine, TranscriptionServer, round_fn, 2, 2.4))
    assert (report["nbest"], report["hotword_streams"]) == (4, 1)
    assert report["delivered"] == report["completed"] == 2 and report["phrases_total"] > 0


def test_shutdown_mid_load_against_a_spawned_cpu_server():
    """``serve --device cpu`` (full width) SIGTERMed under two real-time
    streams: both get their flushed transcript and the 4503 close, and the
    server exits 0."""
    pytest.importorskip("websockets")
    report = asyncio.run(load_test.shutdown_mid_load(2, utterance_seconds=3.0, device="cpu"))
    assert report["ok"], report
    assert report["flushed"] == report["closed_4503"] == 2


def test_soak_against_a_spawned_cpu_server():
    pytest.importorskip("websockets")
    report = asyncio.run(load_test.soak(2, seconds=4.0, utterance_seconds=1.2, device="cpu"))
    assert report["rounds"] >= 1 and len(report["rss_mb"]) == report["rounds"]
    assert report["completed"] == report["streams_total"]
    assert report["phrases_total"] >= report["streams_total"]
    assert report["flat"] and report["exit_code"] == 0, report


@pytest.mark.parametrize("code, completed", [(1000, 2), (4500, 0), (4408, 0)],
                         ids=["normal", "server_failed", "evicted"])
def test_run_round_counts_only_normal_closes_as_completed(code, completed):
    """A stream the server ends with 4500 (failure) or 4408 (eviction) is
    delivered but not completed, even after its transcript."""
    websockets = pytest.importorskip("websockets")

    async def handler(ws):
        await ws.send(json.dumps({"event": "ready"}))
        async for message in ws:
            if message == b"":
                break
        await ws.send(json.dumps({"event": "transcript", "text": ""}))
        await ws.close(code=code)

    async def main():
        async with websockets.serve(handler, "127.0.0.1", 0) as ws:
            port = ws.sockets[0].getsockname()[1]
            return await load_test.run_round(f"ws://127.0.0.1:{port}/api/ws", 2, 0.6,
                                             realtime=False)

    report = asyncio.run(main())
    assert (report["delivered"], report["phrases_total"]) == (2, 2)
    assert report["completed"] == completed


def test_load_test_round_against_a_url_names_no_card(monkeypatch, capsys):
    """The client runs no model: without a GPU it still measures a server at
    --url, and its line names no card, since it cannot see the server's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def fake_round(url, n, seconds, realtime, nbest=0, hotword_streams=0):
        return {"streams": n, "url": url}

    monkeypatch.setattr(load_test, "run_round", fake_round)
    load_test.main(["--url", "ws://127.0.0.1:1/api/ws", "--streams", "3"])
    line = json.loads(capsys.readouterr().out)
    assert line == {"streams": 3, "url": "ws://127.0.0.1:1/api/ws",
                    "device": None, "power_limit": None}


def test_spawned_server_that_dies_reports_its_stderr():
    pytest.importorskip("websockets")

    async def main():
        async with load_test.spawned_server(2, "cpu", ["--checkpoint", "/nonexistent/model"]):
            pass

    with pytest.raises(RuntimeError, match="server died during startup") as err:
        asyncio.run(main())
    assert "nonexistent" in str(err.value)


# -- every entry point needs a card unless told otherwise ----------------------


@pytest.mark.parametrize("main, argv", [
    (bench.main, []),
    (tick_bench.main, ["--slots", "2", "--ticks", "4"]),
    (train_bench.main, ["--batch", "1", "--seconds", "1", "--steps", "1"]),
    (align_bench.main, ["--batch", "2", "--frames", "32", "--words", "1", "--iters", "1"]),
    (load_test.main, ["--shutdown-mid-load", "--streams", "1"]),
], ids=["bench", "tick_bench", "train_bench", "align_bench", "load_test"])
def test_entry_points_raise_without_cuda(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)


def test_tools_print_one_json_line_on_the_cpu(capsys):
    align_bench.main(["--batch", "2", "--frames", "32", "--words", "1", "--iters", "1",
                      "--device", "cpu"])
    tick_bench.main(["--splitter-worst", "--slots", "4", "--phrase-ticks", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for line in lines:
        assert json.loads(line)["device"] == "cpu"


# -- the notebooks ------------------------------------------------------------


def _code(nb) -> list[str]:
    return [c.source for c in nb.cells if c.cell_type == "code"]


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: str(p.relative_to(REPO)))
def test_notebook_is_valid_and_imports_only_the_port(path):
    nb = nbformat.read(path, as_version=4)
    nbformat.validate(nb)
    assert nb.nbformat == 4
    code = _code(nb)
    assert code[0].startswith('DEVICE = "cuda"')
    names = []
    for src in code:
        # notebooks may await at top level (the serving example)
        compile(src, str(path), "exec", flags=ast.PyCF_ALLOW_TOP_LEVEL_AWAIT)
        tree = compile(src, str(path), "exec",
                       flags=ast.PyCF_ONLY_AST | ast.PyCF_ALLOW_TOP_LEVEL_AWAIT)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [node.module]
                if node.module.startswith("tone_tpu_torch"):
                    names += [(node.module, a.name) for a in node.names]
            else:
                continue
            assert not {r.split(".")[0] for r in roots} & {"jax", "jaxlib", "flax", "tone_tpu"}
    assert names
    for module, name in names:
        assert hasattr(importlib.import_module(module), name), (module, name)


@pytest.mark.parametrize("path", [NOTEBOOKS[2], NOTEBOOKS[3]],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_research_notebook_runs_on_the_cpu(path, tmp_path, monkeypatch):
    """Top to bottom through a kernel, with ``DEVICE = "cpu"`` (full width)."""
    from nbclient import NotebookClient

    nb = nbformat.read(path, as_version=4)
    first = next(c for c in nb.cells if c.cell_type == "code")
    first.source = 'DEVICE = "cpu"'
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    NotebookClient(nb, timeout=600, kernel_name="python3",
                   resources={"metadata": {"path": str(tmp_path)}}).execute()
    outputs = [o for c in nb.cells if c.cell_type == "code" for o in c.outputs]
    assert not [o for o in outputs if o.output_type == "error"]
    assert list(tmp_path.rglob("*.pt2")), "the export cell wrote no program"


def test_400ms_step_matches_jax(tiny):
    """The notebooks' 400 ms chunking: the port's step equals JAX's (float32)."""
    jc, tc, jv, tv = tiny
    jc4, tc4 = jc.with_chunk_duration_ms(400), tc.with_chunk_duration_ms(400)
    assert tc4.audio_chunk_samples == jc4.audio_chunk_samples == 3200
    wav = audio(3200 * 3, 2, seed=9)
    js, ts = JM.init_streaming_state(jc4, 2), TM.init_streaming_state(tc4, 2)
    for i in range(3):
        chunk = wav[:, i * 3200:(i + 1) * 3200]
        jl, js = JM.apply_streaming(jv, jc4, chunk, js)
        tl, ts = TM.apply_streaming(tv, tc4, torch.as_tensor(chunk), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
