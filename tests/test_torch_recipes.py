"""The port's recipes and quality studies (tone_tpu_torch/examples/,
tone_tpu_torch/dev/) against the JAX package's (examples/, dev/) on the
CPU, and the port's public surface against the JAX package's.

The JAX scripts run as their own tests run them (tests/test_e2e_synthetic.py
imports them from examples/ and dev/; JAX on the eight virtual CPU devices
of tests/conftest.py, so JAX's ``run_training`` trains on its (4, 2) mesh).
Tiny sizes: 3 training steps, one fine-tuning epoch of batch 2; the
150-step quality pins run on the card (tests/test_torch_gpu.py,
``chip_smoke.py --phases recipes``).  Tolerances:

* ``tiny_config``, ``synth``, ``make_dataset``: equal, bit for bit;
* the port's numpy copy of JAX's PRNG and initial weights
  (core/jax_random.py): equal, bit for bit;
* ``run_training(steps=3)`` from its default initial weights (JAX's,
  through that copy): every parameter
  and running statistic within 1e-4 of JAX's, but for the biases right
  before a BatchNorm, whose exact gradient is 0: Adam turns their rounding
  noise into whole steps, so they are held to twice the summed lr, as in
  tests/test_torch_training.py;
* the streaming deployment of equal variables: logprobs within 1e-4
  (float32 streaming, tests/test_model_core.py), JAX's texts;
* ``finetune``: the loaded variables equal to JAX's ``from_local``'s, the
  first loss within 1e-4 relative of JAX's ``Trainer`` step, ``--resume``
  restores the step;
* ``domain_adapt``: the KenLM binary byte-equal, the perplexity within
  1e-9 relative, and on equal logprobs JAX's texts and word times (times
  to 1e-9 s, confidences to 1e-5);
* ``beam_quality_sweep``: ``corpus_lm``'s ARPA text equal, the utterance
  logprobs within 1e-4;
* ``device_lm_scale``'s generator at 1e4 grams: every array equal;
* the two-rank gloo route of ``run_training``: within 1e-4 of one process
  (the same bias carve-out).
"""

import argparse
import asyncio
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_common import audio, tiny_configs, tiny_variables

import tone_tpu
from tone_tpu.core.model import init_model_params as jax_init
from tone_tpu.parallel.mesh import make_mesh
from tone_tpu_torch.bridge import from_jax_variables, tree_leaves
from tone_tpu_torch.examples import domain_adapt, finetune
from tone_tpu_torch.examples import train_tiny_e2e as T

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "examples"))
sys.path.insert(0, str(REPO / "dev"))

import beam_quality_sweep as J_SWEEP  # noqa: E402
import device_lm_scale as J_SCALE  # noqa: E402
import train_tiny_e2e as J  # noqa: E402

STEPS = 3
LR_SUM = 1e-3 + 5e-4  # the lr of the 3 steps of TrainerConfig(total_steps=3): 0, 1e-3, 5e-4


def _pairs(jtree, ttree, prefix=""):
    """(path, JAX leaf, port leaf) of every leaf, as float64 numpy."""
    if isinstance(jtree, dict):
        return [p for k in sorted(jtree) for p in _pairs(jtree[k], ttree[k], f"{prefix}/{k}")]
    if isinstance(jtree, (list, tuple)):
        return [p for i, (a, b) in enumerate(zip(jtree, ttree, strict=True))
                for p in _pairs(a, b, f"{prefix}/{i}")]
    b = ttree.detach().cpu().double().numpy() if isinstance(ttree, torch.Tensor) else ttree
    return [(prefix, np.asarray(jtree, np.float64), np.asarray(b, np.float64))]


def _feeds_batchnorm(path: str) -> bool:
    """The biases of the convolutions right before a BatchNorm."""
    return path.endswith("/b") and ("/conv1/" in path or "/conv2/" in path
                                    or "/dw/" in path and "/reduction/" not in path)


def _assert_trained_close(jvars, tvars):
    for path, a, b in _pairs(jvars, tvars):
        bound = 2.0 * LR_SUM if _feeds_batchnorm(path) else 1e-4
        assert np.abs(a - b).max() <= bound, (path, np.abs(a - b).max())


@pytest.fixture(scope="module")
def jax_initial():
    """JAX's initial variables of the tiny model (numpy leaves)."""
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), J.tiny_config()))


@pytest.fixture(scope="module")
def trained(jax_initial):
    """(JAX variables, port variables) after ``run_training(steps=3)`` of
    each package from JAX's initial variables."""
    _, _, js, _, _ = J.run_training(steps=STEPS)
    jvars = {"params": jax.tree.map(np.asarray, js.params),
             "batch_stats": jax.tree.map(np.asarray, js.batch_stats)}
    # the port's default initial weights are JAX's (core/jax_random.py)
    _, _, ts, _, _ = T.run_training(steps=STEPS, device="cpu")
    return jvars, T.trained_variables(ts)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_numpy_prng_equals_jax(seed):
    from tone_tpu_torch.core import jax_random

    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(jax_random.prng_key(seed), np.asarray(key))
    for n in (2, 3, 8):
        np.testing.assert_array_equal(jax_random.split(jax_random.prng_key(seed), n),
                                      np.asarray(jax.random.split(key, n)))
    for shape, bound in (((7,), 0.3), ((5, 9), 1 / np.sqrt(80)), ((3, 1, 31), 1.0)):
        np.testing.assert_array_equal(
            jax_random.uniform(jax_random.prng_key(seed), shape, -bound, bound),
            np.asarray(jax.random.uniform(key, shape, np.float32, -bound, bound)))


@pytest.mark.parametrize("case", ["tiny_seed0", "tiny_seed3", "default_seed0"])
def test_jax_init_model_params_equals_jax(case, jax_initial):
    """The port's copy of JAX's initial weights, bit for bit (the tiny
    recipe's config and the full ToneConfig())."""
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.jax_random import jax_init_model_params

    seed = int(case[-1])
    if case.startswith("tiny"):
        jcfg, tcfg = J.tiny_config(), T.tiny_config()
    else:
        jcfg, tcfg = tone_tpu.ToneConfig(), ToneConfig()
    want = jax_initial if case == "tiny_seed0" else jax.tree.map(
        np.asarray, jax_init(jax.random.PRNGKey(seed), jcfg))
    for path, a, b in _pairs(want, jax_init_model_params(seed, tcfg)):
        np.testing.assert_array_equal(b, a, err_msg=path)


def test_tiny_config_synth_and_dataset_equal_jax():
    assert T.tiny_config().to_dict() == J.tiny_config().to_dict()
    for text in ("аб вг", "дед где", "xyz а"):
        np.testing.assert_array_equal(T.synth(text), J.synth(text))
    ported, reference = T.make_dataset(), J.make_dataset()
    assert [it["text"] for it in ported] == [it["text"] for it in reference]
    for a, b in zip(ported, reference):
        assert a["audio"].dtype == b["audio"].dtype
        np.testing.assert_array_equal(a["audio"], b["audio"])


def test_run_training_matches_jax(trained):
    jvars, tvars = trained
    _assert_trained_close(jvars, tvars)


def _stream_logprobs(forward_native, samples: np.ndarray) -> np.ndarray:
    """A whole utterance's logprobs, chunked as ``forward_offline`` chunks it."""
    a = np.pad(samples, (2400, 2400))
    a = np.pad(a, (0, -len(a) % 2400))
    state, out = None, []
    for chunk in a.reshape(-1, 2400):
        lp, state = forward_native(chunk[None], state)
        out.append(np.asarray(lp.cpu() if isinstance(lp, torch.Tensor) else lp, np.float32)[0])
    return np.concatenate(out)


def test_streaming_deployment_matches_jax(trained):
    from tone_tpu.acoustic import StreamingCTCModel as JaxModel
    from tone_tpu.decoder import GreedyCTCDecoder as JaxGreedy
    from tone_tpu.pipeline import StreamingCTCPipeline as JaxPipeline
    from tone_tpu.splitter import StreamingLogprobSplitter as JaxSplitter

    jvars, _ = trained
    cfg = T.tiny_config()
    pipe = T.deploy(cfg, from_jax_variables(jvars, cfg, "cpu"), "cpu")
    jpipe = JaxPipeline(JaxModel(jvars, J.tiny_config()), JaxSplitter(), JaxGreedy())
    items = T.make_dataset()[:T.EVAL_ITEMS]
    for it in items:
        samples = T.int_audio(it["audio"])
        np.testing.assert_allclose(_stream_logprobs(pipe.model.forward_native, samples),
                                   _stream_logprobs(jpipe.model.forward_native, samples),
                                   atol=1e-4, rtol=0)
    jtexts = [" ".join(p.text for p in jpipe.forward_offline(T.int_audio(it["audio"])))
              for it in items]
    assert T.stream_texts(pipe, items) == jtexts


def test_two_rank_training_equals_one_process(trained, jax_initial, monkeypatch):
    """The multi-device route (one gloo rank per mesh position, here
    (data, model) = (2, 1) on [cpu, cpu]) against one process."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks share the test's cores
    _, tvars = trained
    cfg = T.tiny_config()
    _, trainer, state, _, _ = T.run_training(
        steps=STEPS, variables=from_jax_variables(jax_initial, cfg, "cpu"), device="cpu",
        devices=["cpu", "cpu"])
    assert state.step == STEPS and trainer.device.type == "cpu"
    two = T.trained_variables(state)
    for path, a, b in _pairs(tvars, two):
        bound = 2.0 * LR_SUM if _feeds_batchnorm(path) else 1e-4
        assert np.abs(a - b).max() <= bound, (path, np.abs(a - b).max())


def test_mesh_shape_follows_the_jax_script():
    assert [T.mesh_shape(n) for n in (2, 4, 8)] == [(2, 1), (4, 1), (4, 2)]


# ---------------------------------------------------------------------------
# finetune
# ---------------------------------------------------------------------------


def _finetune_args(tmp_path, ckpt, **kw):
    args = finetune.build_parser().parse_args(
        ["--synthetic", "--epochs", "1", "--batch-size", "2", "--init-checkpoint", str(ckpt),
         "--out", str(tmp_path / "out"), "--device", "cpu"])
    return argparse.Namespace(**{**vars(args), **kw})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finetune_loads_init_checkpoint_as_jax(tmp_path, dtype, jax_initial):
    """``--init-checkpoint`` loads what JAX's ``from_local`` loads (under a
    bf16 config: bf16-rounded matrices, the GLU halves merged, here split
    again for training), cast to float32."""
    from tone_tpu.acoustic import StreamingCTCModel as JaxModel
    from tone_tpu.interop import save_torch_checkpoint

    jc = dataclasses.replace(J.tiny_config(), compute_dtype=dtype)
    tc = dataclasses.replace(T.tiny_config(), compute_dtype=dtype)
    ckpt = tmp_path / "init.safetensors"
    save_torch_checkpoint(ckpt, jax_initial, jc)
    ported = finetune.initial_variables(_finetune_args(tmp_path, ckpt), tc)
    ref = jax.tree.map(lambda x: np.asarray(x, np.float32),
                       JaxModel.from_local(ckpt, config=jc).variables)
    for layer in ref["params"]["encoder"]["layers"]:
        for ff in ("ff1", "ff2"):
            if "lin12" in layer[ff]:
                lin12 = layer[ff].pop("lin12")
                f = lin12["w"].shape[1] // 2
                layer[ff]["lin1"] = {"w": lin12["w"][:, :f], "b": lin12["b"][:f]}
                layer[ff]["linv"] = {"w": lin12["w"][:, f:], "b": lin12["b"][f:]}
    for path, a, b in _pairs(ref, ported):
        np.testing.assert_array_equal(b, a, err_msg=path)
    assert all(t.dtype == torch.float32 for t in tree_leaves(ported))


def test_finetune_first_loss_and_resume_match_jax(tmp_path, jax_initial):
    from tone_tpu.acoustic import StreamingCTCModel as JaxModel
    from tone_tpu.interop import save_torch_checkpoint
    from tone_tpu.training import DataCollatorCTCWithPadding as JaxCollator
    from tone_tpu.training import Trainer as JaxTrainer
    from tone_tpu.training import TrainerConfig as JaxTrainerConfig

    ckpt = tmp_path / "init.safetensors"
    save_torch_checkpoint(ckpt, jax_initial, J.tiny_config())
    out = finetune.run(_finetune_args(tmp_path, ckpt), T.tiny_config())
    steps = 32 // 2
    assert out["step"] == steps and out["resumed_at"] is None
    assert (out["model"] / "variables.safetensors").exists()
    assert len(out["epochs"]) == 1 and np.isfinite(out["epochs"][0]["wer"])

    # JAX's first step on the first batch of the recipe's order
    items = finetune.synthetic_items()
    max_audio = max(len(it["audio"]) for it in items)
    collator = JaxCollator(pad_audio_to_multiple_of=-(-max_audio // 2400) * 2400)
    first = np.random.default_rng(0).permutation(len(items))[:2]
    batch = collator([{"input_values": items[j]["audio"], "labels": items[j]["text"]}
                      for j in first])
    trainer = JaxTrainer(J.tiny_config(), JaxTrainerConfig(learning_rate=5e-5,
                                                           total_steps=steps),
                         mesh=make_mesh(n_data=1, n_model=1))
    state = trainer.create_state(jax.tree.map(
        lambda x: jax.numpy.asarray(x, np.float32),
        JaxModel.from_local(ckpt, config=J.tiny_config()).variables))
    _, loss = trainer.train_step(state, batch)
    assert out["epochs"][0]["losses"][0] == pytest.approx(float(loss), rel=1e-4)

    resumed = finetune.run(_finetune_args(tmp_path, ckpt, resume=tmp_path / "out" / "train_state"),
                           T.tiny_config())
    assert resumed["resumed_at"] == steps and resumed["step"] == 2 * steps


# ---------------------------------------------------------------------------
# domain_adapt
# ---------------------------------------------------------------------------


def test_domain_lm_binary_and_perplexity_equal_jax(tmp_path):
    from tone_tpu.decoding.estimate import estimate_ngram_lm, perplexity
    from tone_tpu.decoding.kenlm_binary import write_kenlm_binary
    from tone_tpu.decoding.lm import ArpaLM

    items = T.make_dataset()
    (tmp_path / "port").mkdir()
    tables, ppl, path = domain_adapt.domain_lm(items, tmp_path / "port")
    sentences = [it["text"].split() for it in items]
    jtables = estimate_ngram_lm(sentences, order=3)
    write_kenlm_binary(jtables, tmp_path / "jax.bin")
    assert path.read_bytes() == (tmp_path / "jax.bin").read_bytes()
    assert ppl == pytest.approx(perplexity(ArpaLM(jtables), sentences), rel=1e-9)
    assert [len(t) for t in tables] == [len(t) for t in jtables]


def _peaky_logprobs(texts, frames: int, seed: int) -> np.ndarray:
    """(B, frames, V) logprobs that spell each text (every character two
    frames, blanks between words) under seeded noise, the rest blank."""
    from tone_tpu_torch.config import BLANK_ID, LABELS

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.5, (len(texts), frames, len(LABELS) + 1)).astype(np.float32)
    x[..., BLANK_ID] += 4.0
    for row, text in enumerate(texts):
        t = 12
        for ch in text:
            x[row, t:t + 2, LABELS.index(ch)] += 7.0
            t += 4
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def test_domain_decode_with_hotword_and_word_times_equals_jax(tmp_path):
    """Steps 3–4 on equal logprobs: the fused-LM search with the entity
    hotword and the device aligner give JAX's texts and word times."""
    from tone_tpu.decoder import DeviceBeamSearchCTCDecoder as JaxDecoder
    from tone_tpu.decoding.device_lm import load_device_lm as jax_load_device_lm
    from tone_tpu.offline import OfflineTranscriber as JaxTranscriber
    from tone_tpu_torch.offline import OfflineTranscriber

    items = T.make_dataset()
    _, _, lm_path = domain_adapt.domain_lm(items, tmp_path)
    entity = items[0]["text"].split()[0]
    audios, refs = domain_adapt.noisy_audios(items)
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc)
    # every row of the one batch gets the same frames in both packages
    order = np.argsort([len(a) for a in audios], kind="stable")
    rows = (max(len(a) for a in audios) + 2 * 2400 + 8 * 2400 - 1) // (8 * 2400) * 80
    fixed = _peaky_logprobs([refs[i] for i in order], rows, seed=5)

    port = OfflineTranscriber(tv, tc, decoder=domain_adapt.domain_decoder(lm_path, entity, "cpu"),
                              word_timestamps=True, device="cpu")
    port._chunk_scan = lambda variables, chunks: torch.from_numpy(fixed[:, :chunks.shape[1] * 10])
    ref = JaxTranscriber(jv, jc, decoder=JaxDecoder(
        jax_load_device_lm(lm_path), fusion=True, beam_width=16, hotwords=[entity],
        hotword_weight=2.0), word_timestamps=True)
    ref._batch_forward = lambda variables, chunks: fixed[:, :chunks.shape[1] * 10]
    got, want = port.transcribe(audios), ref.transcribe(audios)
    assert [[p.text for p in r] for r in got] == [[p.text for p in r] for r in want]
    assert any(p.text for r in got for p in r)
    for gr, wr in zip(got, want):
        for gp, wp in zip(gr, wr):
            assert (gp.start_time, gp.end_time) == pytest.approx((wp.start_time, wp.end_time),
                                                                 abs=1e-9)
            assert [w.word for w in gp.words] == [w.word for w in wp.words]
            for gw, ww in zip(gp.words, wp.words):
                assert (gw.start_time, gw.end_time) == pytest.approx(
                    (ww.start_time, ww.end_time), abs=1e-9)
                assert gw.confidence == pytest.approx(ww.confidence, abs=1e-5)


# ---------------------------------------------------------------------------
# dev/: beam_quality_sweep, hotword_quality, device_lm_scale, debug_sequence
# ---------------------------------------------------------------------------


def test_corpus_lm_writes_jax_arpa(tmp_path):
    from tone_tpu.decoding.estimate import write_arpa as jax_write_arpa
    from tone_tpu_torch.decoding.estimate import write_arpa
    from tone_tpu_torch.dev import beam_quality_sweep

    write_arpa(beam_quality_sweep.corpus_lm(), tmp_path / "port.arpa")
    jax_write_arpa(J_SWEEP.corpus_lm(), tmp_path / "jax.arpa")
    assert (tmp_path / "port.arpa").read_text() == (tmp_path / "jax.arpa").read_text()


def test_utterance_logprobs_match_jax(trained):
    from tone_tpu_torch.dev import beam_quality_sweep

    jvars, _ = trained
    cfg = T.tiny_config()
    tv = from_jax_variables(jvars, cfg, "cpu")
    wav = T.make_dataset()[2]["audio"]
    got = beam_quality_sweep.utterance_logprobs(tv, cfg, wav, 0.3, np.random.default_rng(3))
    want = J_SWEEP.utterance_logprobs(jvars, J.tiny_config(), wav, 0.3,
                                      np.random.default_rng(3))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_hotword_stats_and_sweep_rows():
    from tone_tpu_torch.dev import hotword_quality

    stats = hotword_quality.entity_stats(["дед аб", "аб вг", "где дед"],
                                         ["дед аб", "дед вг", "где"])
    assert stats == {"recall": 0.5, "false_alarm": 1.0, "wer": 0.333}
    jc, tc = tiny_configs()
    _, tv = tiny_variables(jc, tc)
    items = T.make_dataset()[:4]
    rows = hotword_quality.hotword_sweep(tc, tv, items, weights=(0.0, 2.0), noises=(0.3,),
                                         copies=1, device="cpu")
    assert [(r["noise"], r["weight"]) for r in rows] == [(0.3, 0.0), (0.3, 2.0)]
    assert all(set(r[k]) == {"recall", "false_alarm", "wer"}
               for r in rows for k in ("host", "device"))


def test_device_lm_generator_builds_jax_tables():
    from tone_tpu_torch.dev import device_lm_scale

    lm, n, _ = device_lm_scale.synth_device_lm(10_000, n_words=2000)
    jlm, jn, _ = J_SCALE.synth_device_lm(10_000, n_words=2000)
    assert n == jn and lm.words == jlm.words
    for f in ("order", "unk_id", "bos_id", "n_words", "probe", "edge_probe"):
        assert getattr(lm, f) == getattr(jlm, f), f
    for f in ("keys1", "keys2", "probs", "backoffs", "edge_keys", "edge_child", "node_word"):
        a, b = getattr(lm, f), np.asarray(getattr(jlm, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    row = device_lm_scale.measure(lm, n, beam_width=4, batch=2, device="cpu")
    assert row["grams"] == n and row["device_bytes"] is None
    assert row["table_bytes"] == sum(t.numel() * t.element_size()
                                     for t in (lm.arrays("cpu").table, lm.arrays("cpu").edges))


def test_debug_sequence_invariants():
    from tone_tpu_torch.dev import debug_sequence

    jc, tc = tiny_configs()
    _, tv = tiny_variables(jc, tc)
    out = debug_sequence.run_sequence(tv, tc, steps=4, slots=4, device="cpu")
    assert out["unique_shapes"] == 1 and out["clean_reuse"]
    assert len(set(out["norms"])) > 1


# ---------------------------------------------------------------------------
# stream_client, the public names, the CLI
# ---------------------------------------------------------------------------


def test_stream_client_receives_ready_and_a_transcript():
    websockets = pytest.importorskip("websockets")
    from tone_tpu_torch.examples import stream_client
    from tone_tpu_torch.runtime.engine import MultiStreamEngine
    from tone_tpu_torch.runtime.server import TranscriptionServer

    jc, tc = tiny_configs()
    _, tv = tiny_variables(jc, tc)
    pcm = audio(2400 * 4, seed=14).astype("<i2").tobytes()

    async def main():
        engine = MultiStreamEngine(tv, tc, n_slots=2, device="cpu")
        server = TranscriptionServer(engine, tick_seconds=0.01)
        tick = asyncio.create_task(server.tick_loop())
        try:
            async with websockets.serve(server.handle, "127.0.0.1", 0) as ws_server:
                port = ws_server.sockets[0].getsockname()[1]
                return await asyncio.wait_for(
                    stream_client.stream(f"ws://127.0.0.1:{port}/api/ws", pcm), 60)
        finally:
            tick.cancel()
            engine.shutdown()

    events = asyncio.run(main())
    finals = [e for e in events if e["event"] == "transcript"]
    assert finals and all(e["start_time"] <= e["end_time"] for e in finals)


def test_port_exports_every_public_name_of_jax():
    import tone_tpu_torch

    names = set(tone_tpu.__all__) | set(tone_tpu._LAZY)
    assert names <= set(tone_tpu_torch.__all__)
    for name in sorted(names):
        assert getattr(tone_tpu_torch, name).__name__ == name


def _cli_flags(parser) -> dict[str, set[str]]:
    import argparse as ap

    sub = next(a for a in parser._actions if isinstance(a, ap._SubParsersAction))
    return {name: {s for a in p._actions for s in (a.option_strings or [a.dest])} - {"-h",
                                                                                  "--help"}
            for name, p in sub.choices.items()}


def test_cli_subcommands_and_flags_match_jax(monkeypatch):
    """The JAX CLI builds its parser inside ``main``: its ``parse_args`` is
    stopped to read it."""
    import argparse as ap

    import tone_tpu.__main__ as jax_cli
    from tone_tpu_torch.__main__ import build_parser

    class Parsed(Exception):
        pass

    def stop(self, *args, **kwargs):
        raise Parsed(self)

    monkeypatch.setattr(ap.ArgumentParser, "parse_args", stop)
    with pytest.raises(Parsed) as caught:
        jax_cli.main()
    monkeypatch.undo()
    jax_flags, port_flags = _cli_flags(caught.value.args[0]), _cli_flags(build_parser())
    assert set(jax_flags) == set(port_flags)
    for name in jax_flags:
        assert port_flags[name] - {"--device"} == jax_flags[name], name


def test_cli_download_exits_naming_the_network(tmp_path):
    """``download`` creates DIR first, as the JAX CLI does; from an endpoint
    that cannot be reached, with an empty cache, it exits non-zero with the
    client's message, which names the endpoint."""
    from test_torch_common import dead_endpoint

    from tone_tpu_torch.__main__ import main
    from tone_tpu_torch.dev.local_hub import hub_env

    dead = dead_endpoint()
    with hub_env(HF_ENDPOINT=dead, HF_HOME=tmp_path / "hf"), \
            pytest.raises(SystemExit) as exit_info:
        main(["download", str(tmp_path / "artifacts"), "--only-acoustic"])
    message = str(exit_info.value.code)
    assert message.startswith("download: ") and dead in message and "model.onnx" in message
    assert list((tmp_path / "artifacts").iterdir()) == []


# the port's one renamed flag: it uploads the export subcommand's programs, not StableHLO
RENAMED_FLAGS = {"dev.push_hf": {(("--stablehlo",), "stablehlo"): (("--exported",), "exported")}}


@pytest.mark.parametrize("name", ["examples.finetune", "examples.domain_adapt",
                                  "examples.stream_client", "dev.beam_quality_sweep",
                                  "dev.hotword_quality", "dev.device_lm_scale",
                                  "dev.debug_sequence", "dev.push_hf"])
def test_script_flags_and_defaults_match_jax(name, monkeypatch):
    """Each script takes the JAX script's flags with their defaults (under
    the port's name where ``RENAMED_FLAGS`` gives one), and ``--device``
    (but for the client and push_hf, which run no model)."""
    import argparse as ap
    import importlib

    class Parsed(Exception):
        pass

    def stop(self, *args, **kwargs):
        raise Parsed(self)

    def flags(main) -> dict:
        with pytest.raises(Parsed) as caught:
            main([]) if main.__module__.startswith("tone_tpu_torch") else main()
        return {(tuple(a.option_strings), a.dest): a.default
                for a in caught.value.args[0]._actions if a.dest != "help"}

    monkeypatch.setattr(sys, "argv", [name])
    monkeypatch.setattr(ap.ArgumentParser, "parse_args", stop)
    jax_flags = flags(importlib.import_module(name.split(".")[1]).main)
    port_flags = flags(importlib.import_module(f"tone_tpu_torch.{name}").main)
    renamed = RENAMED_FLAGS.get(name, {})
    jax_flags = {renamed.get(flag, flag): default for flag, default in jax_flags.items()}
    no_model = name in ("examples.stream_client", "dev.push_hf")
    device = {} if no_model else {(("--device",), "device"): None}
    assert port_flags == {**jax_flags, **device}
