"""The FastConformer CTC model (Parakeet-CTC-1.1B's architecture) on the
port's bulk path, held to the plain float32 reference
(``benchmark/reference/fastconformer.py``, NeMo's modules written out) on
seeded random weights at a small size: d_model 64, 2 heads, 2 layers,
conv kernel 9, x8 subsampling with 16 channels, 32 pieces.

Tolerances, each with its reason:

* float32 compute against the reference: 2e-5 on logprobs.  Both sides
  run the same float32 mathematics; what differs is the order of the sums
  (products of other shapes, blocked attention, a matmul STFT against
  ``torch.stft``'s FFT, the frontend's masked sums).
* bf16 compute (the served precision) against the reference: 0.03 at
  most and 0.008 RMS on logprobs.  Every product rounds its operands to
  bf16 (2^-9 relative) and the residual stream is bf16; at this size the
  logprobs are about -3.66 +- 0.53 and the error measured 0.0125 at most,
  0.0031 RMS.
* a batch of unequal rows against each row alone: 1e-5 in float32 (only
  the shapes of the sums change; 9.5e-7 measured), 0.02 in bf16 (a float32
  sum of another order can turn a bf16 rounding over; 0 measured here).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tone_tpu_torch import profiling
from tone_tpu_torch.bridge import tree_leaves
from tone_tpu_torch.checkpoint import (
    convert_fastconformer_state_dict,
    convert_torch_state_dict,
    load_checkpoint,
    save_checkpoint,
)
from tone_tpu_torch.config import (
    FastConformerConfig,
    FastConformerEncoderConfig,
    FastConformerFrontendConfig,
    ToneConfig,
    config_from_dict,
    stand_in_vocabulary,
)
from tone_tpu_torch.core import fastconformer as FC
from tone_tpu_torch.core import frontend as TF
from tone_tpu_torch.core import layers as L
from tone_tpu_torch.decoder import GreedyCTCDecoder
from tone_tpu_torch.interop import to_fastconformer_state_dict, to_torch_state_dict
from tone_tpu_torch.offline import OfflineTranscriber
from tone_tpu_torch.splitter import StreamingLogprobSplitter

ROOT = Path(__file__).resolve().parents[1]


def _load_reference():
    """The benchmark's plain FastConformer reference, which imports nothing
    of the port, as module ``fastconformer_reference``."""
    path = ROOT / "benchmark/reference/fastconformer.py"
    spec = importlib.util.spec_from_file_location("fastconformer_reference", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module     # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


R = _load_reference()

SMALL_ENCODER = FastConformerEncoderConfig(n_layers=2, d_model=64, n_heads=2,
                                           subsampling_conv_channels=16)


def small_config(dtype: str = "float32") -> FastConformerConfig:
    return FastConformerConfig(encoder=SMALL_ENCODER, vocabulary=stand_in_vocabulary(32),
                               compute_dtype=dtype)


def state_dict(config: FastConformerConfig, seed: int = 1) -> dict[str, torch.Tensor]:
    """NeMo-named float32 weights drawn as the benchmark draws them."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, leaf in R.param_layout(R.sizes(config.to_dict())).items():
        x = (torch.rand(leaf.shape, generator=gen) * 2 - 1) * leaf.scale
        out[name] = x + 1.0 if leaf.kind == "one" else x
    return out


def calls(*seconds: float, seed: int = 0) -> list[np.ndarray]:
    """Speech-like int16 calls at 16 kHz: tones under a syllabic envelope
    over noise."""
    rng = np.random.default_rng(seed)
    out = []
    for s in seconds:
        t = np.arange(int(s * 16000)) / 16000
        f0 = rng.uniform(100, 250)
        x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
        x *= 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
        x = 6000 * x + rng.normal(0, 300, len(t))
        out.append(np.clip(x, -32768, 32767).astype(np.int16))
    return out


def reference(sd, config, call: np.ndarray) -> np.ndarray:
    wav = torch.from_numpy(call.astype(np.float32) / 32767.0)
    return R.forward(sd, R.sizes(config.to_dict()), wav).numpy()


def batch(audios: list[np.ndarray], extra: int = 3000) -> tuple[torch.Tensor, list[int]]:
    arr = np.zeros((len(audios), max(len(a) for a in audios) + extra), np.int32)
    for i, a in enumerate(audios):
        arr[i, :len(a)] = a
    return torch.from_numpy(arr), [len(a) for a in audios]


# ---------------------------------------------------------------------------
# Configuration, parameters and the benchmark's copy of the reference.
# ---------------------------------------------------------------------------


def test_published_parameter_count():
    cfg = FastConformerConfig()
    assert FC.parameter_count(cfg) == 1_062_540_289
    assert R.parameter_count(R.sizes(cfg.to_dict())) == 1_062_540_289
    assert (cfg.encoder.n_layers, cfg.encoder.d_model, cfg.encoder.d_head,
            cfg.encoder.d_ff, cfg.vocab_size_with_blank) == (42, 1024, 128, 4096, 1025)
    assert (cfg.frontend.win_length, cfg.frontend.hop_length, cfg.frame_size) == (400, 160, 0.08)


def test_small_parameter_count_matches_the_tree():
    cfg = small_config()
    v = FC.init_fastconformer_params(torch.Generator().manual_seed(0), cfg)
    assert sum(t.numel() for t in tree_leaves(v["params"])) == FC.parameter_count(cfg)
    assert FC.parameter_count(cfg) == R.parameter_count(R.sizes(cfg.to_dict()))


def test_config_round_trip_and_refusals():
    cfg = FastConformerConfig()
    d = json.loads(json.dumps(cfg.to_dict()))
    assert d["architecture"] == "fastconformer_ctc"
    assert config_from_dict(d) == cfg and FastConformerConfig.from_dict(d) == cfg
    assert isinstance(config_from_dict(ToneConfig().to_dict()), ToneConfig)
    bench = json.loads((ROOT / "benchmark/configs/parakeet-ctc-1.1b.json").read_text())
    assert FastConformerConfig.from_dict(bench["model"]) == cfg
    # NeMo's settings the port runs in one form only: stated in the dict,
    # accepted at that value and refused at any other.
    assert d["encoder"]["xscaling"] is True and d["frontend"]["normalize"] == "per_feature"
    for bad in ({"encoder": {"subsampling": "striding"}},
                {"encoder": {"att_context_size": [64, 0]}},
                {"encoder": {"self_attention_model": "abs_pos"}},
                {"encoder": {"xscaling": False}}, {"encoder": {"untie_biases": False}},
                {"encoder": {"conv_norm_type": "layer_norm"}},
                {"encoder": {"subsampling_factor": 6}},
                {"frontend": {"normalize": "all_features"}}):
        with pytest.raises(ValueError):
            FastConformerConfig.from_dict(bad)
    with pytest.raises(ValueError):
        FastConformerEncoderConfig(d_model=100, n_heads=8)
    with pytest.raises(ValueError):
        FastConformerFrontendConfig(n_fft=256)
    assert len(set(stand_in_vocabulary())) == 1024


# ---------------------------------------------------------------------------
# The frontend and the attention against direct formulations.
# ---------------------------------------------------------------------------


def test_frontend_against_torch_stft():
    cfg = small_config()
    s = R.sizes(cfg.to_dict())
    np.testing.assert_allclose(
        TF.compute_mel_filterbanks(cfg.frontend), R.mel_filterbank(s).T, rtol=1e-6, atol=1e-9)
    audio = calls(1.03, 0.41, 2.0, seed=3)
    wav, lengths = batch(audio, extra=777)
    feats, frame_lens = TF.log_mel_centered(
        wav.float() / 32767.0, torch.tensor(lengths),
        TF.get_frontend_constants(cfg.frontend, torch.device("cpu")))
    assert feats.shape[1] == cfg.frontend.frames(wav.shape[1])
    assert frame_lens.tolist() == [cfg.frontend.frames(n) for n in lengths]
    for row, a in enumerate(audio):
        ref = R.log_mel(s, torch.from_numpy(a.astype(np.float32) / 32767.0))
        n = cfg.frontend.frames(len(a))
        assert ref.shape[0] == n
        # float32 features normalized to unit spread: the STFT's sums in
        # another order (matmul against FFT)
        torch.testing.assert_close(feats[row, :n], ref, rtol=0, atol=2e-4)
        assert bool((feats[row, n:] == 0).all())


@pytest.mark.parametrize("block_elements", [L.REL_SCORE_BLOCK_ELEMENTS, 1])
def test_blocked_attention_against_direct_indexing(block_elements, monkeypatch):
    """One block of queries, and blocks of 16 (``rel_blocks``' least)."""
    monkeypatch.setattr(L, "REL_SCORE_BLOCK_ELEMENTS", block_elements)
    cfg = small_config()
    s = R.sizes(cfg.to_dict())
    sd = state_dict(cfg, seed=5)
    v = convert_fastconformer_state_dict(sd, cfg)
    p = v["params"]["encoder"]["layers"][1]["att"]
    gen = torch.Generator().manual_seed(7)
    host = [37, 50, 13]
    x = torch.randn(3, 55, s.d_model, generator=gen)
    pos = FC.positional_encoding(max(host), s.d_model, "cpu")
    out = L.rel_mhsa_blocked(p, x, pos, n_heads=s.n_heads, lengths=torch.tensor(host),
                             host_lengths=host, compute_dtype=torch.float32)
    for row, n in enumerate(host):
        ref = R.rel_attention(sd, "encoder.layers.1.self_attn", x[row, :n],
                              R.positional_encoding(n, s.d_model, "cpu"), s, R.FLOAT32)
        torch.testing.assert_close(out[row, :n], ref, rtol=0, atol=2e-5)
    assert bool((out[:, max(host):] == 0).all())


def test_query_blocks_skip_finished_rows(monkeypatch):
    keys, blocks = L.rel_blocks([5, 9], n_heads=8)
    assert (keys, blocks) == (16, [(0, 9, 0, 2)])
    monkeypatch.setattr(L, "REL_SCORE_BLOCK_ELEMENTS", 3 * 2 * 32 * (32 + 72 + 7))
    keys, blocks = L.rel_blocks([20, 40, 70], n_heads=2)
    assert keys == 72
    assert blocks == [(0, 32, 0, 3), (32, 64, 1, 3), (64, 70, 2, 3)]


# ---------------------------------------------------------------------------
# The whole forward, and batches against rows alone.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, atol, rms", [("float32", 2e-5, 2e-5), ("bfloat16", 0.03, 0.008)])
def test_forward_against_reference(dtype, atol, rms):
    cfg = small_config(dtype)
    sd = state_dict(cfg)
    v = convert_fastconformer_state_dict(sd, cfg)
    audio = calls(1.7, 0.9, 2.6, seed=1)
    wav, lengths = batch(audio)
    logprobs, out_lens = FC.apply_fastconformer(v, cfg, wav, lengths)
    assert out_lens == [cfg.output_frames(n) for n in lengths]
    for row, a in enumerate(audio):
        ref = reference(sd, cfg, a)
        got = logprobs[row, :out_lens[row]].numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= atol
        assert np.sqrt(np.mean(np.square(got - ref))) <= rms


@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5), ("bfloat16", 0.02)])
def test_batch_of_unequal_rows_equals_each_row_alone(dtype, atol):
    cfg = small_config(dtype)
    v = convert_fastconformer_state_dict(state_dict(cfg, seed=2), cfg)
    audio = calls(2.9, 0.37, 1.21, 0.08, seed=4)
    wav, lengths = batch(audio, extra=5000)
    together, out_lens = FC.apply_fastconformer(v, cfg, wav, lengths)
    for row, a in enumerate(audio):
        alone, (n,) = FC.apply_fastconformer(v, cfg, torch.from_numpy(a.astype(np.int32))[None],
                                             [len(a)])
        assert alone.shape[1] == n == out_lens[row]
        torch.testing.assert_close(together[row, :n], alone[0], rtol=0, atol=atol)


def test_transcriber_against_reference_splitter_and_decoder():
    cfg = small_config("bfloat16")
    sd = state_dict(cfg, seed=3)
    v = convert_fastconformer_state_dict(sd, cfg)
    audio = calls(3.1, 1.4, 0.6, 2.2, 1.9, seed=5)
    tr = OfflineTranscriber(v, cfg, batch_size=2, use_offline_forward=True, device="cpu")
    texts = tr.transcribe(audio)
    logprobs = tr.logprobs(audio)
    pieces = cfg.vocabulary
    for a, phrases, lp in zip(audio, texts, logprobs):
        assert lp.shape == (cfg.output_frames(len(a)), cfg.vocab_size_with_blank)
        assert np.abs(lp - reference(sd, cfg, a)).max() <= 0.03
        assert [p.text for p in phrases] == R.phrase_texts(lp, pieces)
        spans = R.phrase_spans(lp)
        assert [(p.start_time, p.end_time) for p in phrases] == [
            (round(x * 0.08, 2), round(y * 0.08, 2)) for x, y in spans]


# ---------------------------------------------------------------------------
# The splitter and greedy decoder on a subword vocabulary.
# ---------------------------------------------------------------------------


def test_splitter_and_decoder_on_a_subword_vocabulary():
    pieces = ("▁he", "llo", "▁wor", "ld", "▁")
    rng = np.random.default_rng(0)
    frames = []
    for token in [0, 0, 1, 5, 5, 2, 3, 3] + [5] * 25 + [2, 3, 4, 0] + [5] * 22:
        row = rng.normal(-8.0, 0.5, 6)
        row[token] = -0.01
        frames.append(row)
    lp = np.array(frames, np.float32)
    lp -= np.log(np.exp(lp).sum(-1, keepdims=True))
    assert GreedyCTCDecoder(pieces).forward(lp[:8]) == "hello world"
    assert GreedyCTCDecoder(pieces).forward(lp) == R.greedy_text(lp, pieces)
    splitter = StreamingLogprobSplitter(len(pieces) + 1, silence_classes=1)
    phrases, _ = splitter.forward(lp, None, is_last=True)
    assert [(p.start_frame, p.end_frame) for p in phrases] == R.phrase_spans(lp)
    assert [GreedyCTCDecoder(pieces).forward(p.logprobs) for p in phrases] == \
        R.phrase_texts(lp, pieces)
    with pytest.raises(ValueError, match=r"\(L, 35\)"):
        StreamingLogprobSplitter().forward(lp, None)
    with pytest.raises(ValueError, match=r"\(L, 35\)"):
        GreedyCTCDecoder().forward(lp)


# ---------------------------------------------------------------------------
# Loading on the normal path.
# ---------------------------------------------------------------------------


def test_nemo_names_round_trip():
    cfg = small_config()
    sd = state_dict(cfg, seed=9)
    v = convert_torch_state_dict(sd, cfg)
    back = to_torch_state_dict(v, cfg)
    extra = {k for k in back if k.endswith("num_batches_tracked")}
    assert set(back) - extra == set(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t), k
    assert to_fastconformer_state_dict(v).keys() == back.keys()


def test_checkpoint_directory_round_trip(tmp_path):
    cfg = small_config("bfloat16")
    v = convert_fastconformer_state_dict(state_dict(cfg, seed=11), cfg)
    save_checkpoint(tmp_path / "model", v, cfg)
    stored = json.loads((tmp_path / "model" / "config.json").read_text())
    assert stored["architecture"] == "fastconformer_ctc"
    loaded, loaded_cfg = load_checkpoint(tmp_path / "model")
    assert loaded_cfg == cfg
    for a, b in zip(tree_leaves(loaded), tree_leaves(v)):
        assert torch.equal(a, b)
    audio = calls(1.3, 0.7, seed=6)
    out = [OfflineTranscriber(w, cfg, use_offline_forward=True, device="cpu").logprobs(audio)
           for w in (v, loaded)]
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# What the port refuses, and its tracing.
# ---------------------------------------------------------------------------


def test_offline_only_config_is_refused_where_it_cannot_run():
    from tone_tpu_torch.runtime.arena import StreamArena
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    cfg = small_config()
    v = FC.init_fastconformer_params(torch.Generator().manual_seed(0), cfg)
    for make in (lambda: StreamArena(v, cfg, 4, device="cpu"),
                 lambda: MultiStreamEngine(v, cfg, n_slots=4, device="cpu"),
                 lambda: OfflineTranscriber(v, cfg, device="cpu"),
                 lambda: OfflineTranscriber(v, cfg, use_offline_forward=True, device="cpu",
                                            word_timestamps=True)):
        with pytest.raises(ValueError, match="FastConformer|T-one"):
            make()


def test_spans_and_counters_under_record():
    cfg = small_config("bfloat16")
    v = convert_fastconformer_state_dict(state_dict(cfg), cfg)
    audio = calls(1.1, 2.3, 0.5, seed=8)
    wav, lengths = batch(audio)
    t0 = time.monotonic_ns()
    with profiling.record():
        _, out_lens = FC.apply_fastconformer(v, cfg, wav, lengths)
    events = [e for e in profiling.events(t0) if e.name.startswith("fastconformer.")]
    spans = [e for e in events if hasattr(e, "end_ns")]
    counts: dict[str, int] = {}
    for e in events:
        if hasattr(e, "t_ns"):
            counts[e.name] = counts.get(e.name, 0) + e.n
    assert [e.name for e in spans] == ["fastconformer.frontend", "fastconformer.subsampling",
                                       "fastconformer.layer", "fastconformer.layer",
                                       "fastconformer.head"]
    assert [e.id for e in spans if e.name == "fastconformer.layer"] == [0, 1]
    # the CPU runs the plain version: each layer counts rel_blocks' pairs
    keys, blocks = L.rel_blocks(out_lens, cfg.encoder.n_heads)
    assert counts == {
        "fastconformer.frames": sum(out_lens),
        "fastconformer.attention_pairs": 2 * sum(n * n for n in out_lens),
        "fastconformer.attention_pairs_computed":
            2 * keys * sum((hi - lo) * (i1 - i0) for i0, i1, lo, hi in blocks)}
    assert counts["fastconformer.attention_pairs"] <= \
        counts["fastconformer.attention_pairs_computed"]


def test_positional_encoding_is_nemos():
    pe = FC.positional_encoding(5, 8, "cpu")
    r = torch.arange(4, -5, -1, dtype=torch.float64)[:, None]
    w = torch.tensor([10000 ** (-2 * k / 8) for k in range(4)], dtype=torch.float64)
    expect = torch.stack([torch.sin(r * w), torch.cos(r * w)], dim=-1).reshape(9, 8)
    torch.testing.assert_close(pe.double(), expect, rtol=0, atol=1e-6)
    assert dataclasses.is_dataclass(FastConformerConfig) and math.isclose(
        FastConformerConfig().frame_size, 0.08)
