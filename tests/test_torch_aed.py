"""The FastConformer attention encoder-decoder (Canary-1B-v2's architecture)
on the port's bulk path, held to the plain float32 reference
(``benchmark/reference/aed.py``: NeMo's TransformerEmbedding, pre-LN
TransformerDecoder, TokenClassifier and greedy AED decoding written out,
over ``reference/fastconformer.py``'s encoder) on seeded random weights at a
small size: d_model 64, 2 heads, 2 encoder and 2 decoder layers, 32 mels, a
feed-forward of 128, 64 pieces.

Tolerances, each with its reason:

* float32 compute against the reference's full forward: 2e-5 on every
  logit.  The same float32 mathematics, summed in another order: the
  port's q, k and v are one product, each step's attention reads the
  cache, and the reference recomputes every position; the logits are
  about 0.6 apart at this size and the gaps measured 2e-6.
* decisions: the batched, cached loop's tokens equal the one-row
  reference's exactly.  The draws are such that at every step the
  reference's best two logits lie more than 1e-4 apart (each test asserts
  it), so that a float32 difference of another summation order cannot turn
  one over.
* bf16 compute (the served precision) against the reference teacher-forced
  on the program's own tokens: 0.01 RMS over every logit (the logits
  spread by about 0.6; the RMS measured about 0.003).
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
    FASTCONFORMER_AED,
    FASTCONFORMER_CTC,
    AEDConfig,
    FastConformerConfig,
    FastConformerEncoderConfig,
    FastConformerFrontendConfig,
    canary_config,
    config_from_dict,
    stand_in_vocabulary,
)
from tone_tpu_torch.core import aed as AED
from tone_tpu_torch.core import fastconformer as FC
from tone_tpu_torch.interop import to_torch_state_dict
from tone_tpu_torch.offline import OfflineTranscriber
from tone_tpu_torch.ops import norm_junction as NJ

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path, package: bool = False):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, path, submodule_search_locations=[str(path.parent)] if package else None)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def _load_reference():
    """The benchmark's plain AED reference (with the package ``reference``
    it lives in), which imports nothing of the port."""
    _load("reference", ROOT / "benchmark" / "reference" / "__init__.py", package=True)
    import reference.aed as ref

    return ref


R = _load_reference()
EOS = 3


def small_config(dtype: str = "float32", **aed) -> FastConformerConfig:
    return FastConformerConfig(
        frontend=FastConformerFrontendConfig(n_mels=32),
        encoder=FastConformerEncoderConfig(feat_in=32, n_layers=2, d_model=64, n_heads=2,
                                           subsampling_conv_channels=16),
        vocabulary=stand_in_vocabulary(64), compute_dtype=dtype,
        architecture=FASTCONFORMER_AED,
        aed=AEDConfig(**{"n_layers": 2, "hidden": 64, "inner": 128, "n_heads": 2, **aed}))


def sizes(config):
    return R.sizes(json.loads(json.dumps(config.to_dict())))


def state_dict(config: FastConformerConfig, seed: int = 1) -> dict[str, torch.Tensor]:
    """NeMo-named float32 weights drawn as the benchmark draws them."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, leaf in R.param_layout(sizes(config)).items():
        x = (torch.rand(leaf.shape, generator=gen) * 2 - 1) * leaf.scale
        out[name] = x + 1.0 if leaf.kind == "one" else x
    return out


def encoder_outputs(frames, d_model: int, seed: int) -> torch.Tensor:
    """(B, max + 5, d_model) float32 rows standing in for the encoder's,
    each row's frames past its length drawn too (the decoder must not read
    them)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(len(frames), max(frames) + 5, d_model, generator=gen)


def live_rows(record: torch.Tensor) -> list[np.ndarray]:
    """Each row's live tokens, on the host."""
    return [r[r[:, AED.LIVE] > 0, AED.TOKEN].astype(np.int64)
            for r in record.numpy().astype(np.float64)]


def smallest_tie(z: torch.Tensor) -> float:
    top = z.topk(2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).min()) if len(z) else math.inf


def calls(*seconds: float, seed: int = 0) -> list[np.ndarray]:
    """Speech-like int16 calls at 16 kHz: tones under a syllabic envelope
    over noise."""
    rng = np.random.default_rng(seed)
    out = []
    for sec in seconds:
        t = np.arange(int(sec * 16000)) / 16000
        f0 = rng.uniform(100, 250)
        x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
        x *= 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
        x = 6000 * x + rng.normal(0, 300, len(t))
        out.append(np.clip(x, -32768, 32767).astype(np.int16))
    return out


# ---------------------------------------------------------------------------
# Configuration, parameters and names.
# ---------------------------------------------------------------------------


def test_published_sizes_and_parameter_count():
    cfg = canary_config()
    e, a = cfg.encoder, cfg.aed
    assert (e.n_layers, e.d_model, e.n_heads, e.d_ff, e.conv_kernel_size) == (32, 1024, 8, 4096, 9)
    assert (cfg.frontend.n_mels, e.subsampled_feat) == (128, 16)
    assert (a.n_layers, a.hidden, a.inner, a.n_heads, a.d_head) == (8, 1024, 4096, 8, 128)
    assert len(set(cfg.vocabulary)) == 16384 and len(a.prompt) == 9 and a.eos == 3
    assert cfg.architecture == FASTCONFORMER_AED and a.max_tokens(640_000, 16000) == 160
    n = FC.parameter_count(cfg)
    assert n == R.parameter_count(sizes(cfg)) == 978_932_736
    assert abs(n - 978e6) / 978e6 < 0.01          # the model card's 978 M
    bench = json.loads((ROOT / "benchmark/configs/canary-1b-v2.json").read_text())
    assert FastConformerConfig.from_dict(bench["model"]) == cfg


def test_small_parameter_count_matches_the_tree():
    cfg = small_config()
    v = FC.init_fastconformer_params(torch.Generator().manual_seed(0), cfg)
    assert set(v["params"]) == {"encoder", "aed"}
    assert sum(x.numel() for x in tree_leaves(v["params"])) == FC.parameter_count(cfg) \
        == R.parameter_count(sizes(cfg))


def test_config_round_trip_and_refusals():
    cfg = small_config(prompt=(7, 4, 9), window_seconds=2.5)
    d = json.loads(json.dumps(cfg.to_dict()))
    assert d["architecture"] == FASTCONFORMER_AED and "transducer" not in d
    assert d["aed"]["prompt"] == [7, 4, 9]
    assert config_from_dict(d) == cfg and FastConformerConfig.from_dict(d) == cfg
    assert list(FastConformerConfig().to_dict())[-1] == "architecture"
    with pytest.raises(ValueError, match="architecture"):
        FastConformerConfig(aed=AEDConfig())
    with pytest.raises(ValueError, match="architecture"):
        FastConformerConfig(architecture=FASTCONFORMER_AED)
    with pytest.raises(ValueError, match="architecture"):
        FastConformerConfig(architecture="fastconformer_lm")
    with pytest.raises(ValueError, match="d_model"):
        dataclasses.replace(cfg, aed=AEDConfig(hidden=128, n_heads=2))
    for bad in ({"hidden": 100, "n_heads": 8}, {"prompt": ()}, {"window_seconds": 0},
                {"max_tokens_per_second": -1}, {"prompt": (1,) * 5, "max_positions": 5}):
        with pytest.raises(ValueError):
            AEDConfig(**bad)
    # a window's cap: ceil(tokens a second x seconds)
    a = cfg.aed
    assert [a.max_tokens(n, 16000) for n in (0, 1, 4000, 4001, 40000)] == [0, 1, 1, 2, 10]


def test_nemo_names_round_trip():
    cfg = small_config()
    sd = state_dict(cfg, seed=9)
    for name in ("transf_decoder._embedding.token_embedding.weight",
                 "transf_decoder._embedding.layer_norm.bias",
                 "transf_decoder._decoder.layers.1.second_sub_layer.key_net.weight",
                 "transf_decoder._decoder.layers.0.third_sub_layer.dense_out.bias",
                 "transf_decoder._decoder.final_layer_norm.weight",
                 "log_softmax.mlp.layer0.weight"):
        assert name in sd, name
    assert not [k for k in sd if k.startswith("decoder.")]
    v = convert_torch_state_dict(sd, cfg)
    assert set(v["params"]) == {"encoder", "aed"}
    back = to_torch_state_dict(v, cfg)
    extra = {k for k in back if k.endswith("num_batches_tracked")}
    assert set(back) - extra == set(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t), k


def test_checkpoint_directory_round_trip(tmp_path):
    cfg = small_config("bfloat16")
    v = convert_fastconformer_state_dict(state_dict(cfg, seed=11), cfg)
    save_checkpoint(tmp_path / "model", v, cfg)
    loaded, loaded_cfg = load_checkpoint(tmp_path / "model")
    assert loaded_cfg == cfg
    for a, b in zip(tree_leaves(loaded), tree_leaves(v)):
        assert torch.equal(a, b)


def test_positions_table_is_nemos():
    pe = AED.positions_table(50, 64, "cpu")
    assert torch.equal(pe, R.positions(50, 64, "cpu"))
    assert float(pe[0, 1]) == pytest.approx(1 / 8) and float(pe[0, 0]) == 0.0
    assert float(pe[7, 0]) == pytest.approx(math.sin(7) / 8, abs=1e-6)


# ---------------------------------------------------------------------------
# The cached, batched loop against the reference's full forward.
# ---------------------------------------------------------------------------


def _decode(cfg, sd, enc, frames, caps, **kw):
    v = convert_fastconformer_state_dict(sd, cfg)
    return AED.greedy_aed(v, cfg, enc, frames, caps, **kw)[:2]


def test_cached_decode_equals_teacher_forced_reference():
    """Prefill and decoding through the cache, four rows of unequal
    frames: each row's logits are the reference's full forward over the
    prompt and the row's own tokens, and its tokens the reference's
    greedy decoding of its own frames."""
    cfg = small_config()
    s = sizes(cfg)
    sd = state_dict(cfg, seed=3)
    frames, caps = [37, 9, 60, 1], [12, 12, 12, 12]
    enc = encoder_outputs(frames, 64, seed=21)
    record, logits = _decode(cfg, sd, enc, frames, caps, keep=[0, 1, 2, 3])
    for b, (tokens, z) in enumerate(zip(live_rows(record), logits)):
        own = enc[b, :frames[b]]
        expect, expect_z = R.greedy(sd, s, own, caps[b])
        assert smallest_tie(expect_z) > 1e-4
        assert tokens.tolist() == expect and len(tokens) == caps[b]
        forced = R.teacher_forced(sd, s, own, tokens)
        torch.testing.assert_close(z[:len(tokens)], forced, atol=2e-5, rtol=0)
        torch.testing.assert_close(forced, expect_z, atol=2e-5, rtol=0)


def test_uneven_rows_equal_each_row_decoded_alone():
    cfg = small_config()
    sd = state_dict(cfg, seed=4)
    frames, caps = [50, 20, 7], [20, 5, 13]
    enc = encoder_outputs(frames, 64, seed=22)
    record, logits = _decode(cfg, sd, enc, frames, caps, keep=[0, 1, 2])
    assert record.shape == (3, 20, len(AED.FIELDS))
    for b in range(3):
        alone, alone_z = _decode(cfg, sd, enc[b:b + 1, :frames[b]], frames[b:b + 1],
                                 caps[b:b + 1], keep=[0])
        assert live_rows(alone)[0].tolist() == live_rows(record)[b].tolist()
        n = caps[b]
        torch.testing.assert_close(logits[b][:n], alone_z[0][:n], atol=2e-5, rtol=0)
        # past its cap a row is not live
        assert int(record[b, :, AED.LIVE].sum()) == n


def _eos_raised(sd, s, raise_by: float) -> dict:
    sd = dict(sd)
    bias = sd["log_softmax.mlp.layer0.bias"].clone()
    bias[s.eos] += raise_by
    sd["log_softmax.mlp.layer0.bias"] = bias
    return sd


def test_eos_stops_rows_at_different_steps_and_the_rest_go_on():
    """With the bias of ``<|endoftext|>`` raised, rows stop at it at
    different steps; a stopped row's record ends there, the others go on
    and each row's tokens equal its decoding alone."""
    cfg = small_config()
    s = sizes(cfg)
    sd = _eos_raised(state_dict(cfg, seed=5), s, 0.5)
    frames, caps = [40, 33, 18, 25, 12, 51], [30] * 6
    enc = encoder_outputs(frames, 64, seed=23)
    record, _ = _decode(cfg, sd, enc, frames, caps)
    rows = live_rows(record)
    stops = [len(r) for r in rows if len(r) and r[-1] == s.eos]
    assert len(set(stops)) >= 4 and max(len(r) for r in rows) == 30, [len(r) for r in rows]
    for b, tokens in enumerate(rows):
        assert R.stop_errors(record[b, :, AED.LIVE].numpy() > 0, record[b, :, AED.TOKEN].numpy(),
                             caps[b], s.eos) == 0
        expect, _ = R.greedy(sd, s, enc[b, :frames[b]], caps[b])
        assert tokens.tolist() == expect
    # the loop ran past the last stop by fewer than CHECK_EVERY steps
    assert record.shape[1] < max(len(r) for r in rows) + AED.CHECK_EVERY


def test_cap_stops_a_row_and_its_tokens_are_a_prefix():
    cfg = small_config()
    s = sizes(cfg)
    sd = state_dict(cfg, seed=6)
    frames = [30, 30]
    enc = encoder_outputs(frames, 64, seed=24)
    short, _ = _decode(cfg, sd, enc, frames, [3, 17])
    long, _ = _decode(cfg, sd, enc, frames, [17, 17])
    a, b = live_rows(short), live_rows(long)
    assert len(a[0]) == 3 and a[0].tolist() == b[0][:3].tolist() and a[1].tolist() == b[1].tolist()
    assert R.stop_errors(short[0, :, AED.LIVE].numpy() > 0, short[0, :, AED.TOKEN].numpy(), 3,
                         s.eos) == 0
    # a cap of 0 runs no live step
    none, _ = _decode(cfg, sd, enc[:1], frames[:1], [0])
    assert int(none[..., AED.LIVE].sum()) == 0


def test_stop_rules_catch_broken_stops():
    live, tokens = np.array([1, 1, 1, 0]) > 0, np.array([5, 6, 3, 8])
    assert R.stop_errors(live, tokens, 10, EOS) == 0        # stopped at eos
    assert R.stop_errors(live, np.array([5, 6, 7, 8]), 3, EOS) == 0    # at its cap
    assert R.stop_errors(live, np.array([5, 6, 7, 8]), 10, EOS) == 1   # short of both
    assert R.stop_errors(live, np.array([5, 3, 7, 8]), 10, EOS) == 1   # past eos
    assert R.stop_errors(live, tokens, 2, EOS) == 1                    # past its cap
    assert R.stop_errors(np.array([1, 0, 1, 0]) > 0, tokens, 10, EOS) == 1   # not a prefix
    assert R.stop_errors(np.zeros(4, bool), tokens, 0, EOS) == 0


def test_a_row_reading_another_rows_frames_fails_the_comparison():
    """The fault the benchmark's comparison must catch: with each row's
    cross-attention given the next row's frames, its logits leave the
    reference's teacher-forced ones by far more than the tolerance."""
    cfg = small_config()
    s = sizes(cfg)
    sd = state_dict(cfg, seed=7)
    frames, caps = [30, 22, 41], [8, 8, 8]
    enc = encoder_outputs(frames, 64, seed=25)
    rolled, rolled_frames = enc.roll(-1, 0), frames[1:] + frames[:1]
    record, logits = _decode(cfg, sd, rolled, rolled_frames, caps, keep=[0, 1, 2])
    for b, (tokens, z) in enumerate(zip(live_rows(record), logits)):
        forced = R.teacher_forced(sd, s, enc[b, :frames[b]], tokens)
        assert float((z[:len(tokens)] - forced).pow(2).mean().sqrt()) > 100 * 2e-5


def test_kept_memory_is_each_rows_own_cross_keys_and_values():
    """The cross-attention keys and values the loop returns for the kept
    rows are the reference's projections of each row's own frames
    (float32); with each row given the next row's frames, every row's are
    off by a large share of their size."""
    cfg = small_config()
    s = sizes(cfg)
    sd = state_dict(cfg, seed=8)
    frames, caps = [30, 22, 41], [4, 4, 4]
    enc = encoder_outputs(frames, 64, seed=28)
    v = convert_fastconformer_state_dict(sd, cfg)
    _, _, memory = AED.greedy_aed(v, cfg, enc, frames, caps, keep=[2, 0])
    for b, m in zip([2, 0], memory):
        want = R.cross_memory(sd, s, enc[b, :frames[b]])
        assert m.shape == want.shape == (2, cfg.aed.n_layers, frames[b], cfg.aed.hidden)
        torch.testing.assert_close(m, want, atol=1e-5, rtol=0)
    rolled, rolled_frames = enc.roll(-1, 0), frames[1:] + frames[:1]
    _, _, memory = AED.greedy_aed(v, cfg, rolled, rolled_frames, caps, keep=[0, 1, 2])
    for b, m in enumerate(memory):
        want = R.cross_memory(sd, s, enc[b, :frames[b]])
        n = min(m.shape[2], want.shape[2])
        gap = (m[:, :, :n] - want[:, :, :n]).pow(2).mean().sqrt()
        assert float(gap / want.pow(2).mean().sqrt()) > 0.5


def test_graphed_decoder_buffers(monkeypatch):
    """``GraphedDecoder`` around its graph (captured only on a card; here
    its steps replayed eagerly): batches of other rows, frames and caps
    filled into its state, its capacity grown in steps of 128 frames and
    kept, the rows it holds beyond a batch's left alone; each batch's
    record and kept logits equal the eager loop's over the rows' live
    steps (the host reads whether a row is live one replay late, so the
    graph may run one replay more)."""
    class Eager:
        def __init__(self, steps, device):
            self.replay = steps
    monkeypatch.setattr(AED.GraphedDecoder, "_graph", staticmethod(Eager))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    cfg = small_config()
    sd = _eos_raised(state_dict(cfg, seed=8), sizes(cfg), 0.5)
    v = convert_fastconformer_state_dict(sd, cfg)
    graphed = AED.GraphedDecoder(v, cfg)
    for frames, caps, capacity in (([37, 9, 60, 1], [9, 20, 4, 1], (4, 128)),
                                   ([300, 2], [33, 2], (4, 384)),
                                   ([5, 40, 7], [6, 6, 40], (4, 384))):
        enc = encoder_outputs(frames, 64, seed=len(frames))
        eager, eager_z, _ = AED.greedy_aed(v, cfg, enc, frames, caps, keep=[0, 1])
        replayed, replayed_z, _ = AED.greedy_aed(v, cfg, enc, frames, caps, keep=[0, 1],
                                              graphed=graphed)
        assert (graphed.rows, graphed.frames) == capacity
        assert [r.tolist() for r in live_rows(eager)] == [r.tolist() for r in live_rows(replayed)]
        for a, b, tokens in zip(eager_z, replayed_z, live_rows(eager)):
            torch.testing.assert_close(a[:len(tokens)], b[:len(tokens)], atol=1e-6, rtol=0)
        # the graph runs CHECK_EVERY steps at a time, each at a cached position
        assert replayed.shape[1] % AED.CHECK_EVERY == 0
        assert graphed.positions >= len(cfg.aed.prompt) - 1 + replayed.shape[1]


# ---------------------------------------------------------------------------
# The transcriber: windows, phrases, refusals, tracing.
# ---------------------------------------------------------------------------


def _records(tr):
    """Wrap the transcriber's wait: each window's record, frames and kept
    logits (None where not kept), and each batch's rows computed."""
    kept, rows = {}, []
    wait = tr._wait

    def keeping(launched):
        idx, windows, record = wait(launched)
        rows.append(windows.rows)
        for row, key in enumerate(windows.keys):
            kept[key] = (record[row].astype(np.float64), int(windows.frames[row]),
                         windows.kept.get(key, (None,))[0])
        return idx, windows, record
    tr._wait = keeping
    return kept, rows


def test_windows_come_back_as_phrases_in_call_order():
    """Calls of 3.3, 0.7 and 5.1 s in windows of at most 2 s, batched 2 at
    a time out of order: one phrase per window with text, in call order,
    timed at the window's bounds, its text the joining of the window's own
    tokens; each window's tokens the reference's greedy decoding of its
    audio alone."""
    cfg = small_config(window_seconds=2.0, max_tokens_per_second=3.0)
    s = sizes(cfg)
    sd = state_dict(cfg, seed=11)
    tr = OfflineTranscriber(convert_fastconformer_state_dict(sd, cfg), cfg,
                            use_offline_forward=True, batch_size=2, device="cpu")
    kept, _ = _records(tr)
    tr.keep_logits = {(2, 1), (0, 0)}
    audio = calls(3.3, 0.7, 5.1, seed=2)
    out = tr.transcribe(audio)
    assert sorted(kept) == [(0, 0), (0, 1), (1, 0), (2, 0), (2, 1), (2, 2)]
    assert {key for key, (_, _, z) in kept.items() if z is not None} == {(2, 1), (0, 0)}
    for i, call in enumerate(audio):
        pieces = R.windows(call, s)
        want = []
        for k, piece in enumerate(pieces):
            record, n, z = kept[(i, k)]
            tokens = record[record[:, AED.LIVE] > 0, AED.TOKEN].astype(np.int64)
            enc = R.encode(sd, s, torch.from_numpy(piece.astype(np.float32) / 32767.0))
            assert enc.shape[0] == n == cfg.output_frames(len(piece))
            expect, expect_z = R.greedy(sd, s, enc, s.cap(len(piece)))
            assert smallest_tie(expect_z) > 1e-4
            assert tokens.tolist() == expect
            if z is not None:
                torch.testing.assert_close(z[:len(tokens)], expect_z, atol=2e-5, rtol=0)
            text = R.window_text(tokens, s.enc.pieces, s.eos)
            if text:
                want.append((text, round(2.0 * k, 2), round(2.0 * k + len(piece) / 16000, 2)))
        assert [(p.text, p.start_time, p.end_time) for p in out[i]] == want and want


def test_bf16_path_against_teacher_forced_reference():
    cfg = small_config("bfloat16")
    s = sizes(cfg)
    sd = state_dict(cfg, seed=12)
    frames, caps = [44, 17, 30], [15, 15, 9]
    enc = encoder_outputs(frames, 64, seed=26)
    v = convert_fastconformer_state_dict(sd, cfg)
    from tone_tpu_torch.acoustic import cast_params_for_inference

    record, logits, _ = AED.greedy_aed(cast_params_for_inference(v, cfg), cfg,
                                    enc.to(torch.bfloat16), frames, caps, keep=[0, 1, 2])
    squares = count = 0
    for b, (tokens, z) in enumerate(zip(live_rows(record), logits)):
        forced = R.teacher_forced(sd, s, enc[b, :frames[b]].to(torch.bfloat16).float(), tokens)
        assert z.dtype == torch.float32
        squares += float((z[:len(tokens)] - forced).pow(2).sum())
        count += forced.numel()
    assert count and (squares / count) ** 0.5 < 0.01


def test_aed_refusals():
    cfg = small_config()
    v = FC.init_fastconformer_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="transducer"):
        OfflineTranscriber(v, cfg, use_offline_forward=True, device="cpu", decoder=object())
    tr = OfflineTranscriber(v, cfg, use_offline_forward=True, device="cpu")
    with pytest.raises(ValueError, match="transducer"):
        tr.logprobs(calls(0.5))
    for make in (lambda: OfflineTranscriber(v, cfg, device="cpu"),
                 lambda: OfflineTranscriber(v, cfg, use_offline_forward=True, device="cpu",
                                            word_timestamps=True)):
        with pytest.raises(ValueError, match="FastConformer|T-one"):
            make()
    enc = encoder_outputs([5], 64, seed=1)
    with pytest.raises(ValueError, match="positions"):
        AED.greedy_aed(v, cfg, enc, [5], [cfg.aed.max_positions])


def test_ctc_head_is_untouched_by_the_decoder():
    """The encoder both heads share: a CTC config made from the AED's
    encoder has a head and no decoder, its dict as before decoders."""
    cfg = dataclasses.replace(small_config(), architecture=FASTCONFORMER_CTC, aed=None)
    v = FC.init_fastconformer_params(torch.Generator().manual_seed(1), cfg)
    assert set(v["params"]) == {"encoder", "head"} and cfg.architecture == FASTCONFORMER_CTC
    assert "aed" not in cfg.to_dict()


def test_transcriber_counts_its_batches():
    """Under ``profiling.record()`` the transcriber counts each batch's
    steps from its record on the host: every window's live steps, the
    batches' rows times their steps."""
    cfg = small_config(window_seconds=2.0, max_tokens_per_second=3.0)
    tr = OfflineTranscriber(convert_fastconformer_state_dict(state_dict(cfg, seed=11), cfg),
                            cfg, use_offline_forward=True, batch_size=2, device="cpu")
    kept, rows = _records(tr)
    t0 = time.monotonic_ns()
    with profiling.record():
        tr.transcribe(calls(3.3, 0.7, 5.1, seed=2))
    counts: dict = {}
    for e in profiling.events(t0):
        if hasattr(e, "t_ns") and e.name.startswith(("aed.", "fastconformer.junction_bytes")):
            counts[e.name] = counts.get(e.name, 0) + e.n
    live = sum(int((r[:, AED.LIVE] > 0).sum()) for r, _, _ in kept.values())
    assert counts["aed.row_steps"] == live == counts["aed.emitted"] > 0
    # eagerly the loop computes each batch's own rows: six windows two at a time
    assert rows == [2, 2, 2]
    assert live <= counts["aed.steps_computed"] == sum(r.size // 2 for r, _, _ in kept.values())
    # the encoder's junctions over the windows' frames, and the decoder's
    encoder = sum(n for _, n, _ in kept.values()) * cfg.encoder.d_model \
        * NJ.layer_bytes(cfg.encoder.n_layers)
    assert counts["fastconformer.junction_bytes"] == encoder + AED.junction_bytes(cfg, len(kept),
                                                                                  live)
    spans = [e.name for e in profiling.events(t0) if hasattr(e, "end_ns")]
    assert spans.count("aed.prefill") == spans.count("aed.decode") == 3


def test_spans_and_counters_under_record():
    bench_bytes = _load("bytes_aed", ROOT / "benchmark/harness/bytes_aed.py")
    cfg = small_config()
    s = sizes(cfg)
    sd = _eos_raised(state_dict(cfg, seed=13), s, 0.6)
    frames, caps = [37, 9, 60, 1], [20, 7, 20, 3]
    enc = encoder_outputs(frames, 64, seed=27)
    t0 = time.monotonic_ns()
    record, _ = _decode(cfg, sd, enc, frames, caps)
    AED.count_steps(cfg, record.numpy(), frames, len(frames))
    assert not [e for e in profiling.events(t0) if e.name.startswith("aed.")]
    with profiling.record():
        record, _ = _decode(cfg, sd, enc, frames, caps)
        AED.count_steps(cfg, record.numpy(), frames, 6)
    events = [e for e in profiling.events(t0) if e.name.startswith("aed.")]
    assert [e.name for e in events if hasattr(e, "end_ns")] == ["aed.prefill", "aed.decode"]
    counts = {e.name: e.n for e in events if hasattr(e, "t_ns")}
    live = record[..., AED.LIVE].numpy() > 0
    tokens = record[..., AED.TOKEN].numpy()
    # the rows computed, as a graph of 6 rows would count them
    assert counts["aed.steps_computed"] == 6 * record.shape[1]
    assert counts["aed.row_steps"] == int(live.sum()) < counts["aed.steps_computed"]
    assert counts["aed.emitted"] == int((live & (tokens != s.eos)).sum())
    assert counts["aed.step_bytes"] == bench_bytes.step_bytes(s, 4, live, frames) \
        == AED.step_bytes(cfg, live, frames) > 0
    # at the published sizes in bf16, on a made-up pattern of live steps
    big = canary_config()
    rng = np.random.default_rng(0)
    live = rng.random((16, 40)) < 0.8
    frames = rng.integers(1, 502, 16).tolist()
    assert AED.step_bytes(big, live, frames) == bench_bytes.step_bytes(
        R.sizes(json.loads(json.dumps(big.to_dict()))), 2, live, frames)
