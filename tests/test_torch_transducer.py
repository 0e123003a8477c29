"""The FastConformer token-and-duration transducer (Parakeet-TDT-0.6B-v3's
architecture) on the port's bulk path, held to the plain float32
reference (``benchmark/reference/transducer.py``: NeMo's RNNTDecoder,
RNNTJoint and greedy TDT written out, over ``reference/fastconformer.py``'s
encoder) on seeded random weights at a small size: d_model 64, 2 heads, 2
layers, 32 mels, prediction network and joint of 32, 40 pieces.

Tolerances, each with its reason:

* float32 compute against the reference: 1e-5 on the joint's logits and
  the prediction network's outputs (the same float32 mathematics; the
  LSTM's two products are one product of [x, h] in the port, so the sums
  run in another order).
* decisions: the batched loop's tokens, frames and durations equal the
  one-row reference's exactly.  The draws are chosen so that at every
  step of the reference the best two token logits, and the best two
  duration logits, lie more than 1e-4 apart (each test asserts it), so
  that a float32 difference of another summation order cannot turn one
  over.
* bf16 compute (the served precision) against the reference replayed
  along the program's own path: 0.01 RMS on the chosen logits (the
  logits are about 0.3 apart at this size and the RMS measured 0.0019).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
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
    FASTCONFORMER_CTC,
    FASTCONFORMER_TDT,
    FastConformerConfig,
    FastConformerEncoderConfig,
    FastConformerFrontendConfig,
    TransducerConfig,
    config_from_dict,
    parakeet_tdt_config,
    stand_in_vocabulary,
)
from tone_tpu_torch.core import fastconformer as FC
from tone_tpu_torch.core import transducer as TD
from tone_tpu_torch.interop import to_torch_state_dict
from tone_tpu_torch.offline import OfflineTranscriber

ROOT = Path(__file__).resolve().parents[1]


def _load_reference():
    """The benchmark's plain transducer reference (with the package
    ``reference`` it lives in), which imports nothing of the port."""
    pkg = ROOT / "benchmark" / "reference"
    if "reference" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "reference", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        module = importlib.util.module_from_spec(spec)
        sys.modules["reference"] = module
        spec.loader.exec_module(module)
    import reference.transducer as ref

    return ref


R = _load_reference()


def small_config(dtype: str = "float32", **transducer) -> FastConformerConfig:
    return FastConformerConfig(
        frontend=FastConformerFrontendConfig(n_mels=32),
        encoder=FastConformerEncoderConfig(feat_in=32, n_layers=2, d_model=64, n_heads=2,
                                           subsampling_conv_channels=16),
        vocabulary=stand_in_vocabulary(40), compute_dtype=dtype,
        architecture=FASTCONFORMER_TDT,
        transducer=TransducerConfig(pred_hidden=32, joint_hidden=32, **transducer))


def sizes(config):
    return R.sizes(json.loads(json.dumps(config.to_dict())))


def state_dict(config: FastConformerConfig, seed: int = 1) -> dict[str, torch.Tensor]:
    """NeMo-named float32 weights drawn as the benchmark draws them."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, leaf in R.param_layout(sizes(config)).items():
        x = (torch.rand(leaf.shape, generator=gen) * 2 - 1) * leaf.scale
        out[name] = x + 1.0 if leaf.kind == "one" else x
    out["decoder.prediction.embed.weight"][-1] = 0.0
    return out


def varied_state_dict(config: FastConformerConfig) -> dict[str, torch.Tensor]:
    """``state_dict`` of seed 3 with the blank's joint bias raised by 0.5:
    on ``encoder_outputs`` of seed 21 its decoding takes blanks, tokens
    and steps that stay on their frame (33, 106 and 74 of 139 steps)."""
    sd = state_dict(config, seed=3)
    sd["joint.joint_net.2.bias"][len(config.vocabulary)] += 0.5
    return sd


def encoder_outputs(lengths, d_model: int, seed: int) -> torch.Tensor:
    """(B, max + 3, d_model) float32 rows standing in for the encoder's,
    each row's frames past its length drawn too (the loop must not read
    them)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(len(lengths), max(lengths) + 3, d_model, generator=gen)


def rows(record: torch.Tensor) -> list[np.ndarray]:
    """Each row's active steps of the loop's record, on the host."""
    out = []
    for r in record.numpy().astype(np.float64):
        out.append(r[r[:, TD.ACTIVE] > 0])
    return out


def widest_tie(sd, s, enc, steps) -> float:
    """The smallest gap, over the steps, between the reference's best two
    token logits or its best two duration logits."""
    z = R.replay(sd, s, enc, steps[:, 0].astype(np.int64), steps[:, 1].astype(np.int64))
    top_t = z[:, :s.blank + 1].topk(2).values
    top_d = z[:, s.blank + 1:].topk(2).values
    return float(torch.minimum(top_t[:, 0] - top_t[:, 1], top_d[:, 0] - top_d[:, 1]).min())


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
    cfg = parakeet_tdt_config()
    e, t = cfg.encoder, cfg.transducer
    assert (e.n_layers, e.d_model, e.n_heads, e.d_ff, e.conv_kernel_size) == (24, 1024, 8, 4096, 9)
    assert (cfg.frontend.n_mels, e.feat_in, e.subsampled_feat) == (128, 128, 16)
    assert (t.pred_hidden, t.pred_rnn_layers, t.joint_hidden) == (640, 2, 640)
    assert t.durations == (0, 1, 2, 3, 4) and t.max_symbols == 10
    assert cfg.vocab_size_with_blank == 8193 and len(set(cfg.vocabulary)) == 8192
    assert FC.parameter_count(cfg) == R.parameter_count(sizes(cfg)) == 627_450_502
    bench = json.loads((ROOT / "benchmark/configs/parakeet-tdt-0.6b-v3.json").read_text())
    assert FastConformerConfig.from_dict(bench["model"]) == cfg


def test_small_parameter_count_matches_the_tree():
    cfg = small_config()
    v = FC.init_fastconformer_params(torch.Generator().manual_seed(0), cfg)
    assert sum(x.numel() for x in tree_leaves(v["params"])) == FC.parameter_count(cfg)
    assert float(v["params"]["decoder"]["embed"][-1].abs().max()) == 0.0


def test_config_round_trip_and_refusals():
    cfg = small_config()
    d = json.loads(json.dumps(cfg.to_dict()))
    assert d["architecture"] == FASTCONFORMER_TDT
    assert d["transducer"]["durations"] == [0, 1, 2, 3, 4]
    assert config_from_dict(d) == cfg and FastConformerConfig.from_dict(d) == cfg
    # a CTC config's dict is what it was before transducers
    ctc = FastConformerConfig().to_dict()
    assert list(ctc) == ["frontend", "encoder", "vocabulary", "compute_dtype", "architecture"]
    assert ctc["architecture"] == FASTCONFORMER_CTC
    with pytest.raises(ValueError, match="architecture"):
        FastConformerConfig(transducer=TransducerConfig())
    with pytest.raises(ValueError, match="architecture"):
        FastConformerConfig(architecture=FASTCONFORMER_TDT)
    for bad in ({"durations": ()}, {"durations": (-1, 1)}, {"max_symbols": 0}):
        with pytest.raises(ValueError):
            TransducerConfig(**bad)


def test_nemo_names_round_trip():
    cfg = small_config()
    sd = state_dict(cfg, seed=9)
    assert "decoder.prediction.dec_rnn.lstm.weight_hh_l1" in sd and "joint.joint_net.2.bias" in sd
    v = convert_torch_state_dict(sd, cfg)
    assert set(v["params"]) == {"encoder", "decoder", "joint"}
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


# ---------------------------------------------------------------------------
# The prediction network, the joint and the loop against the reference.
# ---------------------------------------------------------------------------


def test_prediction_network_and_joint_against_reference():
    cfg = small_config()
    s = sizes(cfg)
    sd = state_dict(cfg, seed=3)
    v = convert_fastconformer_state_dict(sd, cfg)
    w = TD._weights(v["params"], torch.float32)
    tokens = [[s.blank, s.blank, s.blank], [5, 0, 39], [17, 17, 2]]
    h, c = torch.zeros(2, 3, 32), torch.zeros(2, 3, 32)
    ref_states = [R.start_state(s, "cpu") for _ in range(3)]
    enc = torch.randn(3, 64, generator=torch.Generator().manual_seed(4))
    f = TD._project(w["enc"], enc)
    for column in tokens:
        h, c = TD.prediction_step(w, torch.tensor(column), h, c)
        z = TD.joint_logits(w, f, TD._project(w["pred"], h[-1]), torch.empty(3, 32))
        for b, tok in enumerate(column):
            ref_h, ref_states[b] = R.lstm_step(sd, s, tok, ref_states[b])
            ref_z = R.joint(sd, R.project_encoder(sd, enc[b]), R.project_prediction(sd, ref_h))
            torch.testing.assert_close(h[-1, b], ref_h, atol=1e-5, rtol=0)
            for layer in range(2):
                torch.testing.assert_close(h[layer, b], ref_states[b][layer][0], atol=1e-5, rtol=0)
                torch.testing.assert_close(c[layer, b], ref_states[b][layer][1], atol=1e-5, rtol=0)
            torch.testing.assert_close(z[b], ref_z, atol=1e-5, rtol=0)
    assert z.shape == (3, s.n_out)


def test_batched_loop_equals_one_row_reference_on_unequal_rows():
    """Rows of 37, 9, 60 and 1 frames in one batch: each row's tokens,
    frames and durations are the one-row reference's, its logits within
    1e-5, and no step of the draw is within 1e-4 of a tie."""
    cfg = small_config()
    s = sizes(cfg)
    sd = varied_state_dict(cfg)
    v = convert_fastconformer_state_dict(sd, cfg)
    lengths = [37, 9, 60, 1]
    enc = encoder_outputs(lengths, 64, seed=21)
    record = TD.greedy_tdt(v, cfg, enc, lengths)
    assert record.shape[-1] == len(TD.FIELDS)
    seen_blank = seen_stay = 0
    for b, (steps, n) in enumerate(zip(rows(record), lengths)):
        expect = R.greedy(sd, s, enc[b, :n])
        assert widest_tie(sd, s, enc[b, :n], expect) > 1e-4
        np.testing.assert_array_equal(steps[:, :3], expect[:, :3])
        np.testing.assert_allclose(steps[:, 3:5], expect[:, 3:5], atol=1e-5, rtol=0)
        assert R.path_errors(steps[:, 0], steps[:, 1], steps[:, 2], n, s) == 0
        seen_blank += int((steps[:, 1] == s.blank).sum())
        seen_stay += int((np.diff(steps[:, 0]) == 0).sum())
    # the draw takes every kind of step
    assert seen_blank and seen_stay


def test_row_that_ends_while_others_decode_is_left_alone():
    cfg = small_config()
    v = convert_fastconformer_state_dict(varied_state_dict(cfg), cfg)
    enc = encoder_outputs([60, 9], 64, seed=21)
    both = rows(TD.greedy_tdt(v, cfg, enc, [60, 9]))
    alone = rows(TD.greedy_tdt(v, cfg, enc[1:, :9], [9]))
    # the same decisions; the logits within float32's rounding of sums of
    # another batch shape
    np.testing.assert_array_equal(both[1][:, :3], alone[0][:, :3])
    np.testing.assert_allclose(both[1][:, 3:5], alone[0][:, 3:5], atol=1e-6, rtol=0)
    full = TD.greedy_tdt(v, cfg, enc, [60, 9])
    # the short row's steps after its end are marked and left out
    assert int(full[1, :, TD.ACTIVE].sum()) == len(alone[0]) < full.shape[1]


def test_graphed_loop_buffers(monkeypatch):
    """``GraphedLoop`` around its graph (captured only on a card; here its
    steps replayed eagerly): batches of other rows and frames copied into
    its buffers, its capacity grown in steps of 256 frames and kept, the
    rows it holds beyond a batch's left alone; each batch's record equals
    the eager loop's."""
    class Eager:
        def __init__(self, steps, device):
            self.replay = steps
    monkeypatch.setattr(TD.GraphedLoop, "_graph", staticmethod(Eager))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    cfg = small_config()
    v = convert_fastconformer_state_dict(varied_state_dict(cfg), cfg)
    graphed = TD.GraphedLoop(v, cfg)
    for lengths, capacity in (([37, 9, 60, 1], (4, 256)), ([300, 2], (4, 512)),
                              ([5, 40, 7], (4, 512))):
        enc = encoder_outputs(lengths, 64, seed=len(lengths))
        eager = TD.greedy_tdt(v, cfg, enc, lengths)
        replayed = TD.greedy_tdt(v, cfg, enc, lengths, graphed)
        assert (graphed.rows, graphed.frames) == capacity
        for a, b in zip(rows(eager), rows(replayed)):
            np.testing.assert_array_equal(a[:, :3], b[:, :3])
            np.testing.assert_allclose(a[:, 3:5], b[:, 3:5], atol=1e-6, rtol=0)
        # the graph runs CHECK_EVERY steps at a time
        assert replayed.shape[1] % TD.CHECK_EVERY == 0


def _joint_bias(sd, s, token: int, duration: int):
    """Weights whose joint always picks ``token`` and duration index
    ``duration`` by a margin of 50."""
    sd = dict(sd)
    bias = torch.zeros(s.n_out)
    bias[token] = 50.0
    bias[s.blank + 1 + duration] = 50.0
    sd["joint.joint_net.2.bias"] = bias
    return sd


@pytest.mark.parametrize("case", ["blank_duration_0", "max_symbols_cap"])
def test_forced_cases_set_by_weights(case):
    cfg = small_config(max_symbols=3)
    s = sizes(cfg)
    token = s.blank if case == "blank_duration_0" else 7
    sd = _joint_bias(state_dict(cfg, seed=2), s, token, 0)
    v = convert_fastconformer_state_dict(sd, cfg)
    lengths = [5, 2]
    enc = encoder_outputs(lengths, 64, seed=3)
    for b, (steps, n) in enumerate(zip(rows(TD.greedy_tdt(v, cfg, enc, lengths)), lengths)):
        if case == "blank_duration_0":
            # a blank with duration 0 advances one frame; the row emits nothing
            np.testing.assert_array_equal(steps[:, 0], np.arange(n))
            assert (steps[:, 1] == s.blank).all()
        else:
            # three tokens on a frame, then the row moves on
            np.testing.assert_array_equal(steps[:, 0], np.repeat(np.arange(n), 3))
            assert (steps[:, 1] == 7).all()
        assert R.path_errors(steps[:, 0], steps[:, 1], steps[:, 2], n, s) == 0
        np.testing.assert_array_equal(steps[:, :3], R.greedy(sd, s, enc[b, :n])[:, :3])


def test_path_rules_catch_a_broken_path():
    s = sizes(small_config(max_symbols=3))
    frames, tokens, durs = np.array([0, 2, 2, 3]), np.array([1, 2, 3, 4]), np.array([2, 0, 1, 4])
    assert R.path_errors(frames, tokens, durs, 7, s) == 0    # 0 -> 2, stay, 2 -> 3 -> 7
    assert R.path_errors(frames, tokens, durs, 8, s) == 1    # stops short of frame 8
    assert R.path_errors(frames, tokens, durs, 3, s) == 1    # a step at frame 3 of 3
    assert R.path_errors(frames[[0, 2, 3]], tokens[[0, 2, 3]], durs[[0, 2, 3]], 7, s) == 0
    assert R.path_errors(np.array([1, 3]), tokens[:2], np.array([2, 4]), 7, s) == 1
    # a blank of duration 0 advances one frame, so the third step is off
    assert R.path_errors(frames, np.full(4, s.blank), durs, 7, s) == 1
    # the fourth token with duration 0 on one frame is past max_symbols' cap
    stay = np.zeros(4, np.int64)
    assert R.path_errors(stay, tokens, stay, 1, s) == 2     # and it stops short of frame 1
    assert R.path_errors(np.array([0, 0, 0, 1]), tokens, stay, 2, s) == 1


# ---------------------------------------------------------------------------
# The transcriber.
# ---------------------------------------------------------------------------


def _records(tr):
    """Wrap the transcriber's wait: each call's record and frames."""
    kept = {}
    wait = tr._wait

    def keeping(launched):
        idx, row_frames, record = wait(launched)
        for row, i in enumerate(idx):
            steps = record[row].astype(np.float64)
            kept[int(i)] = (steps[steps[:, TD.ACTIVE] > 0], int(row_frames[row]))
        return idx, row_frames, record
    tr._wait = keeping
    return kept


def test_transcriber_against_reference():
    """Whole calls through encoder and loop in float32: each call's steps
    are the reference's greedy decoding of its own encoding, and its texts
    the plain splitting and joining of its tokens."""
    cfg = small_config()
    s = sizes(cfg)
    sd = state_dict(cfg, seed=7)
    tr = OfflineTranscriber(convert_fastconformer_state_dict(sd, cfg), cfg,
                            use_offline_forward=True, batch_size=3, device="cpu")
    kept = _records(tr)
    audio = calls(2.2, 0.6, 4.1, 1.3, seed=2)
    out = tr.transcribe(audio)
    assert sorted(kept) == [0, 1, 2, 3]
    for i, call in enumerate(audio):
        steps, n = kept[i]
        enc = R.encode(sd, s, torch.from_numpy(call.astype(np.float32) / 32767.0))
        assert enc.shape[0] == n == cfg.output_frames(len(call))
        expect = R.greedy(sd, s, enc)
        assert widest_tie(sd, s, enc, expect) > 1e-4
        np.testing.assert_array_equal(steps[:, :3], expect[:, :3])
        np.testing.assert_allclose(steps[:, 3:5], expect[:, 3:5], atol=1e-4, rtol=0)
        emitted = steps[:, 1] != s.blank
        texts = R.phrase_texts(steps[emitted, 1].astype(int), steps[emitted, 0].astype(int), n,
                               s.enc.pieces)
        assert [p.text for p in out[i]] == texts and texts
        assert out[i][0].start_time == pytest.approx(0.08 * steps[emitted, 0].min())


def test_phrases_split_at_twenty_frames_without_a_token():
    """Tokens at frames 0-4 and 30-32 of 60: two phrases (a gap of 25
    frames), times from the token frames at 80 ms; a gap of 19 keeps one."""
    cfg = small_config()
    tr = OfflineTranscriber(FC.init_fastconformer_params(torch.Generator().manual_seed(0), cfg),
                            cfg, use_offline_forward=True, device="cpu")
    blank = cfg.vocab_size_with_blank - 1

    def finished(frames, tokens, n):
        record = np.zeros((1, len(frames) + 1, len(TD.FIELDS)), np.float32)
        record[0, :len(frames), TD.FRAME] = frames
        record[0, :len(frames), TD.TOKEN] = tokens
        record[0, :len(frames), TD.ACTIVE] = 1
        record[0, -1, TD.TOKEN] = blank   # an inactive step
        results = [None]
        tr._finish_tokens(([0], [n], torch.from_numpy(record), [], 0), results)
        return results[0]

    pieces = cfg.vocabulary
    two = finished([0, 1, 4, 30, 30, 32], [0, 1, 2, 4, 5, 6], 60)
    joined = ["".join(pieces[k] for k in ks).replace("▁", " ").strip() for ks in ((0, 1, 2), (4, 5, 6))]
    assert [p.text for p in two] == joined
    assert (two[0].start_time, two[0].end_time) == (0.0, 0.4)
    assert (two[1].start_time, two[1].end_time) == (2.4, 2.64)
    one = finished([0, 1, 4, 24], [0, 1, 2, 4], 60)
    assert len(one) == 1 and (one[0].start_time, one[0].end_time) == (0.0, 2.0)
    assert finished([], [], 60) == []


def test_bf16_path_against_replayed_reference():
    """The served precision on the CPU (products widened): the reference
    replayed along the program's own path; the chosen logits' RMS gap is
    bf16 rounding's."""
    cfg = small_config("bfloat16")
    s = sizes(cfg)
    sd = state_dict(cfg, seed=7)
    tr = OfflineTranscriber(convert_fastconformer_state_dict(sd, cfg), cfg,
                            use_offline_forward=True, batch_size=2, device="cpu")
    kept = _records(tr)
    audio = calls(2.2, 0.6, 3.1, seed=2)
    tr.transcribe(audio)
    squares, count = 0.0, 0
    for i, call in enumerate(audio):
        steps, n = kept[i]
        assert R.path_errors(steps[:, 0], steps[:, 1], steps[:, 2], n, s) == 0
        enc = R.encode(sd, s, torch.from_numpy(call.astype(np.float32) / 32767.0))
        z = R.replay(sd, s, enc, steps[:, 0].astype(int), steps[:, 1].astype(int)).double()
        at = np.arange(len(steps))
        ref = np.stack([z[at, steps[:, 1].astype(int)].numpy(),
                        z[at, s.blank + 1 + steps[:, 2].astype(int)].numpy()], 1)
        squares += float(np.square(steps[:, 3:5] - ref).sum())
        count += ref.size
    assert count and (squares / count) ** 0.5 < 0.01


def test_transducer_refusals():
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


def test_ctc_head_sits_on_the_shared_encoder():
    cfg = dataclasses.replace(small_config(), architecture=FASTCONFORMER_CTC, transducer=None)
    v = FC.init_fastconformer_params(torch.Generator().manual_seed(1), cfg)
    audio = calls(0.9, 1.7, seed=3)
    wav = torch.zeros(2, 1800 + max(len(a) for a in audio), dtype=torch.int32)
    for i, a in enumerate(audio):
        wav[i, :len(a)] = torch.from_numpy(a.astype(np.int32))
    lengths = [len(a) for a in audio]
    enc, frames = FC.encode_fastconformer(v, cfg, wav, lengths)
    logprobs, frames2 = FC.apply_fastconformer(v, cfg, wav, lengths)
    head = torch.log_softmax(enc @ v["params"]["head"]["w"] + v["params"]["head"]["b"], dim=-1)
    assert frames == frames2
    assert torch.equal(logprobs, head)


def test_spans_and_counters_under_record():
    cfg = small_config()
    sd = state_dict(cfg, seed=5)
    v = convert_fastconformer_state_dict(sd, cfg)
    lengths = [37, 9, 60, 1]
    enc = encoder_outputs(lengths, 64, seed=21)
    t0 = time.monotonic_ns()
    TD.greedy_tdt(v, cfg, enc, lengths)
    assert not [e for e in profiling.events(t0) if e.name.startswith("transducer.")]
    with profiling.record():
        record = TD.greedy_tdt(v, cfg, enc, lengths)
    events = [e for e in profiling.events(t0) if e.name.startswith("transducer.")]
    assert [e.name for e in events if hasattr(e, "end_ns")] == ["transducer.decode"]
    counts = {e.name: e.n for e in events if hasattr(e, "t_ns")}
    steps = rows(record)
    assert counts == {"transducer.steps_computed": record.shape[0] * record.shape[1],
                      "transducer.row_steps": sum(len(r) for r in steps),
                      "transducer.emitted": sum(int((r[:, 1] != 40).sum()) for r in steps)}
    # the host checks after the fewest steps the longest row needs, then
    # every CHECK_EVERY steps: the loop ran at most CHECK_EVERY - 1 too many
    longest = max(len(r) for r in steps)
    assert longest <= record.shape[1] < max(longest, 15) + TD.CHECK_EVERY
