"""The plain reference (``benchmark/reference``) against the port at a tiny
configuration on the CPU: the streaming step with its state and resets,
the offline forward, the training step, and the phrase splitting and
greedy decoding.  The port in float32 computes what the reference does, so
they agree to float32 round-off; the control's fp8 does not.

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness.compare import moved_leaves  # noqa: E402
from harness.weights import make_variables  # noqa: E402
from reference import decode as ref_decode  # noqa: E402
from reference import model as ref  # noqa: E402
from reference import train as ref_train  # noqa: E402
from tone_tpu_torch.config import ToneConfig  # noqa: E402
from tone_tpu_torch.core.model import (  # noqa: E402
    apply_offline,
    apply_streaming,
    init_streaming_state,
)


def tiny(chunk_ms=300, dtype="float32"):
    cfg = ToneConfig(compute_dtype=dtype).with_chunk_duration_ms(chunk_ms)
    d = cfg.to_dict()
    d["encoder"].update(d_model=64, n_heads=2)
    return ToneConfig.from_dict(d), d


def audio(rng, b, n):
    return torch.from_numpy(rng.integers(-9000, 9000, (b, n)).astype(np.int16))


@pytest.mark.parametrize("chunk_ms", [300, 400])
def test_streaming_step_matches_port(chunk_ms):
    cfg, model = tiny(chunk_ms)
    s = ref.sizes(model)
    variables = make_variables(model, 7, "cpu")
    rng = np.random.default_rng(0)
    state_p = init_streaming_state(cfg, 3, torch.float32)
    state_r = ref.zero_state(s, 3, "cpu")
    for k in range(7):
        chunk = audio(rng, 3, cfg.audio_chunk_samples)
        if k == 4:  # a slot reset: row 1 starts a new stream
            state_p = state_p.map(lambda x, ax: x.index_fill(ax, torch.tensor([1]), 0))
            state_r = {n: v.index_fill(1 if n in ("mhsa", "conv") else 0, torch.tensor([1]), 0)
                       for n, v in state_r.items()}
        lp_p, state_p = apply_streaming(variables, cfg, chunk.to(torch.int32), state_p)
        lp_r, state_r = ref.streaming_step(variables, s, chunk, state_r)
        assert lp_r.shape == lp_p.shape
        assert (lp_r - lp_p).abs().max() < 2e-4, k


def test_offline_forward_matches_port_and_streaming():
    cfg, model = tiny()
    s = ref.sizes(model)
    variables = make_variables(model, 8, "cpu")
    rng = np.random.default_rng(1)
    wav = audio(rng, 2, 8 * cfg.audio_chunk_samples)
    lp_p, _, _ = apply_offline(variables, cfg, wav.to(torch.int32))
    lp_r, _, _ = ref.offline_forward(variables, s, wav.float() / 32767.0)
    assert (lp_r - lp_p).abs().max() < 2e-4
    state = ref.zero_state(s, 2, "cpu")
    steps = []
    for k in range(8):
        lp, state = ref.streaming_step(variables, s, wav[:, k * 2400:(k + 1) * 2400], state)
        steps.append(lp)
    assert (torch.cat(steps, 1) - lp_r).abs().max() < 2e-4


def test_train_steps_match_port():
    from tone_tpu_torch.bridge import tree_leaves
    from tone_tpu_torch.training.train import ADAM_B1, Trainer, TrainerConfig

    cfg, model = tiny()
    s = ref.sizes(model)
    variables = make_variables(model, 9, "cpu")
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        lens = rng.integers(8000, 14400, 3)
        wav = np.zeros((3, 14400), np.float32)
        labels = np.full((3, 16), -100, np.int32)
        for i, n in enumerate(lens):
            wav[i, :n] = rng.uniform(-0.3, 0.3, n)
            labels[i, :10] = rng.integers(0, 34, 10)
        batches.append({"input_values": wav, "input_lengths": lens.astype(np.int32),
                        "labels": labels})
    tc = TrainerConfig(seed=31, warmup_ratio=0.0, total_steps=3, learning_rate=1e-3)
    trainer = Trainer(cfg, tc, device="cpu")
    state = trainer.create_state(variables)
    losses = []
    for k, b in enumerate(batches):
        state, loss = trainer.train_step(state, b)
        losses.append(float(loss))
        if k == 0:
            grads = [float(torch.linalg.vector_norm(m)) / (1 - ADAM_B1)
                     for m in tree_leaves(state.opt_state.mu)]
    hyper = {"learning_rate": tc.learning_rate, "warmup_ratio": tc.warmup_ratio,
             "total_steps": tc.total_steps, "weight_decay": tc.weight_decay,
             "max_grad_norm": tc.max_grad_norm}
    out = ref_train.train_steps(variables, s, [{k: torch.as_tensor(v) for k, v in b.items()}
                                               for b in batches], 31, hyper)
    np.testing.assert_allclose(losses, out["loss"], rtol=1e-4)
    np.testing.assert_allclose(grads, list(out["grad"].values()), rtol=2e-3, atol=1e-7)
    # The change of the leaves that move by more than round-off (the rule of
    # harness.compare.moved_leaves): Adam's first steps turn each element's
    # gradient into about +-lr, so a leaf whose gradient is nought to
    # rounding moves by its noise's signs.
    moved = moved_leaves(out["grad"])
    change = {path: float(torch.linalg.vector_norm(q.detach() - p0)) for (path, p0), q in
              zip(ref.tree_items(variables["params"]), tree_leaves(state.params))}
    assert len(moved) > 0.8 * len(change)
    for path in moved:
        assert change[path] == pytest.approx(out["change"][path], rel=2e-2, abs=1e-6), path


def test_learning_rate_follows_the_port():
    from tone_tpu_torch.training.train import TrainerConfig, make_lr_schedule

    tc = TrainerConfig()
    sched = make_lr_schedule(tc)
    for count in (0, 1, 2, 49, 50, 51, 500, 999, 1000, 1200):
        assert ref_train.learning_rate(count, tc.learning_rate, tc.warmup_ratio,
                                       tc.total_steps) == float(sched(count))


def _logprobs(rng, speech_runs):
    """A stream's logprobs: speech frames spread over the letters, silence
    frames on the blank."""
    frames = []
    for speech, n in speech_runs:
        logits = rng.normal(0, 1, (n, 35))
        if speech:
            logits[:, rng.integers(0, 33, n)] += 4
        else:
            logits[:, 34] += 8
        frames.append(logits)
    x = np.concatenate(frames)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_decode_matches_the_port_splitters(seed):
    from tone_tpu_torch.decoder import GreedyCTCDecoder
    from tone_tpu_torch.splitter import BatchLogprobSplitter, StreamingLogprobSplitter

    rng = np.random.default_rng(seed)
    runs = [(bool(k % 2), int(rng.integers(3, 60))) for k in range(int(rng.integers(2, 12)))]
    if seed == 5:
        runs.append((True, 2300))  # a phrase force-split at 2,000 frames
    lp = _logprobs(rng, runs)
    lp = np.concatenate([lp, _logprobs(rng, [(False, -len(lp) % 10)])])
    greedy = GreedyCTCDecoder()
    whole, _ = StreamingLogprobSplitter().forward(lp, None, is_last=True)
    splitter = BatchLogprobSplitter(4)
    splitter.reset(2)
    streamed = []
    n = len(lp) // 10
    for k in range(n):
        out = splitter.forward_batch(lp[None, k * 10:(k + 1) * 10], np.array([2]),
                                     np.array([k == n - 1]))
        streamed += out.get(2, [])
    expected = ref_decode.phrase_texts(lp, ToneConfig().labels)
    assert [greedy.forward(np.ascontiguousarray(p.logprobs)) for p in whole] == expected
    if seed != 5:
        # Streamed, a phrase of 2,000 frames (60 s) or more is cut where the
        # serving splitter's buffer reaches that length, not the stream's
        # phrase: the voice-bot cells' turns (20 s at most) never reach it.
        assert [greedy.forward(np.ascontiguousarray(p.logprobs)) for p in streamed] == expected


def test_fp8_control_departs_from_float32():
    cfg, model = tiny()
    s = ref.sizes(model)
    variables = make_variables(model, 10, "cpu")
    wav = audio(np.random.default_rng(3), 2, 6 * 2400).float() / 32767.0
    base = ref.offline_forward(variables, s, wav)[0]
    low = ref.offline_forward(variables, s, wav, pr=ref.Precision("fp8"))[0]
    assert (low - base).abs().max() > 20 * 2e-4
