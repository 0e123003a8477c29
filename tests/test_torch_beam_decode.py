"""The port's device beam search (tone_tpu_torch/ops/beam_decode.py) against
the JAX search (tone_tpu/ops/beam_decode.py) on the CPU.

The same seeded numpy logprobs go through both: after ``beam_advance`` and
``hot_beam_advance`` the hashes, last characters, tokens and lengths are
bit-equal and the log probabilities agree within 1e-5; decoded texts are
equal.  The cases follow tests/test_beam_decode.py.  Shapes are shared
between tests so that JAX compiles few programs.
"""

from __future__ import annotations

import numpy as np
import pytest

from tone_tpu.config import BLANK_ID, LABELS
from tone_tpu.ops import beam_decode as J
from tone_tpu_torch.ops import beam_decode as T

V = len(LABELS) + 1
B, T_MAX, W, L = 4, 48, 8, 64


def _normalise(logits):
    x = logits - logits.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _peaked(rng, shape, scale=3.0):
    return _normalise(rng.normal(0.0, scale, (*shape, V)))


def _batch(case: str, seed: int):
    """(B, T_MAX, V) logprobs and lengths of a named case."""
    rng = np.random.default_rng(seed)
    lengths = np.array([T_MAX, T_MAX - 5, 31, 9])
    if case == "random":
        lp = _peaked(rng, (B, T_MAX))
    elif case == "flat":            # many near-equal hypotheses: merging
        lp = _peaked(rng, (B, T_MAX), scale=1.0)
    elif case == "blank_heavy":     # as the acoustic model emits
        logits = rng.normal(0.0, 2.5, (B, T_MAX, V))
        logits[..., BLANK_ID] += 4.0
        lp = _normalise(logits)
    elif case == "leading_silence":  # the empty/leading-space twin pair
        logits = rng.normal(0.0, 3.0, (B, T_MAX, V))
        logits[:, :3, LABELS.index(" ")] += 6.0
        logits[:, :3, BLANK_ID] += 6.0
        lp = _normalise(logits)
    else:
        raise ValueError(case)
    return lp, lengths


def assert_states_equal(js, ts):
    for f in ("h1", "h2", "lc", "tokens", "lens"):
        np.testing.assert_array_equal(getattr(ts, f).numpy().astype(np.int64),
                                      np.asarray(getattr(js, f)).astype(np.int64), err_msg=f)
    for f in ("p_b", "p_nb"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a), err_msg=f)
        np.testing.assert_allclose(b[np.isfinite(b)], a[np.isfinite(a)], atol=1e-5,
                                   rtol=0, err_msg=f)


def assert_nbest_equal(jn, tn):
    assert [[h[0] for h in row] for row in tn] == [[h[0] for h in row] for row in jn]
    for jrow, trow in zip(jn, tn):
        np.testing.assert_allclose([h[1] for h in trow], [h[1] for h in jrow], atol=1e-4)


CASES = ["random", "flat", "blank_heavy", "leading_silence"]


@pytest.mark.parametrize("case", CASES)
def test_beam_advance_state_matches_jax(case):
    lp, lengths = _batch(case, seed=CASES.index(case))
    js = J.beam_advance(J.init_beam_state(B, W, L), lp, lengths)
    ts = T.beam_advance(T.init_beam_state(B, W, L), lp, lengths)
    assert_states_equal(js, ts)
    assert_nbest_equal(J.beam_nbest(js, W), T.beam_nbest(ts, W))


@pytest.mark.parametrize("case", CASES)
def test_texts_match_jax(case):
    lp, lengths = _batch(case, seed=10 + CASES.index(case))
    assert (T.beam_search_decode(lp, lengths, beam_width=W, max_len=L, device="cpu")
            == J.beam_search_decode(lp, lengths, beam_width=W, max_len=L))


def test_init_state_matches_jax():
    assert_states_equal(J.init_beam_state(3, 16, 8), T.init_beam_state(3, 16, 8))


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_mix_matches_uint32(seed):
    """The int64 emulation of the uint32 hash products, at the extremes."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 1, 2**31, 2**32 - 1]
    v = rng.integers(-1, 34, 4096).astype(np.int32)
    import torch

    t1, t2 = T._mix(torch.from_numpy(h.astype(np.int64)), torch.from_numpy(h.astype(np.int64)),
                    torch.from_numpy(v.astype(np.int64)))
    j1, j2 = J._mix(h, h, v)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2).astype(np.int64))


def test_merge_paths_leading_space_and_blank():
    """'space then а' and 'а directly' merge into one beam, as in JAX."""
    sp, a = LABELS.index(" "), LABELS.index("а")
    frames = np.full((3, V), -12.0, np.float32)
    frames[0, [sp, a, BLANK_ID]] = np.log([0.4, 0.35, 0.2])
    frames[1, [a, BLANK_ID]] = np.log([0.55, 0.4])
    frames[2, [BLANK_ID]] = np.log(0.95)
    js = J.beam_advance(J.init_beam_state(1, 8), frames[None])
    ts = T.beam_advance(T.init_beam_state(1, 8), frames[None])
    assert_states_equal(js, ts)
    hyps = T.beam_nbest(ts, 8)[0]
    assert [h[0] for h in hyps].count("а") == 1
    assert_nbest_equal(J.beam_nbest(js, 8), [hyps])


@pytest.mark.parametrize("split", [11, 30])
def test_chunk_split_invariance(split):
    lp, _ = _batch("random", seed=2)
    whole = T.beam_advance(T.init_beam_state(B, W, L), lp)
    part = T.beam_advance(T.init_beam_state(B, W, L), lp[:, :split])
    part = T.beam_advance(part, lp[:, split:])
    np.testing.assert_allclose(part.totals.numpy(), whole.totals.numpy(), rtol=1e-6)
    assert T.beam_nbest(part, 3) == T.beam_nbest(whole, 3)
    assert_states_equal(J.beam_advance(J.init_beam_state(B, W, L), lp), part)


def test_length_masking_equals_individual():
    lp, lengths = _batch("random", seed=3)
    batched = T.beam_search_decode(lp, lengths, beam_width=W, max_len=L, device="cpu")
    single = [T.beam_search_decode(lp[i:i + 1, :n], beam_width=W, max_len=L,
                                   device="cpu")[0]
              for i, n in enumerate(lengths)]
    assert batched == single == J.beam_search_decode(lp, lengths, beam_width=W, max_len=L)


def test_token_buffer_overflow_truncates():
    """max_len caps hypothesis growth without corrupting state, as in JAX."""
    lp, lengths = _batch("random", seed=5)
    js = J.beam_advance(J.init_beam_state(B, 4, 5), lp, lengths)
    ts = T.beam_advance(T.init_beam_state(B, 4, 5), lp, lengths)
    assert_states_equal(js, ts)
    full = T.beam_search_decode(lp, lengths, beam_width=4, max_len=L, device="cpu")
    for hyps, text in zip(T.beam_nbest(ts, 1), full):
        assert len(hyps[0][0]) <= 5 and hyps[0][0] == text[:5].strip()


@pytest.mark.parametrize("hot", [False, True])
def test_carried_arena_with_resets_matches_jax(hot):
    """The serving arena: per-tick advance with activity masks and
    phrase-boundary resets, read back each tick, as the JAX arena."""
    rng = np.random.default_rng(8)
    slots, frames = 5, 10
    phrases = ["да", "нет"]
    if hot:
        jt, tt = J.make_hotword_tables(phrases, 4.0), T.make_hotword_tables(phrases, 4.0)
        js, ts = J.init_hot_beam_state(slots, W, 256), T.init_hot_beam_state(slots, W, 256)
    else:
        js, ts = J.init_beam_state(slots, W, 256), T.init_beam_state(slots, W, 256)
    for _ in range(8):
        chunk = _peaked(rng, (slots, frames))
        resets = rng.random(slots) < 0.2
        advance = np.where(rng.random(slots) < 0.8, frames, 0)
        if hot:
            js = J.hot_beam_advance(J.hot_beam_reset(js, resets), chunk, advance, hotwords=jt)
            ts = T.hot_beam_advance(T.hot_beam_reset(ts, resets), chunk, advance, hotwords=tt)
            assert (T.top_texts(*T.hot_beam_top_tokens(ts))
                    == J.top_texts(*J.hot_beam_top_tokens(js)))
        else:
            js = J.beam_advance(J.beam_reset(js, resets), chunk, advance)
            ts = T.beam_advance(T.beam_reset(ts, resets), chunk, advance)
            assert T.top_texts(*T.beam_top_tokens(ts)) == J.top_texts(*J.beam_top_tokens(js))
    if hot:
        assert_states_equal(js.base, ts.base)
        np.testing.assert_array_equal(ts.node.numpy(), np.asarray(js.node))
        np.testing.assert_allclose(ts.bias.numpy(), np.asarray(js.bias), atol=1e-5)
    else:
        assert_states_equal(js, ts)


# ---------------------------------------------------------------------------
# Hotword tables and the biased search
# ---------------------------------------------------------------------------

HOTWORD_LISTS = [["да"], ["нет привет", "да"], ["мир", "мирный", "рный"], ["ёж", "ежи", "а б"]]


@pytest.mark.parametrize("k", range(len(HOTWORD_LISTS)))
def test_make_hotword_tables_matches_jax(k):
    for pad in (None, 64):
        jt = J.make_hotword_tables(HOTWORD_LISTS[k], 7.5, pad_nodes=pad)
        tt = T.make_hotword_tables(HOTWORD_LISTS[k], 7.5, pad_nodes=pad)
        for a, b in zip(jt, tt):
            np.testing.assert_array_equal(b, a)


def test_stack_and_pad_hotword_tables_match_jax():
    jrows = [J.make_hotword_tables(h) for h in HOTWORD_LISTS[:3]]
    trows = [T.make_hotword_tables(h) for h in HOTWORD_LISTS[:3]]
    for a, b in zip(J.stack_hotword_tables([jrows[0], None, jrows[2]], n_rows=5),
                    T.stack_hotword_tables([trows[0], None, trows[2]], n_rows=5)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(J.pad_hotword_tables(jrows[1], 128), T.pad_hotword_tables(trows[1], 128)):
        np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError):
        T.make_hotword_tables(["latin"])


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("case", ["random", "blank_heavy"])
def test_hot_beam_advance_matches_jax(case, stacked):
    lp, lengths = _batch(case, seed=20 + stacked)
    words = ["ба", "вот так", "я"]
    if stacked:   # per-row tables: rows 1 and 3 unbiased
        jt = J.stack_hotword_tables([J.make_hotword_tables(words), None,
                                     J.make_hotword_tables(["а"], 3.0), None])
        tt = T.stack_hotword_tables([T.make_hotword_tables(words), None,
                                     T.make_hotword_tables(["а"], 3.0), None])
    else:
        jt, tt = J.make_hotword_tables(words), T.make_hotword_tables(words)
    js = J.hot_beam_advance(J.init_hot_beam_state(B, W, L), lp, lengths, hotwords=jt)
    ts = T.hot_beam_advance(T.init_hot_beam_state(B, W, L), lp, lengths, hotwords=tt)
    assert_states_equal(js.base, ts.base)
    np.testing.assert_array_equal(ts.node.numpy(), np.asarray(js.node))
    for f in ("tent", "bias"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=1e-5)
    assert_nbest_equal(J.hot_beam_nbest(js, W), T.hot_beam_nbest(ts, W))


def test_decode_runs_on_cuda_unless_asked(monkeypatch):
    """Given no device, the batch decode resolves ``cuda``, as JAX decodes on
    its device: without a GPU it raises instead of falling back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lp, lengths = _batch("random", seed=4)
    with pytest.raises(RuntimeError, match="CUDA device"):
        T.beam_search_decode(lp, lengths, beam_width=W, max_len=L)
