"""The port's bulk path (tone_tpu_torch/offline.py ``OfflineTranscriber``,
ops/greedy.py, ops/align_device.py) against the JAX package on the CPU,
with the same numpy-made tiny float32 weights and audio.

Texts, phrase times, greedy tokens and Viterbi paths are held equal; the
logprobs within 1e-4 (the float32 step's bound) and the alignment
confidences within 1e-6.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import tiny_configs, tiny_variables_with_stats

from tone_tpu.offline import OfflineTranscriber as JaxTranscriber
from tone_tpu.ops import align_device as JA
from tone_tpu.ops import greedy as JG
from tone_tpu_torch.align import align_words
from tone_tpu_torch.config import BLANK_ID, LABELS
from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder, GreedyCTCDecoder
from tone_tpu_torch.offline import OfflineTranscriber
from tone_tpu_torch.ops import align_device as TA
from tone_tpu_torch.ops import greedy as TG

LENGTHS = (5000, 7200, 1200, 4807)  # mixed lengths: two batches of two, reordered
FORWARDS = ["chunk_scan", "offline_forward"]


@functools.lru_cache(maxsize=None)
def _tiny():
    jc, tc = tiny_configs()
    jv, tv = tiny_variables_with_stats(jc, tc, seed=2)
    return jc, tc, jv, tv


def _audios(lengths=LENGTHS, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(-20000, 20000, n).astype(np.int32) for n in lengths]


def _both(forward, **kw):
    jc, tc, jv, tv = _tiny()
    off = forward == "offline_forward"
    return (JaxTranscriber(jv, jc, batch_size=2, use_offline_forward=off, **kw),
            OfflineTranscriber(tv, tc, batch_size=2, use_offline_forward=off, device="cpu",
                               **kw))


def _phrases(result, words=False):
    return [[(p.text, p.start_time, p.end_time) + ((p.words,) if words else ())
             for p in u] for u in result]


@pytest.mark.parametrize("forward", FORWARDS)
def test_transcribe_matches_jax(forward):
    jt, tt = _both(forward)
    audios = _audios()
    got, want = _phrases(tt.transcribe(audios)), _phrases(jt.transcribe(audios))
    assert got == want
    assert len(got) == len(LENGTHS) and all(got)
    # input order, whatever the length buckets
    assert _phrases(tt.transcribe(audios[::-1])) == got[::-1]


@pytest.mark.parametrize("forward", FORWARDS)
def test_logprobs_match_jax(forward):
    jt, tt = _both(forward)
    audios = _audios()
    for a, j, t in zip(audios, jt.logprobs(audios), tt.logprobs(audios)):
        assert t.shape == j.shape and t.dtype == np.float32
        assert t.shape[0] == -(-(len(a) + 4800) // 2400) * 10  # the row's chunks, unpadded
        np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("forward", FORWARDS)
def test_word_timestamps_match_jax(forward):
    jt, tt = _both(forward, word_timestamps=True)
    audios = _audios()
    got, want = tt.transcribe(audios), jt.transcribe(audios)
    assert _phrases(got) == _phrases(want)
    n_words = 0
    for gu, wu in zip(got, want):
        for g, w in zip(gu, wu):
            assert (g.words is None) == (w.words is None)
            for gw, ww in zip(g.words or (), w.words or ()):
                assert (gw.word, gw.start_time, gw.end_time) == (ww.word, ww.start_time,
                                                                 ww.end_time)
                assert gw.confidence == pytest.approx(ww.confidence, abs=1e-6)
                n_words += 1
    assert n_words


def test_device_decoder_batches_the_phrases():
    """``forward_batch`` (one call for every phrase of a batch) gives the
    phrases that per-phrase ``forward`` of the same decoder gives."""
    _, tc, _, tv = _tiny()
    dec = DeviceBeamSearchCTCDecoder(None, beam_width=8, nbest=4, device="cpu")
    audios = _audios((5000, 4800, 1700), seed=1)
    calls = []

    class Counting:
        def forward_batch(self, lps):
            calls.append(len(lps))
            return dec.forward_batch(lps)

    class NoBatch:
        forward = dec.forward

    got = OfflineTranscriber(tv, tc, decoder=Counting(), batch_size=2,
                             device="cpu").transcribe(audios)
    want = OfflineTranscriber(tv, tc, decoder=NoBatch(), batch_size=2,
                              device="cpu").transcribe(audios)
    assert _phrases(got) == _phrases(want)
    assert len(calls) == 2  # one call per batch


def test_mesh_and_default_device_raise():
    _, tc, _, tv = _tiny()
    with pytest.raises(NotImplementedError, match="A14"):
        OfflineTranscriber(tv, tc, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OfflineTranscriber(tv, tc)


# ---------------------------------------------------------------------------
# Greedy collapse on the device.
# ---------------------------------------------------------------------------


def _tied_logprobs(seed, b=3, t=40):
    """Random logprobs with exact ties: rounded to a coarse grid, and whole
    frames flat, so argmax must take the first maximal index."""
    rng = np.random.default_rng(seed)
    lp = np.round(rng.normal(0.0, 1.0, (b, t, len(LABELS) + 1)) * 2) / 2
    lp[:, ::7] = -1.0
    lp[:, 3::11, BLANK_ID] = lp[:, 3::11].max(-1)
    return lp.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_collapse_matches_jax(seed):
    lp = _tied_logprobs(seed)
    jt, jk = JG.greedy_collapse_tokens(jnp.asarray(lp))
    tt, tk = TG.greedy_collapse_tokens(torch.from_numpy(lp))
    assert tt.dtype == torch.int32 and tk.dtype == torch.bool
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    lengths = np.array([40, 17, 0])
    got = TG.batched_greedy_decode(lp, lengths)
    assert got == JG.batched_greedy_decode(lp, lengths)
    assert TG.batched_greedy_decode(torch.from_numpy(lp)) == JG.batched_greedy_decode(lp)
    host = GreedyCTCDecoder()
    assert got[:2] == [host.forward(lp[0]), host.forward(lp[1, :17])] and got[2] == ""


# ---------------------------------------------------------------------------
# Forced alignment on the device.
# ---------------------------------------------------------------------------


def _align_cases():
    """Phrases over several (T, S) buckets with texts a decoder could give,
    an empty text, a flat (all-tie) phrase and a repeated letter."""
    rng = np.random.default_rng(5)
    lps, texts = [], []
    host = GreedyCTCDecoder()
    for t in (12, 30, 75, 30, 140, 12, 300):
        logits = rng.normal(0, 2.5, (t, len(LABELS) + 1))
        lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
        lps.append(lp)
        texts.append(host.forward(lp))
    texts[3] = ""
    lps.append(np.full((20, len(LABELS) + 1), -np.log(35.0), np.float32))
    texts.append("аа бв")
    return lps, texts


def test_viterbi_paths_match_jax():
    lps, texts = _align_cases()
    exts, groups = TA._bucket_groups(lps, texts)
    assert len(groups) >= 3
    for (t_pad, s_pad), idxs in groups.items():
        staged = TA._stage_bucket(lps, exts, idxs, t_pad, s_pad)
        jpath, jscore = JA._viterbi_path(*(jnp.asarray(a) for a in staged))
        tpath, tscore = TA._viterbi_path(*(torch.from_numpy(a) for a in staged))
        assert tpath.dtype == torch.int32 and tuple(tpath.shape) == (len(idxs), t_pad)
        np.testing.assert_array_equal(tpath.numpy(), np.asarray(jpath))
        np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore), rtol=1e-6)


def test_align_words_batch_matches_jax_and_host():
    lps, texts = _align_cases()
    got = TA.align_words_batch(lps, texts, device="cpu")
    want = JA.align_words_batch(lps, texts)
    assert got[3] == [] and sum(map(len, got)) > 10
    for g, w, lp, text in zip(got, want, lps, texts):
        assert [x[:3] for x in g] == [x[:3] for x in w]
        np.testing.assert_allclose([x[3] for x in g], [x[3] for x in w], atol=1e-6)
        host = align_words(lp, text)
        assert [x[:3] for x in g] == [x[:3] for x in host]
        np.testing.assert_allclose([x[3] for x in g], [x[3] for x in host], atol=1e-6)


def test_align_words_batch_refuses_a_text_longer_than_its_phrase():
    lp = np.full((3, len(LABELS) + 1), -np.log(35.0), np.float32)
    with pytest.raises(ValueError, match="cannot align"):
        TA.align_words_batch([lp], ["ааа"], device="cpu")  # a repeat needs a blank between
    with pytest.raises(ValueError, match="cannot align"):
        JA.align_words_batch([lp], ["ааа"])
