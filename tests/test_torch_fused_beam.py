"""The port's fused-LM device search (tone_tpu_torch/decoding/device_lm.py and
the fused half of tone_tpu_torch/ops/beam_decode.py) against the JAX package
on the CPU.

The same seeded LMs (tests/test_fused_beam.py's corpus LM, written by the
JAX writers) and logprobs go through both packages:

* the device tables are ``array_equal`` to JAX's, for ARPA (DeviceLM) and
  probing binaries (DeviceProbingLM), and a table cache written by either
  package loads in the other;
* the LM scores, the 64-bit KenLM chain hash and the trie steps are equal
  to JAX's bit for bit;
* after ``fused_beam_advance`` (padded batch with lengths, split into two
  calls, with and without hotwords) the integer state is bit-equal and the
  float state within 1e-5, and ``fused_beam_nbest`` gives the same texts
  with scores within 1e-4;
* the fused top-1 equals JAX's host ``ctc_beam_search`` with the same LM;
* the decoder with ``fusion=True`` and the engine with it give the JAX
  decoder's and engine's texts.
"""

from __future__ import annotations

import math
import random

import numpy as np
import pytest
import torch
from test_fused_beam import _corpus_lm, _peaked
from test_torch_common import audio, tiny_configs, tiny_variables

from tone_tpu.config import BLANK_ID, LABELS
from tone_tpu.decoding import device_lm as JD
from tone_tpu.decoding.beam import StreamingBeamSearch, ctc_beam_search
from tone_tpu.decoding.kenlm_binary import combine_word_hash, write_kenlm_binary
from tone_tpu.decoding.lm import ArpaLM as JaxArpa
from tone_tpu.ops import beam_decode as J
from tone_tpu_torch.decoding import device_lm as TD
from tone_tpu_torch.ops import beam_decode as T

V = len(LABELS) + 1
B, T_MAX, W, L = 4, 40, 8, 64
LENGTHS = np.array([40, 33, 17, 6])
HOTWORDS = {"none": None, "single": ["ба", "вот так"], "stacked": "stacked"}


@pytest.fixture(scope="module")
def corpus():
    return _corpus_lm()


@pytest.fixture(scope="module", params=["arpa", "probing"])
def lms(request, corpus, tmp_path_factory):
    """(kind, JAX device LM, port device LM) over the same corpus LM."""
    ngrams, _ = corpus
    if request.param == "arpa":
        return "arpa", JD.DeviceLM.from_ngrams(ngrams), TD.DeviceLM.from_ngrams(ngrams)
    path = tmp_path_factory.mktemp("lm") / "probe.bin"
    write_kenlm_binary(ngrams, path)
    return ("probing", JD.DeviceProbingLM.from_file(path, cache=False),
            TD.DeviceProbingLM.from_file(path, cache=False))


def _j32(x):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(x), jnp.int32)


def assert_tables_equal(jl, tl):
    ja, ta = jl.arrays(), tl.arrays("cpu")
    assert ta.table.dtype == ta.edges.dtype == torch.int32
    np.testing.assert_array_equal(ta.table.numpy().view(np.uint32), np.asarray(ja.table))
    np.testing.assert_array_equal(ta.edges.numpy().view(np.uint32), np.asarray(ja.edges))
    assert (ta.probe, ta.edge_probe) == (ja.probe, ja.edge_probe)
    assert (ta.unk_id, ta.oov_ctx_id) == (int(ja.unk_id), int(ja.oov_ctx_id))
    assert (tl.bos_id, tl.unk_id, tl.order) == (jl.bos_id, jl.unk_id, jl.order)
    for f in ("keys1", "keys2", "probs", "backoffs", "edge_keys", "edge_child", "node_word"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f), err_msg=f)
    if hasattr(ja, "uni_prob"):
        np.testing.assert_array_equal(ta.uni_prob.numpy(), np.asarray(ja.uni_prob))
        np.testing.assert_array_equal(ta.uni_backoff.numpy(), np.asarray(ja.uni_backoff))


def test_device_tables_match_jax(lms):
    _, jl, tl = lms
    assert_tables_equal(jl, tl)
    # the device view is made once per device and kept on the LM
    assert tl.arrays("cpu") is tl.arrays(torch.device("cpu"))


@pytest.mark.parametrize("model_type", [0, 1], ids=["probing", "rest_probing"])
def test_load_device_lm_dispatch_matches_jax(corpus, tmp_path, monkeypatch, model_type):
    monkeypatch.setenv("TONE_TPU_LM_CACHE", "0")
    ngrams, words = corpus
    path = tmp_path / "lm.bin"
    write_kenlm_binary(ngrams, path, model_type=model_type)
    jl, tl = JD.load_device_lm(path), TD.load_device_lm(path)
    assert type(tl).__name__ == type(jl).__name__ == "DeviceProbingLM"
    assert_tables_equal(jl, tl)
    rng = random.Random(model_type)
    for _ in range(300):
        ctx = tuple(rng.choice(words + ["oov"]) for _ in range(rng.randint(0, 4)))
        w = rng.choice(words + ["zzz-oov"])
        assert tl.score(ctx, w) == jl.score(ctx, w)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["arpa", "probing"])
def test_table_cache_is_shared_with_jax(corpus, tmp_path, monkeypatch, writer, fmt):
    """A cache written by either package loads in the other (same layout,
    key and location), with no table rebuild."""
    from tone_tpu.decoding.estimate import write_arpa

    monkeypatch.delenv("TONE_TPU_LM_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    ngrams, _ = corpus
    path = tmp_path / ("lm.arpa" if fmt == "arpa" else "lm.bin")
    if fmt == "arpa":
        write_arpa(ngrams, path)
    else:
        write_kenlm_binary(ngrams, path)
    first, second = (JD, TD) if writer == "jax" else (TD, JD)
    built = first.load_device_lm(path)
    assert len(list(tmp_path.glob("*.v1.*.npz"))) == 1

    def no_rebuild(*_a, **_k):
        raise AssertionError("the cache was not used")

    monkeypatch.setattr(second, "_probe_table", no_rebuild)
    loaded = second.load_device_lm(path)
    jl, tl = (built, loaded) if writer == "jax" else (loaded, built)
    assert_tables_equal(jl, tl)


def _contexts(jl, seed, shape=(5, 9)):
    """Random (ctx, wid) with -1 (missing) and OOV context entries."""
    rng = np.random.default_rng(seed)
    if isinstance(jl, JD.DeviceLM):
        n_ids, oov = jl.n_words, jl.n_words
    else:
        n_ids, oov = len(jl.uni_prob), 0
    ctx = rng.integers(0, n_ids, (*shape, jl.order - 1))
    ctx[rng.random(ctx.shape) < 0.2] = -1
    ctx[rng.random(ctx.shape) < 0.1] = oov
    ctx[..., -1] = np.where(rng.random(shape) < 0.3, jl.bos_id, ctx[..., -1])
    return ctx, rng.integers(0, n_ids, shape)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lm_score_matches_jax(lms, seed):
    _, jl, tl = lms
    ctx, wid = _contexts(jl, seed)
    want = np.asarray(J._lm_score(jl.arrays(), _j32(ctx), _j32(wid)))
    got = T._lm_score(tl.arrays("cpu"), torch.from_numpy(ctx), torch.from_numpy(wid))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the host twin, on the rows with a whole context
    for (c, w), s in zip(zip(ctx.reshape(-1, ctx.shape[-1]), wid.ravel()), got.numpy().ravel()):
        if (c >= 0).all():
            assert s == pytest.approx(tl.score_ids([int(i) for i in c], int(w)), abs=1e-5)


def test_every_gram_is_found_with_keys_above_2_31(corpus):
    """Keys >= 2**31 sit in the int32 tables as negative numbers: every gram
    of the LM must still be found (an int64 compare would miss them and
    silently back off to unigrams)."""
    ngrams, _ = corpus
    tl = TD.DeviceLM.from_ngrams(ngrams)
    ta = tl.arrays("cpu")
    wid = {w: i for i, w in enumerate(tl.words)}
    grams = [g for table in ngrams for g in table]
    hashes = np.array([TD._hash_ids([wid[w] for w in g]) for g in grams], np.int64)
    assert (hashes >= 2**31).any(axis=0).all() and (hashes < 2**31).any(axis=0).all()
    found, prob, _ = T._lm_lookup(ta, torch.from_numpy(hashes[:, 0]),
                                  torch.from_numpy(hashes[:, 1]))
    assert bool(found.all())
    np.testing.assert_array_equal(prob.numpy(), np.array(
        [t[g][0] for t in ngrams for g in t], np.float32))


def test_combine64_is_kenlm_combine_word_hash():
    import jax.numpy as jnp

    from tone_tpu_torch.decoding.kenlm_binary import combine_word_hash as port_combine

    rng = random.Random(0)
    hi = np.array([0, 2**32 - 1, 2**31] + [rng.getrandbits(32) for _ in range(509)], np.int64)
    lo = np.array([0, 2**32 - 1, 1] + [rng.getrandbits(32) for _ in range(509)], np.int64)
    wid = np.array([-1, 2**31 - 2, 0] + [rng.randrange(-1, 2**31 - 2) for _ in range(509)],
                   np.int64)
    dhi, dlo = T._combine64(torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(wid))
    jhi, jlo = J._combine64(jnp.asarray(hi.astype(np.uint32)), jnp.asarray(lo.astype(np.uint32)),
                            _j32(wid))
    np.testing.assert_array_equal(dhi.numpy(), np.asarray(jhi).astype(np.int64))
    np.testing.assert_array_equal(dlo.numpy(), np.asarray(jlo).astype(np.int64))
    for i in range(len(hi)):
        h = (int(hi[i]) << 32) | int(lo[i])
        want = combine_word_hash(h, int(wid[i]))
        assert (int(dhi[i]) << 32) | int(dlo[i]) == want == port_combine(h, int(wid[i]))


def test_trie_step_matches_jax(lms):
    _, jl, tl = lms
    rng = np.random.default_rng(5)
    n_nodes = len(jl.node_word)
    node = rng.integers(-1, n_nodes, (6, 11))
    char = rng.integers(0, len(LABELS), (6, 11))
    # half the queries are edges of the trie
    keys = jl.edge_keys[jl.edge_keys != JD._SENTINEL].astype(np.int64)
    pick = rng.choice(keys, (6, 11))
    real = rng.random((6, 11)) < 0.5
    node = np.where(real, pick // len(LABELS), node)
    char = np.where(real, pick % len(LABELS), char)
    want = J._trie_step(jl.arrays(), _j32(node), _j32(char))
    got = T._trie_step(tl.arrays("cpu"), torch.from_numpy(node), torch.from_numpy(char))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    assert (got[0] >= 0).any() and (got[1] >= 0).any() and (got[0] < 0).any()


def _hotwords(which):
    if which == "none":
        return None, None
    if which == "single":
        return J.make_hotword_tables(HOTWORDS["single"]), T.make_hotword_tables(HOTWORDS["single"])
    rows = [["ба", "вот"], None, ["я"], None]
    return (J.stack_hotword_tables([J.make_hotword_tables(r, 3.0) if r else None for r in rows]),
            T.stack_hotword_tables([T.make_hotword_tables(r, 3.0) if r else None for r in rows]))


def assert_fused_states_equal(js, ts):
    for f in ("h1", "h2", "lc", "tokens", "lens"):
        np.testing.assert_array_equal(getattr(ts.base, f).numpy().astype(np.int64),
                                      np.asarray(getattr(js.base, f)).astype(np.int64), err_msg=f)
    for f in ("ctx", "node", "wid", "hw_node"):
        if getattr(js, f) is None:
            assert getattr(ts, f) is None, f
            continue
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)).astype(np.int64), err_msg=f)
    for f, (a, b) in {"p_b": (js.base.p_b, ts.base.p_b), "p_nb": (js.base.p_nb, ts.base.p_nb),
                      "lm_sc": (js.lm_sc, ts.lm_sc), "hw_tent": (js.hw_tent, ts.hw_tent),
                      "hw_bias": (js.hw_bias, ts.hw_bias)}.items():
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a), err_msg=f)
        np.testing.assert_array_equal(b[~np.isfinite(b)], a[~np.isfinite(a)], err_msg=f)
        np.testing.assert_allclose(b[np.isfinite(b)], a[np.isfinite(a)], atol=1e-5, rtol=0,
                                   err_msg=f)


def assert_nbest_equal(jn, tn):
    assert [[h[0] for h in row] for row in tn] == [[h[0] for h in row] for row in jn]
    for jrow, trow in zip(jn, tn):
        np.testing.assert_allclose([h[1] for h in trow], [h[1] for h in jrow], atol=1e-4)


def _batch(seed):
    rng = np.random.default_rng(seed)
    lp = np.stack([_peaked(rng, T_MAX, lead_silence=(i % 2 == 0)) for i in range(B)])
    return lp


@pytest.mark.parametrize("hot", list(HOTWORDS))
def test_fused_beam_advance_matches_jax(lms, hot):
    """A padded batch with lengths, advanced in two calls (the carried state
    crosses the split), against the JAX search."""
    kind, jl, tl = lms
    lp = _batch(10 + list(HOTWORDS).index(hot))
    jh, th = _hotwords(hot)
    js = J.init_fused_beam_state(B, W, jl, L, hotwords=jh)
    ts = T.init_fused_beam_state(B, W, tl, L, hotwords=th)
    assert_fused_states_equal(js, ts)
    split = 23
    for lo, hi in ((0, split), (split, T_MAX)):
        lens = np.clip(LENGTHS - lo, 0, hi - lo)
        js = J.fused_beam_advance(js, lp[:, lo:hi], jl.arrays(), lens, hotwords=jh)
        ts = T.fused_beam_advance(ts, lp[:, lo:hi], tl.arrays("cpu"), lens, hotwords=th)
    assert_fused_states_equal(js, ts)
    assert (ts.ctx != tl.bos_id).any()         # words were completed
    assert_nbest_equal(J.fused_beam_nbest(js, jl, W), T.fused_beam_nbest(ts, tl, W))
    # split-invariance of the port itself
    whole = T.fused_beam_advance(T.init_fused_beam_state(B, W, tl, L, hotwords=th), lp,
                                 tl.arrays("cpu"), LENGTHS, hotwords=th)
    assert T.fused_beam_nbest(whole, tl, 3) == T.fused_beam_nbest(ts, tl, 3)


@pytest.mark.parametrize("alpha, beta", [(1.2, 0.0), (0.25, -1.5)])
def test_fusion_weights_match_jax(corpus, alpha, beta):
    ngrams, _ = corpus
    jl, tl = JD.DeviceLM.from_ngrams(ngrams), TD.DeviceLM.from_ngrams(ngrams)
    lp = _batch(20)
    js = J.fused_beam_advance(J.init_fused_beam_state(B, W, jl, L), lp, jl.arrays(), LENGTHS,
                              alpha=alpha, beta=beta)
    ts = T.fused_beam_advance(T.init_fused_beam_state(B, W, tl, L), lp, tl.arrays("cpu"),
                              LENGTHS, alpha=alpha, beta=beta)
    assert_fused_states_equal(js, ts)
    assert_nbest_equal(J.fused_beam_nbest(js, jl, 4, alpha=alpha, beta=beta),
                       T.fused_beam_nbest(ts, tl, 4, alpha=alpha, beta=beta))


@pytest.mark.parametrize("chunk", range(3))
def test_fused_top1_is_the_jax_host_search(corpus, chunk):
    """Quality oracle (tests/test_fused_beam.py:77 for JAX): over 24 seeded
    trials the port's fused top-1 equals JAX's host ``ctc_beam_search``
    with the same LM, leading-silence twins included."""
    ngrams, _ = corpus
    arpa, tl = JaxArpa(ngrams), TD.DeviceLM.from_ngrams(ngrams)
    rng = np.random.default_rng(2 + 100 * chunk)
    for trial in range(8):
        lp = _peaked(rng, int(rng.integers(10, 40)), lead_silence=(trial % 3 == 0))
        want = ctc_beam_search(lp.astype(np.float64), LABELS, arpa, beam_width=12)
        st = T.fused_beam_advance(T.init_fused_beam_state(1, 12, tl), lp[None],
                                  tl.arrays("cpu"))
        assert T.fused_beam_nbest(st, tl, 1)[0][0][0] == want


def test_lm_steers_pruning_over_acoustics(corpus):
    """The LM flips the acoustically best word, as on the host and in JAX."""
    ngrams, words = _corpus_lm(seed=9, n_words=8)
    by_len: dict[int, list[str]] = {}
    for w in sorted(set(words)):
        by_len.setdefault(len(w), []).append(w)
    favored, other = next(v[:2] for v in by_len.values() if len(v) >= 2)
    for tbl in ngrams:
        for g in list(tbl):
            if g[-1] not in ("<s>", "</s>", "<unk>"):
                tbl[g] = (0.0 if g[-1] == favored else -8.0, tbl[g][1])
    arpa, tl = JaxArpa(ngrams), TD.DeviceLM.from_ngrams(ngrams)
    frames = np.full((2 * len(other) + 1, V), -14.0, np.float32)
    for i, (c_o, c_f) in enumerate(zip(other, favored)):
        frames[2 * i, LABELS.index(c_o)] = math.log(0.5)
        frames[2 * i, LABELS.index(c_f)] = math.log(0.45)
        frames[2 * i + 1, BLANK_ID] = math.log(0.9)
    frames[-1, LABELS.index(" ")] = math.log(0.9)
    x = frames - frames.max(-1, keepdims=True)
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    want = ctc_beam_search(lp.astype(np.float64), LABELS, arpa, alpha=1.2, beam_width=16)
    st = T.fused_beam_advance(T.init_fused_beam_state(1, 16, tl), lp[None], tl.arrays("cpu"),
                              alpha=1.2)
    assert T.fused_beam_nbest(st, tl, 1, alpha=1.2)[0][0][0] == want == favored


def test_oov_word_stays_in_context(corpus):
    """A decoded OOV word keeps a context id that hashes to nothing (the
    host keeps the literal string), not <unk>'s: scores equal the host's."""
    ngrams, words = corpus
    arpa, tl = JaxArpa(ngrams), TD.DeviceLM.from_ngrams(ngrams)
    text = "щщ " + words[0]
    assert ("щщ",) not in arpa._ngrams[0]
    frames = np.full((2 * len(text) + 1, V), -14.0, np.float32)
    for i, ch in enumerate(text):
        frames[2 * i, LABELS.index(ch)] = np.log(0.7)
        frames[2 * i + 1, BLANK_ID] = np.log(0.9)
    frames[-1, LABELS.index(" ")] = np.log(0.9)
    x = frames - frames.max(-1, keepdims=True)
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    host = StreamingBeamSearch(LABELS, arpa, beam_width=12)
    host.advance(lp.astype(np.float64))
    best = max(host._beams.values(), key=lambda b: b.total())
    st = T.fused_beam_advance(T.init_fused_beam_state(1, 12, tl), lp[None], tl.arrays("cpu"))
    assert T.fused_beam_nbest(st, tl, 1)[0][0][0] == (best.text + best.partial).strip()
    assert float(st.scores[0].max()) == pytest.approx(best.total(), abs=1e-3)
    assert tl.n_words in st.ctx[0].tolist()[int(st.scores[0].argmax())]


def test_wide_probe_window_matches_jax(corpus, monkeypatch):
    """Tables built with a narrow start window widen it; the port's tables
    and scores follow JAX's."""
    ngrams, words = corpus
    monkeypatch.setattr(JD, "PROBE", 2)
    monkeypatch.setattr(TD, "PROBE", 2)
    jl, tl = JD.DeviceLM.from_ngrams(ngrams), TD.DeviceLM.from_ngrams(ngrams)
    assert tl.probe > 2 or tl.edge_probe > 2
    assert_tables_equal(jl, tl)
    ctx, wid = _contexts(jl, 7)
    np.testing.assert_array_equal(
        T._lm_score(tl.arrays("cpu"), torch.from_numpy(ctx), torch.from_numpy(wid)).numpy(),
        np.asarray(J._lm_score(jl.arrays(), _j32(ctx), _j32(wid))))


# ---------------------------------------------------------------------------
# The decoder and the engine with fusion=True
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["arpa_lm", "probing_from_local", "hotword_rows", "nbest"])
def test_fused_decoder_matches_jax(corpus, tmp_path, monkeypatch, variant):
    from tone_tpu.decoder import DeviceBeamSearchCTCDecoder as JaxDecoder
    from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder
    from tone_tpu_torch.decoding.lm import ArpaLM

    monkeypatch.setenv("TONE_TPU_LM_CACHE", "0")
    ngrams, _ = corpus
    kw = dict(beam_width=8, nbest=6, max_len=L)
    if variant == "probing_from_local":
        path = tmp_path / "kenlm.bin"
        write_kenlm_binary(ngrams, path)
        jdec = JaxDecoder.from_local(path, fusion=True, **kw)
        tdec = DeviceBeamSearchCTCDecoder.from_local(path, fusion=True, device="cpu", **kw)
        assert isinstance(tdec._lm, TD.DeviceProbingLM)
    else:
        jdec = JaxDecoder(JaxArpa(ngrams), fusion=True, **kw)
        tdec = DeviceBeamSearchCTCDecoder(ArpaLM(ngrams), fusion=True, device="cpu", **kw)
        assert isinstance(tdec._lm, TD.DeviceLM)
    assert jdec.fusion and tdec.fusion
    rng = np.random.default_rng(list(["arpa_lm", "probing_from_local", "hotword_rows",
                                      "nbest"]).index(variant))
    phrases = [_peaked(rng, t) for t in (40, 64, 12, 90, 31)]
    rows = None, None
    if variant == "hotword_rows":
        words = [["ба"], None, ["вот так"], None, ["я"]]
        rows = ([J.make_hotword_tables(w, 4.0) if w else None for w in words],
                [T.make_hotword_tables(w, 4.0) if w else None for w in words])
    n = 4 if variant == "nbest" else 1
    want = jdec.forward_batch_nbest(phrases, n, rows[0])
    got = tdec.forward_batch_nbest(phrases, n, rows[1])
    assert_nbest_equal(want, got)
    assert tdec.forward_batch(phrases, rows[1]) == [r[0][0] if r else "" for r in got]
    assert tdec.forward(phrases[0]) == jdec.forward(phrases[0])


def test_fusion_needs_an_enumerable_lm():
    from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder

    class Opaque:
        order = 2

    with pytest.raises(TypeError, match="load_device_lm"):
        DeviceBeamSearchCTCDecoder(Opaque(), fusion=True, device="cpu")
    # no LM: fusion has nothing to fuse, as in JAX
    assert not DeviceBeamSearchCTCDecoder(None, fusion=True, device="cpu").fusion


N = 2400


def _padded(wav, cfg):
    out = np.pad(wav, (cfg.padding, cfg.padding))
    return np.pad(out, (0, -len(out) % N))


def test_fused_engine_matches_jax_engine(corpus):
    """The engine with a fused decoder (batched finals, per-request
    hotwords as stacked rows, n-best) gives the JAX engine's finals and
    phrase times, and its override decoder shares the LM and fusion."""
    from tone_tpu.decoder import DeviceBeamSearchCTCDecoder as JaxDecoder
    from tone_tpu.runtime.engine import MultiStreamEngine as JaxEngine
    from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder
    from tone_tpu_torch.decoding.lm import ArpaLM
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    ngrams, _ = corpus
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc)
    kw = dict(beam_width=8, nbest=6, max_len=256)
    jdec = JaxDecoder(JaxArpa(ngrams), fusion=True, **kw)
    tdec = DeviceBeamSearchCTCDecoder(ArpaLM(ngrams), fusion=True, device="cpu", **kw)
    streams = [audio(N * 6, seed=40), audio(N * 7, seed=41), audio(N * 5, seed=42)]
    opts = dict(n_slots=4, final_decode_batch=4)
    results = []
    for eng in (JaxEngine(jv, jc, decoder=jdec, **opts),
                MultiStreamEngine(tv, tc, decoder=tdec, device="cpu", **opts)):
        cfg = jc if isinstance(eng, JaxEngine) else tc
        try:
            eng._warmed_hotword_buckets.update({1 << k for k in range(12)})
            sids = [eng.open_stream() for _ in streams]
            eng.set_stream_hotwords(sids[1], ["ба", "вот"], 4.0)
            eng.set_stream_nbest(sids[2], 3)
            for sid, wav in zip(sids, streams):
                padded = _padded(wav, cfg)
                for i in range(len(padded) // N):
                    eng.feed(sid, padded[i * N:(i + 1) * N])
                eng.close_stream(sid)
            phrases = {sid: [] for sid in sids}
            for _ in range(12):
                for sid, futs in eng.tick().items():
                    phrases[sid].extend(f.result(timeout=120) for f in futs)
            results.append([[(p.text, p.start_time, p.end_time,
                              [t for t, _ in p.nbest] if p.nbest else None)
                             for p in phrases[s]] for s in sids])
            if isinstance(eng, MultiStreamEngine):
                eng.MAX_STACKED_HOTWORD_BYTES = 0
                eng.set_stream_hotwords(eng.open_stream(), ["ба"])
                over = [s.decoder for s in eng._streams.values() if s.decoder is not None][0]
                assert over.fusion and over._lm is eng.decoder._lm
        finally:
            eng.shutdown()
    want, got = results
    assert all(want) and got == want
