"""The port's host decoding modules and its device-beam decoder against the
JAX package on the CPU: LM readers (ARPA, KenLM probing, rest-probing and
trie files written by the JAX writers), the estimator, n-best rescoring,
the forced aligner, ``DeviceBeamSearchCTCDecoder`` and the CLI decoder
factory.  The same seeded numpy inputs go through both packages."""

from __future__ import annotations

import math

import numpy as np
import pytest

from tone_tpu.config import BLANK_ID, LABELS
from tone_tpu.decoder import DeviceBeamSearchCTCDecoder as JaxDecoder
from tone_tpu.decoder import parse_hotwords as jax_parse_hotwords
from tone_tpu.decoding import estimate as JE
from tone_tpu.decoding import kenlm_binary as JKB
from tone_tpu.decoding import kenlm_trie as JKT
from tone_tpu.decoding import lm as JLM
from tone_tpu.decoding import rescore as JR
from tone_tpu.ops.beam_decode import make_hotword_tables as jax_tables
from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder, build_decoder, parse_hotwords
from tone_tpu_torch.decoding import estimate as TE
from tone_tpu_torch.decoding import lm as TLM
from tone_tpu_torch.decoding import rescore as TR
from tone_tpu_torch.ops.beam_decode import make_hotword_tables

V = len(LABELS) + 1
WORDS = ["да", "нет", "мир", "привет", "вот", "так", "ёж", "я", "она", "был"]


def corpus(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    return [[WORDS[i] for i in rng.integers(0, len(WORDS), rng.integers(1, 7))]
            for _ in range(n)]


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    """One estimated order-3 LM written by the JAX writers in every format."""
    tables = JE.estimate_ngram_lm(corpus(0), order=3)
    d = tmp_path_factory.mktemp("lms")
    files = {"arpa": d / "lm.arpa", "probing": d / "probing.bin",
             "rest_probing": d / "rest.bin", "trie": d / "trie.bin",
             "quant_trie": d / "quant.bin", "array_trie": d / "array.bin"}
    JE.write_arpa(tables, files["arpa"])
    JKB.write_kenlm_binary(tables, files["probing"])
    JKB.write_kenlm_binary(tables, files["rest_probing"], model_type=JKB.MODEL_REST_PROBING)
    JKT.write_kenlm_trie(tables, files["trie"])
    JKT.write_kenlm_trie(tables, files["quant_trie"], quant_bits=(8, 8))
    JKT.write_kenlm_trie(tables, files["array_trie"], bhiksha_bits=8)
    return tables, files


def heldout_ngrams():
    """Every 1-3-gram of a held-out set (unseen words and contexts too)."""
    out = set()
    for sent in corpus(99, 40) + [["кот", "да"], ["нет", "кот", "мир"]]:
        toks = ["<s>"] + sent + ["</s>"]
        for n in (1, 2, 3):
            for i in range(1, len(toks) - n + 2):
                gram = tuple(toks[max(0, i - n + 1):i + 1])
                if gram and gram[-1] != "<s>":
                    out.add(gram)
    return sorted(out)


@pytest.mark.parametrize("fmt", ["arpa", "probing", "rest_probing", "trie", "quant_trie",
                                 "array_trie"])
def test_load_lm_scores_match_jax(lm_files, fmt):
    _, files = lm_files
    jlm, tlm = JLM.load_lm(files[fmt]), TLM.load_lm(files[fmt])
    assert type(tlm).__name__ == type(jlm).__name__ and tlm.order == jlm.order == 3
    grams = heldout_ngrams()
    assert len(grams) > 100
    for gram in grams:
        assert tlm.score(gram[:-1], gram[-1]) == jlm.score(gram[:-1], gram[-1]), gram


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_estimate_writes_the_jax_arpa_text(tmp_path, order):
    sents = corpus(order)
    JE.write_arpa(JE.estimate_ngram_lm(sents, order=order), tmp_path / "j.arpa")
    TE.write_arpa(TE.estimate_ngram_lm(sents, order=order), tmp_path / "t.arpa")
    assert (tmp_path / "t.arpa").read_text() == (tmp_path / "j.arpa").read_text()
    lines = [" ".join(s) for s in corpus(order + 10, 20)]
    assert TE.estimate_from_text(lines, order=order) == JE.estimate_from_text(lines, order=order)


def test_port_writers_write_the_jax_bytes(lm_files, tmp_path):
    from tone_tpu_torch.decoding import kenlm_binary as TKB
    from tone_tpu_torch.decoding import kenlm_trie as TKT

    tables, files = lm_files
    TKB.write_kenlm_binary(tables, tmp_path / "p.bin")
    TKT.write_kenlm_trie(tables, tmp_path / "t.bin")
    assert (tmp_path / "p.bin").read_bytes() == files["probing"].read_bytes()
    assert (tmp_path / "t.bin").read_bytes() == files["trie"].read_bytes()
    assert TKB.murmur64a(b"tone", 7) == JKB.murmur64a(b"tone", 7)


@pytest.mark.parametrize("alpha, beta", [(0.4, 0.9), (1.5, -0.5)])
def test_rescore_nbest_matches_jax(lm_files, alpha, beta):
    _, files = lm_files
    jlm, tlm = JLM.load_lm(files["arpa"]), TLM.load_lm(files["arpa"])
    hyps = [("да нет", -3.0), ("да нед", -2.9), ("", -5.0), ("привет мир вот", -4.0),
            ("ёж", -3.5)]
    got = TR.rescore_nbest(hyps, tlm, alpha=alpha, beta=beta)
    want = JR.rescore_nbest(hyps, jlm, alpha=alpha, beta=beta)
    assert [h[0] for h in got] == [h[0] for h in want]
    np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want], atol=1e-9)
    assert TR.rescore_nbest(hyps, None) == hyps


def _emit(texts, rng, frames_per_char=2):
    """Phrase logprobs that emit ``texts[0]`` with competitors from the
    other texts (per character), plus noise."""
    main = texts[0]
    t = frames_per_char * len(main) + 4
    logits = rng.normal(0.0, 1.0, (t, V))
    logits[:, BLANK_ID] += 3.0
    for i, ch in enumerate(main):
        logits[2 + frames_per_char * i, LABELS.index(ch)] += 7.0
        for alt in texts[1:]:
            if i < len(alt):
                logits[2 + frames_per_char * i, LABELS.index(alt[i])] += 6.5
    x = logits - logits.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _phrases(seed, n=6):
    rng = np.random.default_rng(seed)
    pairs = [("да нет", "до нет"), ("привет мир", "привед мир"), ("вот так", "вод так"),
             ("она был", "она бил"), ("ёж", "еж"), ("мир да", "мир до")]
    return [_emit(pairs[i % len(pairs)], rng) for i in range(n)]


@pytest.mark.parametrize("variant", ["no_lm", "lm", "hotwords", "lm_hotword_rows", "dedup"])
def test_forward_batch_nbest_matches_jax(lm_files, variant):
    _, files = lm_files
    phrases = _phrases(1)
    kw = dict(beam_width=8, nbest=6, max_len=128)
    jlm = tlm = None
    if variant in ("lm", "lm_hotword_rows"):
        jlm, tlm = JLM.load_lm(files["probing"]), TLM.load_lm(files["probing"])
    if variant == "hotwords":
        kw.update(hotwords=["вод так", "до"], hotword_weight=3.0)
    jdec = JaxDecoder(jlm, **kw)
    tdec = DeviceBeamSearchCTCDecoder(tlm, device="cpu", **kw)
    rows = None, None
    if variant == "lm_hotword_rows":   # per-row biasing, two rows unbiased
        words = [["привед"], None, ["бил"], None, ["еж"], ["до"]]
        rows = ([jax_tables(w, 4.0) if w else None for w in words],
                [make_hotword_tables(w, 4.0) if w else None for w in words])
    n = 1 if variant == "dedup" else 4
    want = jdec.forward_batch_nbest(phrases, n, rows[0])
    got = tdec.forward_batch_nbest(phrases, n, rows[1])
    assert [[h[0] for h in r] for r in got] == [[h[0] for h in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([h[1] for h in g], [h[1] for h in w], atol=1e-4)
    for r in got:   # stripped-text duplicates collapse
        assert len({h[0] for h in r}) == len(r)
    assert tdec.forward_batch(phrases, rows[1]) == [r[0][0] if r else "" for r in got]


def test_decoder_buckets_pads_and_splits_like_jax():
    rng = np.random.default_rng(3)
    lens = [30, 64, 65, 150, 10, 70, 128]
    phrases = [_normalise_rows(rng.normal(0, 3, (t, V))) for t in lens]
    jdec, tdec = JaxDecoder(beam_width=4), DeviceBeamSearchCTCDecoder(beam_width=4, device="cpu")
    for dec in (jdec, tdec):
        dec.batch_floor, dec.max_batch = 4, 2
    assert tdec.forward_batch(phrases) == jdec.forward_batch(phrases)
    assert [tdec._t_bucket(t) for t in lens] == [64, 64, 128, 256, 64, 128, 128]
    padded, lengths = tdec._pad_batch(phrases[:3])
    assert padded.shape == (4, 128, V) and list(lengths) == [30, 64, 65, 0]
    assert tdec.nbest(phrases[0], 3) == tdec.forward_batch_nbest([phrases[0]], 3)[0]
    with pytest.raises(ValueError):
        tdec.forward(phrases[0].astype(np.float64))


def _normalise_rows(logits):
    x = logits - logits.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def test_from_local_reads_every_lm_format(lm_files):
    _, files = lm_files
    phrases = _phrases(4, n=3)
    texts = {fmt: DeviceBeamSearchCTCDecoder.from_local(path, beam_width=4, device="cpu")
             .forward_batch(phrases) for fmt, path in files.items() if "quant" not in fmt}
    assert len(set(map(tuple, texts.values()))) == 1
    assert texts["arpa"] == JaxDecoder.from_local(files["arpa"], beam_width=4).forward_batch(
        phrases)


def test_fused_lm_and_host_beam_raise(lm_files, tmp_path):
    """The fused search and the host beam are ported: ``fusion=True`` and
    ``build_decoder("beam")`` build them.  The host beam's Hub download
    (kenlm.bin) from an endpoint that cannot be reached, with an empty
    cache, raises naming the endpoint."""
    from tone_tpu_torch.decoder import BeamSearchCTCDecoder
    from tone_tpu_torch.decoding.device_lm import DeviceLM, DeviceProbingLM

    _, files = lm_files
    fused = DeviceBeamSearchCTCDecoder(TLM.load_lm(files["arpa"]), fusion=True, device="cpu")
    assert fused.fusion and isinstance(fused._lm, DeviceLM)
    for fmt, kind in (("arpa", DeviceLM), ("trie", DeviceLM), ("probing", DeviceProbingLM)):
        dec = DeviceBeamSearchCTCDecoder.from_local(files[fmt], fusion=True, device="cpu")
        assert dec.fusion and type(dec._lm) is kind
    host = build_decoder("beam", lm=files["arpa"])
    assert isinstance(host, BeamSearchCTCDecoder) and host._lm is not None
    phrase = _phrases(5, n=1)[0]
    assert fused.forward(phrase) == dec.forward(phrase)
    from test_torch_common import dead_endpoint

    from tone_tpu_torch.dev.local_hub import hub_env
    from tone_tpu_torch.hub import HubError

    dead = dead_endpoint()
    with hub_env(HF_ENDPOINT=dead, HF_HOME=tmp_path), pytest.raises(HubError) as err:
        BeamSearchCTCDecoder.from_hugging_face()
    assert dead in str(err.value) and "kenlm.bin" in str(err.value)


@pytest.mark.parametrize("kwargs, error", [
    ({"kind": "greedy", "hotwords": ["да"]}, ValueError),
    ({"kind": "device-beam", "fused_lm": True}, ValueError),
    ({"kind": "beam", "fused_lm": True}, ValueError),
    ({"kind": "viterbi"}, ValueError)])
def test_build_decoder_flag_errors_match_jax(kwargs, error):
    from tone_tpu.decoder import build_decoder as jax_build

    kind = kwargs.pop("kind")
    with pytest.raises(error) as want:
        jax_build(kind, **kwargs)
    with pytest.raises(error) as got:
        build_decoder(kind, device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


def test_build_decoder_device_beam(lm_files, tmp_path):
    _, files = lm_files
    (tmp_path / "hw.txt").write_text("да\n\n привет мир \n", encoding="utf-8")
    for spec in ("да, нет,,", "@" + str(tmp_path / "hw.txt"), "", None):
        assert parse_hotwords(spec) == jax_parse_hotwords(spec)
    dec = build_decoder("device-beam", lm=files["trie"], beam_width=6,
                        hotwords=parse_hotwords("да,нет"), hotword_weight=2.0, device="cpu")
    assert isinstance(dec, DeviceBeamSearchCTCDecoder) and dec.beam_width == 6
    assert dec.hotword_tables is not None and float(dec.hotword_tables.weight) == 2.0
    assert type(dec._lm).__name__ == "KenLMTrie"


def test_decoder_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceBeamSearchCTCDecoder()


# ---------------------------------------------------------------------------
# The forced aligner (align.py), a copy: equal spans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_words_matches_jax(seed):
    from tone_tpu import align as JA
    from tone_tpu_torch import align as TA

    phrase = _phrases(seed, n=1)[0]
    text = DeviceBeamSearchCTCDecoder(beam_width=4, device="cpu").forward(phrase)
    assert text
    got, want = TA.align_words(phrase, text), JA.align_words(phrase, text)
    assert [s[:3] for s in got] == [s[:3] for s in want]
    np.testing.assert_allclose([s[3] for s in got], [s[3] for s in want], atol=1e-6)
    assert TA.spans_to_word_timings(got, 40, 0.03, 0.63) == \
        tuple(TA.WordTiming(*vars(w).values())
              for w in JA.spans_to_word_timings(want, 40, 0.03, 0.63))
    with pytest.raises(ValueError):
        TA.viterbi_align(phrase[:2], [0, 1, 2])
    assert TA.align_words(phrase, "  ") == [] and math.isfinite(got[0][3])
