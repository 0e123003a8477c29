"""KenLM TRIE binary-format n-gram models: reader (scorer) and writer.

Completes first-party coverage of KenLM's on-disk model zoo (the reference
loads ``kenlm.bin`` through the kenlm C++ library, tone/decoder.py:84-108):
:mod:`tone_tpu_torch.decoding.kenlm_binary` handles the hash-table formats
(PROBING / REST_PROBING); this module handles the sorted-trie formats
produced by ``build_binary trie`` —

* ``TRIE`` (model type 2) — bit-packed reverse trie, full-precision floats;
* ``QUANT_TRIE`` (type 3) — same with probabilities/backoffs quantized to
  per-order bin tables (``build_binary -q bits -b bits trie``);
* ``ARRAY_TRIE`` (4) / ``QUANT_ARRAY_TRIE`` (5) — same with
  Bhiksha-compressed next pointers (``build_binary -a bits``): each middle
  level stores only the low ``inline_bits`` of every next pointer in the
  entry, plus a sorted u64 array A where ``A[h]`` is the first entry index
  whose pointer's high part is at least ``h`` (the high parts are
  non-decreasing, so the entry's high part is recovered with one binary
  search).  The chop width per level minimizes
  ``array_cost(64 bits x (max_next >> (required-chop))) - savings
  (n_pointers x chop)``, capped by the configured ``-a`` bits (KenLM's
  lm/bhiksha.cc ChopBits).

Like the probing module, the format is validated by round-trip against a
first-party writer plus score-equality fuzzing against :class:`ArpaLM`
(tests/test_kenlm_trie.py) — KenLM itself is not in this environment.

Format layout (little-endian), per KenLM's lm/{binary_format,vocab,trie,
search_trie,quantize} structures:

  [Sanity 88B + FixedWidthParameters 20B + counts + pad8]   as in
      kenlm_binary.py, but search_version = 1 (TrieSearch::kVersion)
  [vocab]   SortedVocabulary: u64 n_entries, then n_entries sorted u64
            MurmurHash64A word hashes (``<unk>`` excluded).  Word id =
            rank + 1 in this array; ``<unk>`` = 0.
  [quant]   (QUANT_TRIE only) u8 prob_bits, u8 backoff_bits, 6B pad, then
            per middle order: 2^prob_bits f32 prob bins + 2^backoff_bits
            f32 backoff bins; finally 2^prob_bits f32 bins for the longest
            order.  Backoff bins 0/1 are reserved for -0.0 / 0.0.
  [unigram] (counts[0] + 2) x {f32 prob, f32 backoff, u64 next}: entry w
            holds the unigram weights of word id w; [next_w, next_{w+1})
            is w's extension range in the bigram array.
  [middle]  per order n = 2..order-1, a bit-packed array of counts[n-1]+1
            entries (last = sentinel holding only the final next pointer):
            word (RequiredBits(counts[0]) bits) | weights | next
            (RequiredBits(counts[n]) bits; in the ARRAY variants the level
            is prefixed by a Bhiksha block — u8 version(0), u8 a_bits, the
            offsets array at align8(level_base+2), total prefix size
            8*(1+array_count)+7 — and the inline field shrinks to
            required-chop bits).  Weights are
            prob (non-positive float, 31 bits: f32 with the sign bit
            dropped) then backoff (full f32, 32 bits) for TRIE; for
            QUANT_TRIE, backoff bin index (backoff_bits) then prob bin
            index (prob_bits) — KenLM packs the quantized backoff first
            (lm/quantize.hh SeparatelyQuantize::MiddlePointer).
            Section size = ((entries+1)*total_bits + 7)//8 + 8 guard bytes.
  [longest] bit-packed: word | prob (31-bit non-positive float, or
            prob_bits bin index).  Same size formula.
  [strings] if has_vocabulary: '\\0'-terminated words in id order,
            starting with ``<unk>``.

The trie is *reversed*: the n-gram (w1 .. wn) is stored on the path
wn -> w_{n-1} -> .. -> w1, so each order-k entry's stored word is
w_{n-k+1} and lookups extend through the context most-recent-first,
mirroring KenLM's query loop (lm/model.cc ScoreExceptBackoff).  Every path
prefix must exist; prefixes absent from the source ARPA ("blanks", only
possible in pruned models) are materialized by the writer carrying their
fully backed-off probability and backoff -0.0 (kNoExtensionBackoff), which
keeps trie queries bit-identical to ARPA backoff queries.

A copy of ``tone_tpu/decoding/kenlm_trie.py``, kept in this package so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from bisect import bisect_left
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tone_tpu_torch.decoding.kenlm_binary import (
    MAGIC,
    _MAGIC_PAD,
    _SANITY_SIZE,
    _align8,
    murmur64a,
)
from tone_tpu_torch.decoding.lm import LanguageModel

__all__ = [
    "KenLMTrie", "read_kenlm_trie", "write_kenlm_trie", "trie_to_ngrams",
    "MODEL_TRIE", "MODEL_QUANT_TRIE", "MODEL_ARRAY_TRIE",
    "MODEL_QUANT_ARRAY_TRIE",
]

MODEL_TRIE = 2
MODEL_QUANT_TRIE = 3
MODEL_ARRAY_TRIE = 4
MODEL_QUANT_ARRAY_TRIE = 5
_QUANT_TYPES = (MODEL_QUANT_TRIE, MODEL_QUANT_ARRAY_TRIE)
_ARRAY_TYPES = (MODEL_ARRAY_TRIE, MODEL_QUANT_ARRAY_TRIE)
_TRIE_SEARCH_VERSION = 1   # lm/search_trie.hh TrieSearch::kVersion
_BHIKSHA_VERSION = 0       # lm/bhiksha.cc kArrayBhikshaVersion
DEFAULT_BHIKSHA_BITS = 22  # lm/config.cc pointer_bhiksha_bits default

_UNK_HASHES = (murmur64a(b"<unk>"), murmur64a(b"<UNK>"))
_NO_EXTENSION_BACKOFF = np.float32(-0.0)  # lm/blank.hh kNoExtensionBackoff


def _required_bits(max_value: int) -> int:
    """util::RequiredBits — bits to store values up to ``max_value``."""
    return max_value.bit_length() if max_value else 0


def _read_bits(buf, bit_off: int, width: int) -> int:
    """LSB-first bit read (util::ReadInt57 semantics, width <= 57)."""
    byte = bit_off >> 3
    word = int.from_bytes(buf[byte:byte + 8], "little")
    return (word >> (bit_off & 7)) & ((1 << width) - 1)


def _write_bits(buf: bytearray, bit_off: int, width: int, value: int) -> None:
    byte = bit_off >> 3
    word = int.from_bytes(buf[byte:byte + 8], "little")
    word |= (value & ((1 << width) - 1)) << (bit_off & 7)
    buf[byte:byte + 8] = word.to_bytes(8, "little")


def _f32_to_bits(value: float) -> int:
    return struct.unpack("<I", struct.pack("<f", value))[0]


def _bits_to_f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _decode_nonpositive31(bits31: int) -> float:
    """util::ReadNonPositiveFloat31 — restore the dropped sign bit."""
    return _bits_to_f32(bits31 | 0x8000_0000)


def _encode_nonpositive31(value: float) -> int:
    return _f32_to_bits(value) & 0x7FFF_FFFF


@dataclass
class _BhikshaPlan:
    """Per-level Bhiksha pointer compression (lm/bhiksha.cc semantics)."""

    chop: int         # high bits moved to the offsets array
    inline_bits: int  # low bits kept in each entry (= required - chop)
    array_count: int  # (max_next >> inline_bits) + 1
    size: int         # section prefix bytes: 8 * (1 + array_count) + 7

    @classmethod
    def plan(cls, n_pointers: int, max_next: int, a_bits: int) -> "_BhikshaPlan":
        """ChopBits: argmin over chop of array cost minus inline savings."""
        required = _required_bits(max_next)
        best_chop, lowest = 0, None
        for chop in range(min(required, a_bits) + 1):
            change = (max_next >> (required - chop)) * 64 - n_pointers * chop
            if lowest is None or change < lowest:
                lowest, best_chop = change, chop
        inline = required - best_chop
        count = (max_next >> inline) + 1
        return cls(best_chop, inline, count, 8 * (1 + count) + 7)


@dataclass
class _BitSection:
    """One bit-packed trie level (middle or longest)."""

    buf: memoryview
    entries: int
    word_bits: int
    quant_bits: int      # weight-field width (prob/backoff or bin indices)
    next_bits: int       # inline pointer bits; 0 for the longest level
    total_bits: int
    # ARRAY variants: sorted high-part offsets (A[h] = first entry index
    # whose pointer high part >= h); None for plain inline pointers.
    bhiksha: np.ndarray | None = None

    def word(self, i: int) -> int:
        return _read_bits(self.buf, i * self.total_bits, self.word_bits)

    def next_value(self, i: int) -> int:
        off = i * self.total_bits + self.word_bits + self.quant_bits
        low = _read_bits(self.buf, off, self.next_bits)
        if self.bhiksha is None:
            return low
        high = int(np.searchsorted(self.bhiksha, i, side="right")) - 1
        return (high << self.next_bits) | low

    def find(self, word: int, lo: int, hi: int) -> int:
        """Binary search for ``word`` in sorted entries [lo, hi); -1 if absent."""
        while lo < hi:
            mid = (lo + hi) // 2
            w = self.word(mid)
            if w < word:
                lo = mid + 1
            elif w > word:
                hi = mid
            else:
                return mid
        return -1


@dataclass
class _ParsedTrie:
    order: int
    counts: list[int]
    model_type: int
    search_version: int
    # unigram arrays, indexed by word id (length counts[0] + 2)
    uni_prob: np.ndarray
    uni_backoff: np.ndarray
    uni_next: np.ndarray
    middles: list[_BitSection]      # orders 2..order-1
    longest: _BitSection
    # quantization bin tables (QUANT_TRIE): per middle order (prob, backoff),
    # then the longest order's prob bins
    quant_mid: list[tuple[np.ndarray, np.ndarray]] = field(default_factory=list)
    quant_long: np.ndarray | None = None
    prob_bits: int = 0
    backoff_bits: int = 0
    # vocab: sorted word hashes; id = index + 1 (0 = <unk>)
    vocab_hashes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))
    words: list[str] = field(default_factory=list)

    # -- per-level weight decoding ------------------------------------------
    def middle_weights(self, n: int, i: int) -> tuple[float, float]:
        """(prob, backoff) of entry ``i`` at order ``n`` (2 <= n < order)."""
        sec = self.middles[n - 2]
        off = i * sec.total_bits + sec.word_bits
        if self.model_type in _QUANT_TYPES:
            b_idx = _read_bits(sec.buf, off, self.backoff_bits)
            p_idx = _read_bits(sec.buf, off + self.backoff_bits, self.prob_bits)
            probs, backoffs = self.quant_mid[n - 2]
            return float(probs[p_idx]), float(backoffs[b_idx])
        prob = _decode_nonpositive31(_read_bits(sec.buf, off, 31))
        backoff = _bits_to_f32(_read_bits(sec.buf, off + 31, 32))
        return prob, backoff

    def longest_prob(self, i: int) -> float:
        sec = self.longest
        off = i * sec.total_bits + sec.word_bits
        if self.model_type in _QUANT_TYPES:
            return float(self.quant_long[_read_bits(sec.buf, off, self.prob_bits)])
        return _decode_nonpositive31(_read_bits(sec.buf, off, 31))


def read_kenlm_trie(path: str | Path) -> _ParsedTrie:
    data = Path(path).read_bytes()
    if data[:len(MAGIC) - 4] != MAGIC[:-4]:
        raise ValueError(f"{path}: not a KenLM binary (bad magic)")
    order, = struct.unpack_from("<B", data, _SANITY_SIZE)
    _, model_type, has_vocab, search_version = struct.unpack_from(
        "<fIB3xI", data, _SANITY_SIZE + 4)
    if model_type not in (MODEL_TRIE, MODEL_QUANT_TRIE,
                          MODEL_ARRAY_TRIE, MODEL_QUANT_ARRAY_TRIE):
        raise ValueError(
            f"{path}: not a KenLM trie binary (model type {model_type}); "
            "use tone_tpu_torch.decoding.kenlm_binary for the probing formats")
    counts = list(struct.unpack_from(
        f"<{order}Q", data, _SANITY_SIZE + 20))
    if order < 2 or any(c <= 0 for c in counts):
        raise ValueError(f"{path}: corrupt n-gram counts {counts}")
    off = _align8(_SANITY_SIZE + 20 + 8 * order)

    # --- SortedVocabulary: u64 count + sorted hashes -----------------------
    n_vocab, = struct.unpack_from("<Q", data, off)
    off += 8
    if n_vocab > counts[0]:
        raise ValueError(f"{path}: vocab holds {n_vocab} hashes, unigram "
                         f"count is {counts[0]}")
    vocab_hashes = np.frombuffer(data, "<u8", count=n_vocab, offset=off)
    off += 8 * n_vocab

    # --- quantization tables ------------------------------------------------
    prob_bits = backoff_bits = 0
    quant_mid: list[tuple[np.ndarray, np.ndarray]] = []
    quant_long = None
    if model_type in _QUANT_TYPES:
        prob_bits, backoff_bits = data[off], data[off + 1]
        if not (0 < prob_bits <= 25 and 0 < backoff_bits <= 25):
            raise ValueError(
                f"{path}: corrupt quantization bits "
                f"({prob_bits}, {backoff_bits})")
        off += 8
        for _ in range(order - 2):
            p = np.frombuffer(data, "<f4", count=1 << prob_bits, offset=off)
            off += 4 << prob_bits
            b = np.frombuffer(data, "<f4", count=1 << backoff_bits, offset=off)
            off += 4 << backoff_bits
            quant_mid.append((p, b))
        quant_long = np.frombuffer(data, "<f4", count=1 << prob_bits,
                                   offset=off)
        off += 4 << prob_bits

    # --- unigram array -------------------------------------------------------
    uni_dt = np.dtype([("prob", "<f4"), ("backoff", "<f4"), ("next", "<u8")])
    uni = np.frombuffer(data, uni_dt, count=counts[0] + 2, offset=off)
    off += (counts[0] + 2) * uni_dt.itemsize
    if int(uni["next"][counts[0]]) != counts[1]:
        raise ValueError(
            f"{path}: unigram sentinel next {int(uni['next'][counts[0]])} "
            f"!= bigram count {counts[1]} — corrupt or unsupported layout")

    # --- bit-packed middle and longest levels --------------------------------
    word_bits = _required_bits(counts[0])
    quantized = model_type in _QUANT_TYPES
    bhiksha = model_type in _ARRAY_TYPES
    mid_quant_bits = prob_bits + backoff_bits if quantized else 63
    long_quant_bits = prob_bits if quantized else 31
    view = memoryview(data)
    middles = []
    for n in range(2, order):
        entries = counts[n - 1]
        offsets = None
        if bhiksha:
            version, a_bits = data[off], data[off + 1]
            if version != _BHIKSHA_VERSION:
                raise ValueError(
                    f"{path}: array-trie pointer compression version "
                    f"{version} unsupported (expected {_BHIKSHA_VERSION})")
            plan = _BhikshaPlan.plan(entries + 1, counts[n], a_bits)
            arr_off = _align8(off + 2)
            offsets = np.frombuffer(data, "<u8", count=plan.array_count,
                                    offset=arr_off)
            off += plan.size
            next_bits = plan.inline_bits
        else:
            next_bits = _required_bits(counts[n])
        total = word_bits + mid_quant_bits + next_bits
        size = ((entries + 1) * total + 7) // 8 + 8
        middles.append(_BitSection(view[off:off + size], entries, word_bits,
                                   mid_quant_bits, next_bits, total,
                                   bhiksha=offsets))
        off += size
    entries = counts[-1]
    total = word_bits + long_quant_bits
    size = ((entries + 1) * total + 7) // 8 + 8
    longest = _BitSection(view[off:off + size], entries, word_bits,
                          long_quant_bits, 0, total)
    off += size

    words: list[str] = []
    if has_vocab and off < len(data):
        blob = data[off:]
        words = [w.decode("utf-8", "replace") for w in blob.split(b"\x00") if w]
        if words and words[0] != "<unk>":
            words = []

    return _ParsedTrie(
        order=order, counts=counts, model_type=model_type,
        search_version=search_version,
        uni_prob=uni["prob"].astype(np.float32),
        uni_backoff=uni["backoff"].astype(np.float32),
        uni_next=uni["next"].astype(np.int64),
        middles=middles, longest=longest,
        quant_mid=quant_mid, quant_long=quant_long,
        prob_bits=prob_bits, backoff_bits=backoff_bits,
        vocab_hashes=np.ascontiguousarray(vocab_hashes), words=words)


class KenLMTrie(LanguageModel):
    """Word n-gram LM loaded from a KenLM trie ``.bin`` (TRIE/QUANT_TRIE).

    Scores are log10 with Katz backoff, identical to KenLM queries; unknown
    words (in context or predicted) map to ``<unk>`` (id 0).
    """

    def __init__(self, path: str | Path):
        p = read_kenlm_trie(path)
        self._p = p
        self.order = p.order
        self.path = str(path)

    # -- id mapping -----------------------------------------------------------
    def word_id(self, word: str) -> int:
        h = murmur64a(word.encode("utf-8"))
        if h in _UNK_HASHES:
            return 0
        hashes = self._p.vocab_hashes
        i = int(np.searchsorted(hashes, np.uint64(h)))
        if i < len(hashes) and int(hashes[i]) == h:
            return i + 1
        return 0

    @property
    def words(self) -> list[str]:
        """Vocabulary strings in id order (empty if not bundled)."""
        return self._p.words

    # -- scoring ---------------------------------------------------------------
    def score_ids(self, context_ids: tuple[int, ...], word_id: int) -> float:
        """log10 P(word | context) over KenLM word ids with backoff."""
        p = self._p
        ctx = context_ids[-(p.order - 1):] if p.order > 1 else ()
        prob = float(p.uni_prob[word_id])
        matched = 1
        lo, hi = int(p.uni_next[word_id]), int(p.uni_next[word_id + 1])
        # Extend through the context most-recent-first down the reversed trie.
        for k, cid in enumerate(reversed(ctx)):
            n = k + 2
            if lo >= hi:
                break
            if n < p.order:
                sec = p.middles[n - 2]
                i = sec.find(cid, lo, hi)
                if i < 0:
                    break
                pr, _ = p.middle_weights(n, i)
                prob, matched = pr, n
                lo, hi = sec.next_value(i), sec.next_value(i + 1)
            else:
                i = p.longest.find(cid, lo, hi)
                if i >= 0:
                    prob, matched = p.longest_prob(i), n
                break
        # Backoff weights of context grams with length >= matched.
        backoff = 0.0
        lo = hi = 0
        for j, cid in enumerate(reversed(ctx), start=1):
            if j == 1:
                if j >= matched:
                    backoff += float(p.uni_backoff[cid])
                lo, hi = int(p.uni_next[cid]), int(p.uni_next[cid + 1])
                continue
            if lo >= hi:
                break
            sec = p.middles[j - 2]
            i = sec.find(cid, lo, hi)
            if i < 0:
                break
            _, bo = p.middle_weights(j, i)
            if j >= matched:
                backoff += bo
            lo, hi = sec.next_value(i), sec.next_value(i + 1)
        return prob + backoff

    def score(self, context: tuple[str, ...], word: str) -> float:
        ctx_ids = tuple(self.word_id(w) for w in context)
        return self.score_ids(ctx_ids, self.word_id(word))


def trie_to_ngrams(
    trie: "KenLMTrie | _ParsedTrie",
) -> list[dict[tuple[str, ...], tuple[float, float]]]:
    """Enumerate a parsed trie back into ARPA-style word tables
    (``ngrams[k]``: (k+1)-word tuple -> (log10 prob, log10 backoff)).

    Requires bundled vocabulary strings (``build_binary`` includes them by
    default).  Used to feed trie artifacts to consumers of the table form —
    e.g. conversion to the probing format for the native C++ scorer.
    """
    p = trie._p if isinstance(trie, KenLMTrie) else trie
    if len(p.words) != p.counts[0]:
        raise ValueError(
            "trie binary has no (or truncated) vocabulary strings; "
            "cannot reconstruct word tables")
    out: list[dict[tuple[str, ...], tuple[float, float]]] = [
        {} for _ in range(p.order)]
    words = p.words

    def walk(path_words: tuple[str, ...], n: int, lo: int, hi: int) -> None:
        # path_words is the reversed gram so far; extend at order n.
        if n > p.order or lo >= hi:
            return
        if n < p.order:
            sec = p.middles[n - 2]
            for i in range(lo, hi):
                w = words[sec.word(i)]
                pr, bo = p.middle_weights(n, i)
                gram = tuple(reversed((*path_words, w)))
                out[n - 1][gram] = (pr, bo)
                walk((*path_words, w), n + 1,
                     sec.next_value(i), sec.next_value(i + 1))
        else:
            for i in range(lo, hi):
                gram = tuple(reversed((*path_words, words[p.longest.word(i)])))
                out[n - 1][gram] = (p.longest_prob(i), 0.0)

    for wid in range(p.counts[0]):
        out[0][(words[wid],)] = (float(p.uni_prob[wid]),
                                 float(p.uni_backoff[wid]))
        walk((words[wid],), 2,
             int(p.uni_next[wid]), int(p.uni_next[wid + 1]))
    return out


# ---------------------------------------------------------------------------
# Writer (ARPA tables -> KenLM trie binary)
# ---------------------------------------------------------------------------


def _make_bins(values: list[float], n_bins: int) -> np.ndarray:
    """KenLM's equal-count quantization bins (lm/quantize.cc MakeBins):
    sort, split into ``n_bins`` equal-count chunks, center = chunk mean."""
    vals = sorted(values)
    centers = np.empty(n_bins, np.float32)
    start = 0
    for i in range(n_bins):
        finish = (len(vals) * (i + 1)) // n_bins
        if finish == start:
            centers[i] = centers[i - 1] if i else -np.inf
        else:
            centers[i] = np.float32(sum(vals[start:finish]) / (finish - start))
        start = finish
    return centers


def _encode_bin(centers: np.ndarray, value: float, reserved: int) -> int:
    """Nearest-center encode with ``reserved`` leading bins skipped
    (lm/quantize.hh Bins::Encode)."""
    usable = centers[reserved:]
    i = bisect_left(usable.tolist(), value)
    if i == 0:
        return reserved
    if i == len(usable):
        return len(centers) - 1
    below, above = float(usable[i - 1]), float(usable[i])
    return reserved + i - (1 if value - below < above - value else 0)


def write_kenlm_trie(
    ngrams: list[dict[tuple[str, ...], tuple[float, float]]],
    path: str | Path,
    *,
    quant_bits: tuple[int, int] | None = None,
    bhiksha_bits: int | None = None,
    include_vocab: bool = True,
    unknown_missing_logprob: float = -100.0,
) -> None:
    """Serialize ARPA-style tables into a KenLM trie binary.

    ``quant_bits=(prob_bits, backoff_bits)`` emits the QUANT variants (lossy
    — the per-order bin tables are trained with KenLM's equal-count
    binning); ``None`` emits full-precision probabilities.  ``bhiksha_bits``
    (``build_binary -a``) emits the ARRAY variants: next pointers compressed
    per level by the lowest-cost chop up to that many bits.  Missing path
    prefixes of pruned models are materialized as blanks carrying their
    backed-off probability (see module docstring).
    """
    order = len(ngrams)
    if order < 2:
        raise ValueError("KenLM trie binaries require order >= 2")
    if not all(ngrams):
        raise ValueError("every n-gram order must be populated")

    # --- vocab: ids by sorted hash, <unk> = 0 ------------------------------
    hash_to_word: dict[int, str] = {}
    saw_unk = False
    for (w,) in ngrams[0]:
        h = murmur64a(w.encode("utf-8"))
        if h in _UNK_HASHES:
            saw_unk = True
            continue
        hash_to_word[h] = w
    if not saw_unk:
        raise ValueError("unigram table must contain <unk>")
    sorted_hashes = sorted(hash_to_word)
    ids = {hash_to_word[h]: i + 1 for i, h in enumerate(sorted_hashes)}
    ids["<unk>"] = ids["<UNK>"] = 0
    id_words = ["<unk>"] + [hash_to_word[h] for h in sorted_hashes]
    n_vocab = len(id_words)  # == counts[0] (unigram table includes <unk>)

    def wid(w: str) -> int:
        try:
            return ids[w]
        except KeyError:
            raise ValueError(
                f"n-gram word {w!r} missing from unigrams") from None

    # --- reversed paths per order, with blank closure ------------------------
    # paths[n-1]: id-tuple path (reversed gram) -> (prob, backoff, is_blank)
    paths: list[dict[tuple[int, ...], tuple[float, float]]] = []
    for n, table in enumerate(ngrams, start=1):
        level = {}
        for gram, (prob, backoff) in table.items():
            if len(gram) != n:
                raise ValueError(f"{gram} in the {n}-gram table")
            level[tuple(wid(w) for w in reversed(gram))] = (prob, backoff)
        paths.append(level)
    arpa = None
    for n in range(order, 2, -1):
        for p in list(paths[n - 1]):
            prefix = p[:n - 1]
            if prefix not in paths[n - 2]:
                if arpa is None:
                    from tone_tpu_torch.decoding.lm import ArpaLM
                    arpa = ArpaLM(ngrams)
                gram = tuple(id_words[i] for i in reversed(prefix))
                paths[n - 2][prefix] = (
                    arpa.score(gram[:-1], gram[-1]),
                    float(_NO_EXTENSION_BACKOFF))
    # (Bigram prefixes are unigrams, which are complete by construction —
    # every id above came from ngrams[0].)
    counts = [n_vocab] + [len(level) for level in paths[1:]]
    sorted_levels = [sorted(level.items()) for level in paths[1:]]

    # --- child ranges ---------------------------------------------------------
    # next_starts[k][i] = index of the first order-(k+3) child of entry i;
    # unigram children are the order-2 entries grouped by path[0] (= word id).
    def child_starts(parent_paths: list[tuple[int, ...]],
                     child_level: list, plen: int) -> list[int]:
        idx = {p: i for i, p in enumerate(parent_paths)}
        n_children = [0] * len(parent_paths)
        last_parent = -1
        for cp, _ in child_level:
            pi = idx[cp[:plen]]
            if pi < last_parent:
                raise AssertionError("child order violates parent order")
            last_parent = pi
            n_children[pi] += 1
        starts = [0] * (len(parent_paths) + 1)
        for i, c in enumerate(n_children):
            starts[i + 1] = starts[i] + c
        return starts

    uni_starts = child_starts([(w,) for w in range(n_vocab)],
                              sorted_levels[0], 1)
    mid_starts = [
        child_starts([p for p, _ in sorted_levels[n - 2]],
                     sorted_levels[n - 1], n)
        for n in range(2, order)
    ]

    # --- quantization tables ---------------------------------------------------
    quantized = quant_bits is not None
    if quantized:
        prob_bits, backoff_bits = quant_bits
        # backoff needs >= 2 bits: indices 0/1 are the reserved
        # no-extension/zero bins (lm/quantize.hh), so a 1-bit field has no
        # room for actual backoff values and would silently truncate them.
        if not (0 < prob_bits <= 25 and 2 <= backoff_bits <= 25):
            raise ValueError(
                f"quant bits out of range {quant_bits} "
                "(prob 1..25, backoff 2..25)")
        quant_mid = []
        for n in range(2, order):
            level = sorted_levels[n - 2]
            probs = _make_bins([v[0] for _, v in level], 1 << prob_bits)
            bo_vals = [v[1] for _, v in level if v[1] != 0.0]
            backoffs = np.empty(1 << backoff_bits, np.float32)
            backoffs[0] = _NO_EXTENSION_BACKOFF   # reserved: kNoExtensionQuant
            backoffs[1] = np.float32(0.0)         # reserved: kExtensionQuant
            backoffs[2:] = _make_bins(bo_vals or [0.0],
                                      (1 << backoff_bits) - 2)
            quant_mid.append((probs, backoffs))
        quant_long = _make_bins([v[0] for _, v in sorted_levels[-1]],
                                1 << prob_bits)
        mid_quant_bits = prob_bits + backoff_bits
        long_quant_bits = prob_bits
    else:
        prob_bits = backoff_bits = 0
        mid_quant_bits, long_quant_bits = 63, 31

    # --- assemble ---------------------------------------------------------------
    if bhiksha_bits is not None and not (0 < bhiksha_bits <= 57):
        raise ValueError(f"bhiksha_bits out of range: {bhiksha_bits}")
    model_type = (MODEL_QUANT_TRIE if quantized else MODEL_TRIE) + \
        (2 if bhiksha_bits is not None else 0)
    out = bytearray()
    out += MAGIC.ljust(_MAGIC_PAD, b"\x00")
    out += struct.pack("<fff", 0.0, 1.0, -0.5)
    out += struct.pack("<II", 1, 0xFFFFFFFF)
    out += b"\x00" * 4
    out += struct.pack("<Q", 1)
    assert len(out) == _SANITY_SIZE
    out += struct.pack("<B3xfIB3xI", order, 1.5, model_type,
                       1 if include_vocab else 0, _TRIE_SEARCH_VERSION)
    out += struct.pack(f"<{order}Q", *counts)
    out += b"\x00" * (_align8(len(out)) - len(out))

    out += struct.pack("<Q", len(sorted_hashes))
    out += np.asarray(sorted_hashes, np.uint64).astype("<u8").tobytes()

    if quantized:
        out += bytes([prob_bits, backoff_bits]) + b"\x00" * 6
        for probs, backoffs in quant_mid:
            out += probs.astype("<f4").tobytes()
            out += backoffs.astype("<f4").tobytes()
        out += quant_long.astype("<f4").tobytes()

    uni_dt = np.dtype([("prob", "<f4"), ("backoff", "<f4"), ("next", "<u8")])
    uni = np.zeros(n_vocab + 2, uni_dt)
    uni["prob"][0] = unknown_missing_logprob
    for (w,), (prob, backoff) in ngrams[0].items():
        uni["prob"][wid(w)] = prob
        uni["backoff"][wid(w)] = backoff
    uni["next"][:n_vocab + 1] = uni_starts
    out += uni.tobytes()

    word_bits = _required_bits(n_vocab)
    for n in range(2, order):
        level = sorted_levels[n - 2]
        starts = mid_starts[n - 2]
        if bhiksha_bits is not None:
            plan = _BhikshaPlan.plan(len(level) + 1, counts[n], bhiksha_bits)
            next_bits = plan.inline_bits
            prefix = bytearray(plan.size)
            prefix[0] = _BHIKSHA_VERSION
            prefix[1] = bhiksha_bits
            base = len(out)
            arr_pos = _align8(base + 2) - base
            encodes = (np.asarray(starts, np.uint64)
                       >> np.uint64(plan.inline_bits))
            arr = np.searchsorted(
                encodes, np.arange(plan.array_count, dtype=np.uint64),
                side="left").astype("<u8")
            prefix[arr_pos:arr_pos + 8 * plan.array_count] = arr.tobytes()
            out += bytes(prefix)
        else:
            next_bits = _required_bits(counts[n])
        total = word_bits + mid_quant_bits + next_bits
        buf = bytearray(((len(level) + 1) * total + 7) // 8 + 8)
        for i, (p, (prob, backoff)) in enumerate(level):
            off = i * total
            _write_bits(buf, off, word_bits, p[-1])
            off += word_bits
            if quantized:
                probs, backoffs = quant_mid[n - 2]
                if backoff == 0.0:
                    b_idx = 0 if np.signbit(np.float32(backoff)) else 1
                else:
                    b_idx = _encode_bin(backoffs, backoff, 2)
                _write_bits(buf, off, backoff_bits, b_idx)
                _write_bits(buf, off + backoff_bits, prob_bits,
                            _encode_bin(probs, prob, 0))
            else:
                _write_bits(buf, off, 31, _encode_nonpositive31(prob))
                _write_bits(buf, off + 31, 32, _f32_to_bits(backoff))
            _write_bits(buf, off + mid_quant_bits, next_bits, starts[i])
        # sentinel: final next pointer only
        _write_bits(buf, len(level) * total + word_bits + mid_quant_bits,
                    next_bits, starts[len(level)])
        out += bytes(buf)

    level = sorted_levels[-1]
    total = word_bits + long_quant_bits
    buf = bytearray(((len(level) + 1) * total + 7) // 8 + 8)
    for i, (p, (prob, _)) in enumerate(level):
        off = i * total
        _write_bits(buf, off, word_bits, p[-1])
        if quantized:
            _write_bits(buf, off + word_bits, prob_bits,
                        _encode_bin(quant_long, prob, 0))
        else:
            _write_bits(buf, off + word_bits, 31, _encode_nonpositive31(prob))
    out += bytes(buf)

    if include_vocab:
        for w in id_words:
            out += w.encode("utf-8") + b"\x00"

    Path(path).write_bytes(bytes(out))
