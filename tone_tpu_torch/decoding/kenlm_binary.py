"""KenLM binary-format n-gram models: reader (scorer) and writer.

The reference distributes its word LM as ``kenlm.bin`` (reference
tone/decoder.py:84-95) — a KenLM *binary* model, i.e. the probing-hash-table
on-disk format produced by KenLM's ``build_binary`` (the default "probing"
ModelType).  This module implements that format first-party:

* :func:`read_kenlm_binary` — parse a ``.bin`` into plain numpy tables.
* :class:`KenLMBinary` — a :class:`~tone_tpu_torch.decoding.lm.LanguageModel`
  scoring queries exactly like KenLM does (same vocab hash, same chained
  n-gram hash, same Katz backoff accumulation).
* :func:`write_kenlm_binary` — serialize ARPA-style n-gram tables into the
  same format (used to convert ``.arpa`` → ``.bin`` and to round-trip-test
  the reader without KenLM installed).

Format layout (little-endian), per KenLM's binary_format / vocab /
search_hashed structures:

  [Sanity 88B]  magic[56] f32{0,1,-0.5} u32{1,max} pad4 u64{1}
  [FixedWidthParameters 20B]  u8 order pad3 f32 probing_multiplier
                              u32 model_type u8 has_vocabulary pad3
                              u32 search_version
  [counts: order x u64]       n-gram counts, then pad to 8
  [vocab]   u64 bound, then probing table of {u64 murmur64a(word), u32 id}
            (12B entries, buckets = max(n+1, floor(mult*n)), empty key = 0)
  [search]  unigram array (counts[0]+1) x {f32 prob, f32 backoff}
            middle tables n=2..order-1: {u64 key, f32 prob, f32 backoff} 16B
            longest table n=order:      {u64 key, f32 prob} 12B
  [strings] if has_vocabulary: "<unk>\\0" + word '\\0'-terminated, id order

The prob field's sign bit doubles as KenLM's "independent left" flag: the
true log10 probability is always ``-abs(stored)``; the bit is cleared
(stored positive) for grams that appear as the context of a longer gram.

n-gram keys chain word ids from the LAST word backwards:
``key(w1..wn) = C(..C(C(u64(id(wn)), id(w_{n-1})), id(w_{n-2})).., id(w1))``
with ``C(h, w) = (h * 8978948897894561157) ^ ((1+w) * 17894857484156487943)``
(mod 2**64).  Word hash: MurmurHash64A(word_bytes, seed=0); ``<unk>``/
``<UNK>`` never enter the vocab table and map to id 0.

A copy of ``tone_tpu/decoding/kenlm_binary.py``, kept in this package so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tone_tpu_torch.decoding.lm import LanguageModel

__all__ = [
    "KenLMBinary", "read_kenlm_binary", "write_kenlm_binary",
    "kenlm_model_type",
    "murmur64a", "combine_word_hash",
    "MODEL_PROBING", "MODEL_REST_PROBING",
]

_MASK = (1 << 64) - 1
MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\x00"
_MAGIC_PAD = 56  # ALIGN8(len(MAGIC) = 52)
_SANITY_SIZE = 88
_FIXED_SIZE = 20

MODEL_PROBING = 0
MODEL_REST_PROBING = 1
_TRIE_TYPES = {2: "TRIE", 3: "QUANT_TRIE", 4: "ARRAY_TRIE", 5: "QUANT_ARRAY_TRIE"}

_COMBINE_A = 8978948897894561157
_COMBINE_B = 17894857484156487943


def _align8(x: int) -> int:
    return (x + 7) & ~7


def murmur64a(data: bytes, seed: int = 0) -> int:
    """MurmurHash64A — KenLM's vocabulary hash (util/murmur_hash.cc)."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ (len(data) * m)) & _MASK
    n8 = len(data) & ~7
    for i in range(0, n8, 8):
        k = int.from_bytes(data[i:i + 8], "little")
        k = (k * m) & _MASK
        k ^= k >> r
        k = (k * m) & _MASK
        h = ((h ^ k) * m) & _MASK
    tail = data[n8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & _MASK
    h ^= h >> r
    h = (h * m) & _MASK
    h ^= h >> r
    return h


_UNK_HASHES = (murmur64a(b"<unk>"), murmur64a(b"<UNK>"))


def combine_word_hash(current: int, word_id: int) -> int:
    """KenLM's n-gram key chaining (lm/search_hashed CombineWordHash)."""
    return ((current * _COMBINE_A) ^ ((1 + word_id) * _COMBINE_B)) & _MASK


def kenlm_model_type(path: str | Path) -> int | None:
    """The ModelType of a KenLM binary (0=PROBING .. 5=QUANT_ARRAY_TRIE),
    or ``None`` if the file is not a KenLM binary."""
    with open(path, "rb") as f:
        header = f.read(_SANITY_SIZE + _FIXED_SIZE)
    if len(header) < _SANITY_SIZE + _FIXED_SIZE or \
            header[:len(MAGIC) - 4] != MAGIC[:-4]:
        return None
    model_type, = struct.unpack_from("<I", header, _SANITY_SIZE + 8)
    return model_type


def _buckets(entries: int, multiplier: float) -> int:
    # util::ProbingHashTable::Size computes (uint64)(multiplier *
    # (float)entries) in *single* precision; emulate with float32 or the
    # bucket count (hence every later section offset) is off by one for
    # tables of >= 2^24 entries — normal for real ASR LMs.
    scaled = np.float32(multiplier) * np.float32(entries)
    return max(entries + 1, int(scaled))


@dataclass
class _ParsedBinary:
    order: int
    counts: list[int]
    model_type: int
    probing_multiplier: float
    # unigram arrays indexed by word id (length counts[0] + 1)
    uni_prob: np.ndarray
    uni_backoff: np.ndarray
    # per middle order n=2..order-1: (sorted keys u64, prob f32, backoff f32)
    middles: list[tuple[np.ndarray, np.ndarray, np.ndarray]]
    # longest order: (sorted keys u64, prob f32)
    longest: tuple[np.ndarray, np.ndarray]
    # vocab: sorted word-hash keys -> ids
    vocab_hashes: np.ndarray
    vocab_ids: np.ndarray
    words: list[str] = field(default_factory=list)  # id order, if bundled


def _extract_table(raw: np.ndarray) -> np.ndarray:
    """Drop empty buckets (key == 0) from a probing table."""
    return raw[raw["key"] != 0]


def read_kenlm_binary(path: str | Path) -> _ParsedBinary:
    data = Path(path).read_bytes()
    if data[:len(MAGIC) - 4] != MAGIC[:-4]:
        raise ValueError(f"{path}: not a KenLM binary (bad magic)")
    version = data[len(MAGIC) - 4:_MAGIC_PAD].split(b"\n")[0].decode().strip()
    if version != "5":
        raise ValueError(
            f"{path}: unsupported KenLM binary format version {version!r} "
            "(only version 5 is supported)")
    order, = struct.unpack_from("<B", data, _SANITY_SIZE)
    probing_multiplier, model_type, has_vocab, search_version = struct.unpack_from(
        "<fIB3xI", data, _SANITY_SIZE + 4)
    if model_type in _TRIE_TYPES:
        raise ValueError(
            f"{path}: this is a KenLM {_TRIE_TYPES[model_type]} binary; "
            "read_kenlm_binary only parses the probing hash-table formats — "
            "load it via tone_tpu_torch.decoding.kenlm_trie (or load_lm, which "
            "dispatches on the header)")
    if model_type not in (MODEL_PROBING, MODEL_REST_PROBING):
        raise ValueError(f"{path}: unknown KenLM model type {model_type}")
    counts = list(struct.unpack_from(
        f"<{order}Q", data, _SANITY_SIZE + _FIXED_SIZE))
    if order < 1 or any(c <= 0 for c in counts):
        raise ValueError(f"{path}: corrupt n-gram counts {counts}")
    off = _align8(_SANITY_SIZE + _FIXED_SIZE + 8 * order)

    # --- vocabulary: u64 bound + probing table of (u64 hash, u32 id) ------
    bound, = struct.unpack_from("<Q", data, off)
    off += 8
    vbuckets = _buckets(counts[0], probing_multiplier)
    vocab_dt = np.dtype([("key", "<u8"), ("value", "<u4")])
    vraw = np.frombuffer(data, vocab_dt, count=vbuckets, offset=off)
    off += vbuckets * vocab_dt.itemsize
    vent = _extract_table(vraw)
    vorder = np.argsort(vent["key"], kind="stable")
    vocab_hashes = np.ascontiguousarray(vent["key"][vorder])
    vocab_ids = np.ascontiguousarray(vent["value"][vorder]).astype(np.int64)
    if (vocab_ids >= max(bound, 1)).any():
        raise ValueError(f"{path}: corrupt vocabulary (id >= bound {bound})")

    # --- search: unigrams + middle tables + longest table -----------------
    rest = model_type == MODEL_REST_PROBING
    uni_dt = (np.dtype([("prob", "<f4"), ("backoff", "<f4"), ("rest", "<f4")])
              if rest else np.dtype([("prob", "<f4"), ("backoff", "<f4")]))
    uni = np.frombuffer(data, uni_dt, count=counts[0] + 1, offset=off)
    off += (counts[0] + 1) * uni_dt.itemsize
    uni_prob = -np.abs(uni["prob"].astype(np.float32))
    uni_backoff = uni["backoff"].astype(np.float32)

    mid_dt = (np.dtype([("key", "<u8"), ("prob", "<f4"), ("backoff", "<f4"),
                        ("rest", "<f4")])
              if rest else
              np.dtype([("key", "<u8"), ("prob", "<f4"), ("backoff", "<f4")]))
    middles = []
    for n in range(2, order):
        nbuckets = _buckets(counts[n - 1], probing_multiplier)
        raw = np.frombuffer(data, mid_dt, count=nbuckets, offset=off)
        off += nbuckets * mid_dt.itemsize
        ent = _extract_table(raw)
        sort = np.argsort(ent["key"], kind="stable")
        middles.append((
            np.ascontiguousarray(ent["key"][sort]),
            -np.abs(ent["prob"][sort].astype(np.float32)),
            ent["backoff"][sort].astype(np.float32),
        ))
    long_dt = np.dtype([("key", "<u8"), ("prob", "<f4")])
    if order > 1:
        nbuckets = _buckets(counts[order - 1], probing_multiplier)
        raw = np.frombuffer(data, long_dt, count=nbuckets, offset=off)
        off += nbuckets * long_dt.itemsize
        ent = _extract_table(raw)
        sort = np.argsort(ent["key"], kind="stable")
        longest = (np.ascontiguousarray(ent["key"][sort]),
                   -np.abs(ent["prob"][sort].astype(np.float32)))
    else:
        longest = (np.zeros(0, np.uint64), np.zeros(0, np.float32))

    words: list[str] = []
    if has_vocab and off < len(data):
        blob = data[off:]
        words = [w.decode("utf-8", "replace")
                 for w in blob.split(b"\x00") if w]
        if words and words[0] != "<unk>":
            words = []  # strings section not where expected; ignore

    for n, (keys, _, _) in enumerate(middles, start=2):
        if len(keys) != counts[n - 1]:
            raise ValueError(
                f"{path}: {n}-gram table holds {len(keys)} entries, header "
                f"says {counts[n - 1]} — corrupt or unsupported layout")
    if order > 1 and len(longest[0]) != counts[-1]:
        raise ValueError(
            f"{path}: {order}-gram table holds {len(longest[0])} entries, "
            f"header says {counts[-1]} — corrupt or unsupported layout")

    return _ParsedBinary(
        order=order, counts=counts, model_type=model_type,
        probing_multiplier=probing_multiplier,
        uni_prob=uni_prob, uni_backoff=uni_backoff,
        middles=middles, longest=longest,
        vocab_hashes=vocab_hashes, vocab_ids=vocab_ids, words=words)


def _sorted_lookup(keys: np.ndarray, key: int) -> int:
    """Index of ``key`` in the sorted u64 array, or -1."""
    i = int(np.searchsorted(keys, np.uint64(key)))
    if i < len(keys) and int(keys[i]) == key:
        return i
    return -1


class KenLMBinary(LanguageModel):
    """Word n-gram LM loaded from a KenLM ``.bin`` (probing format).

    Scores are log10 with Katz backoff, identical to KenLM queries: unknown
    words (in context or predicted) map to ``<unk>`` (id 0).
    """

    def __init__(self, path: str | Path):
        p = read_kenlm_binary(path)
        self._p = p
        self.order = p.order
        self.path = str(path)

    # -- id mapping --------------------------------------------------------
    def word_id(self, word: str) -> int:
        h = murmur64a(word.encode("utf-8"))
        if h in _UNK_HASHES:
            return 0
        i = _sorted_lookup(self._p.vocab_hashes, h)
        return int(self._p.vocab_ids[i]) if i >= 0 else 0

    @property
    def words(self) -> list[str]:
        """Vocabulary strings in id order (empty if not bundled)."""
        return self._p.words

    # -- scoring -----------------------------------------------------------
    def score_ids(self, context_ids: tuple[int, ...], word_id: int) -> float:
        """log10 P(word | context) over KenLM word ids with backoff."""
        p = self._p
        ctx = context_ids[-(p.order - 1):] if p.order > 1 else ()
        prob = float(p.uni_prob[word_id])
        matched = 1
        node = word_id
        # Extend the match one context word at a time (most recent first),
        # exactly KenLM's short-to-long lookup.
        for k, cid in enumerate(reversed(ctx)):
            n = k + 2  # current n-gram order being tried
            node = combine_word_hash(node, cid)
            if n < p.order:
                keys, probs, _ = p.middles[n - 2]
                i = _sorted_lookup(keys, node)
                if i < 0:
                    break
                prob, matched = float(probs[i]), n
            else:
                i = _sorted_lookup(p.longest[0], node)
                if i >= 0:
                    prob, matched = float(p.longest[1][i]), n
                break
        # Backoff weights of context grams longer than the match:
        # b(c_{n-1}) + b(c_{n-2} c_{n-1}) + ... for lengths >= matched.
        backoff = 0.0
        node = -1
        for k, cid in enumerate(reversed(ctx)):
            clen = k + 1
            if clen == 1:
                node = cid
                if clen >= matched:
                    backoff += float(p.uni_backoff[cid])
                continue
            node = combine_word_hash(node, cid)
            if clen >= matched and clen < p.order:
                keys, _, backoffs = p.middles[clen - 2]
                i = _sorted_lookup(keys, node)
                if i >= 0:
                    backoff += float(backoffs[i])
        return prob + backoff

    def score(self, context: tuple[str, ...], word: str) -> float:
        ctx_ids = tuple(self.word_id(w) for w in context)
        return self.score_ids(ctx_ids, self.word_id(word))


# ---------------------------------------------------------------------------
# Writer (ARPA tables -> KenLM probing binary)
# ---------------------------------------------------------------------------


def _probing_insert(keys: np.ndarray, entry_write, key: int) -> None:
    """Insert into a probing table: bucket = key % n, linear probe, wrap."""
    n = len(keys)
    i = key % n
    while int(keys[i]) != 0:
        i = (i + 1) % n
    keys[i] = key
    entry_write(i)


def write_kenlm_binary(
    ngrams: list[dict[tuple[str, ...], tuple[float, float]]],
    path: str | Path,
    *,
    probing_multiplier: float = 1.5,
    include_vocab: bool = True,
    unknown_missing_logprob: float = -100.0,
    model_type: int = MODEL_PROBING,
) -> None:
    """Serialize ARPA-style tables (``ArpaLM._ngrams`` layout: ``ngrams[k]``
    maps (k+1)-word tuples to (log10 prob, log10 backoff)) into a KenLM
    probing ``.bin``.  ``<s>``/``</s>``/``<unk>`` are ordinary entries.

    ``model_type=MODEL_REST_PROBING`` emits the 20-byte rest-weights entry
    stride (rest values zeroed — enough to validate readers of that layout;
    KenLM's lower-order rest costs are not modeled).
    """
    if model_type not in (MODEL_PROBING, MODEL_REST_PROBING):
        raise ValueError(f"unsupported model_type {model_type}")
    rest = model_type == MODEL_REST_PROBING
    order = len(ngrams)
    if order < 1 or not ngrams[0]:
        raise ValueError("need at least a populated unigram table")
    counts = [len(t) for t in ngrams]

    # --- vocab ids: <unk> -> 0, others sequential in table order ----------
    ids: dict[str, int] = {}
    id_words: list[str] = []
    saw_unk = False
    for (w,) in ngrams[0]:
        h = murmur64a(w.encode("utf-8"))
        if h in _UNK_HASHES:
            ids[w] = 0
            saw_unk = True
        else:
            ids[w] = 1 + len(id_words)
            id_words.append(w)
    bound = 1 + len(id_words)

    def wid(w: str) -> int:
        try:
            return ids[w]
        except KeyError:
            raise ValueError(f"n-gram word {w!r} missing from unigrams") from None

    # --- vocab probing table ----------------------------------------------
    vbuckets = _buckets(counts[0], probing_multiplier)
    vkeys = np.zeros(vbuckets, np.uint64)
    vvals = np.zeros(vbuckets, np.uint32)
    for w in id_words:
        h = murmur64a(w.encode("utf-8"))
        _probing_insert(vkeys, lambda i, w=w: vvals.__setitem__(i, ids[w]), h)

    # --- unigram array ------------------------------------------------------
    uni_dt = (np.dtype([("prob", "<f4"), ("backoff", "<f4"), ("rest", "<f4")])
              if rest else np.dtype([("prob", "<f4"), ("backoff", "<f4")]))
    uni = np.zeros(counts[0] + 1, uni_dt)
    uni["prob"][0] = unknown_missing_logprob
    for (w,), (prob, backoff) in ngrams[0].items():
        uni["prob"][wid(w)] = -abs(prob)   # sign bit = independent-left flag
        uni["backoff"][wid(w)] = backoff
    del saw_unk  # <unk> occupies id 0 either way; counts stay ARPA's

    # --- middle / longest tables -------------------------------------------
    mid_dt = (np.dtype([("key", "<u8"), ("prob", "<f4"), ("backoff", "<f4"),
                        ("rest", "<f4")])
              if rest else
              np.dtype([("key", "<u8"), ("prob", "<f4"), ("backoff", "<f4")]))
    long_dt = np.dtype([("key", "<u8"), ("prob", "<f4")])
    middles = []
    mid_index: list[dict[int, int]] = []  # key -> bucket, for activation
    for n in range(2, order):
        nb = _buckets(counts[n - 1], probing_multiplier)
        middles.append(np.zeros(nb, mid_dt))
        mid_index.append({})
    longest = np.zeros(_buckets(counts[order - 1], probing_multiplier),
                       long_dt) if order > 1 else np.zeros(0, long_dt)

    def gram_key(words: tuple[str, ...]) -> int:
        node = wid(words[-1])
        for w in reversed(words[:-1]):
            node = combine_word_hash(node, wid(w))
        return node

    def activate(context: tuple[str, ...]) -> None:
        """Clear the independent-left flag on the context's entry."""
        if len(context) == 1:
            i = wid(context[0])
            uni["prob"][i] = abs(uni["prob"][i])
            return
        table = middles[len(context) - 2]
        bucket = mid_index[len(context) - 2].get(gram_key(context))
        if bucket is not None:
            table["prob"][bucket] = abs(table["prob"][bucket])

    for n in range(2, order + 1):
        table = middles[n - 2] if n < order else longest
        index = mid_index[n - 2] if n < order else None
        for words, (prob, backoff) in ngrams[n - 1].items():
            if len(words) != n:
                raise ValueError(f"{words} in the {n}-gram table")
            key = gram_key(words)

            def put(i, prob=prob, backoff=backoff, key=key, n=n):
                table["prob"][i] = -abs(prob)
                if n < order:
                    table["backoff"][i] = backoff
                    index[key] = i  # type: ignore[index]

            _probing_insert(table["key"], put, key)
            activate(words[:-1])

    # --- assemble -----------------------------------------------------------
    out = bytearray()
    out += MAGIC.ljust(_MAGIC_PAD, b"\x00")
    out += struct.pack("<fff", 0.0, 1.0, -0.5)
    out += struct.pack("<II", 1, 0xFFFFFFFF)
    out += b"\x00" * 4
    out += struct.pack("<Q", 1)
    assert len(out) == _SANITY_SIZE
    out += struct.pack("<B3xfIB3xI", order, probing_multiplier,
                       model_type, 1 if include_vocab else 0, 0)
    out += struct.pack(f"<{order}Q", *counts)
    out += b"\x00" * (_align8(len(out)) - len(out))

    out += struct.pack("<Q", bound)
    vocab_dt = np.dtype([("key", "<u8"), ("value", "<u4")])
    vtab = np.zeros(vbuckets, vocab_dt)
    vtab["key"] = vkeys
    vtab["value"] = vvals
    out += vtab.tobytes()

    out += uni.tobytes()
    for table in middles:
        out += table.tobytes()
    if order > 1:
        out += longest.tobytes()

    if include_vocab:
        out += b"<unk>\x00"
        for w in id_words:
            out += w.encode("utf-8") + b"\x00"

    Path(path).write_bytes(bytes(out))
