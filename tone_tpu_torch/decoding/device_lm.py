"""Word n-gram LM as device tensors, for shallow fusion in the device beam
search (port of ``tone_tpu/decoding/device_lm.py``).

The fused search (``ops/beam_decode.py``) probes the LM with gathers:

* all orders share ONE open-addressing hash table: each slot's row packs
  (key1, key2, log10 prob, log10 backoff) as four 32-bit words (floats
  bitcast), so one row gather serves both the key compare and the payload;
  bucket = the high bits of ``key1 * 0x9E3779B1`` (Fibonacci hashing),
  then a linear probe over a window of 8 to 64 slots;
* the vocabulary as a character trie: edge rows (node * n_chars + char,
  child, terminal word id of the child) in a second table of the same
  kind, so a beam walks the trie as it emits characters;
* Katz backoff (``decoding/lm.py ArpaLM.score``) as a statically unrolled
  walk from the longest context.

Built from the ``ngrams`` tables every host LM loader produces (ARPA text
or a KenLM trie binary).  Probing-format KenLM binaries store only hashed
gram keys: :class:`DeviceProbingLM` re-buckets the binary's OWN per-order
tables (keys salted by gram length) into the same layout, and the search
recomputes KenLM's 64-bit chain key from beam word ids.
:func:`load_device_lm` picks the right class for any LM artifact.

The numpy builders and host twins are copies of the JAX module's, and so
is the on-disk table cache (its layout, key and location are the JAX
package's, so a cache written by either package loads in the other).  The
device view (``arrays(device)``) is a frozen dataclass of torch tensors,
uploaded once per device and kept on the LM object; the tables stay int32
on the device (the 32-bit words of the JAX layout, bit for bit).
"""

from __future__ import annotations

import os
import zipfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from tone_tpu_torch.config import LABELS

# On-disk cache of the re-bucketed tables (building them from a large
# probing binary takes minutes), serialized beside the source artifact or
# under $XDG_CACHE_HOME, keyed by content digest + layout version.  Disable
# with TONE_TPU_LM_CACHE=0.
_CACHE_LAYOUT = 1


def _artifact_digest(path) -> str:
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 22)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _cache_enabled() -> bool:
    return os.environ.get("TONE_TPU_LM_CACHE", "1") != "0"


def _cache_candidates(path, digest: str, kind: str) -> list[Path]:
    p = Path(path)
    name = f"{p.name}.{kind}.v{_CACHE_LAYOUT}.{digest}.npz"
    cache_root = Path(os.environ.get("XDG_CACHE_HOME",
                                     Path.home() / ".cache"))
    return [p.parent / name, cache_root / "tone_tpu" / "device-lm" / name]


def _strip_meta(z) -> dict:
    return {k: v for k, v in z.items() if not k.startswith("__src_")}


def _cache_load(path, digest: str, kind: str) -> "dict | None":
    for cand in _cache_candidates(path, digest, kind):
        if cand.exists():
            try:
                with np.load(cand, allow_pickle=False) as z:
                    return _strip_meta(z)
            except (OSError, ValueError, zipfile.BadZipFile):
                continue  # corrupt/truncated cache: rebuild
    return None


def _cache_load_statmatch(path, kind: str) -> "dict | None":
    """Stat fast path: an existing cache entry for this artifact whose
    recorded (size, mtime_ns) matches the file skips the full-content
    digest.  Any stat difference falls back to the digest-keyed lookup, so
    correctness never rests on mtime."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    p = Path(path)
    pattern = f"{p.name}.{kind}.v{_CACHE_LAYOUT}.*.npz"
    cache_root = Path(os.environ.get("XDG_CACHE_HOME",
                                     Path.home() / ".cache"))
    for d in (p.parent, cache_root / "tone_tpu" / "device-lm"):
        try:
            cands = sorted(d.glob(pattern))
        except OSError:
            continue
        for cand in cands:
            try:
                with np.load(cand, allow_pickle=False) as z:
                    if ("__src_size__" in z.files
                            and int(z["__src_size__"]) == st.st_size
                            and int(z["__src_mtime_ns__"]) == st.st_mtime_ns):
                        return _strip_meta(z)
            except (OSError, ValueError, zipfile.BadZipFile):
                continue
    return None


def _cache_save(path, digest: str, kind: str, arrays: dict) -> None:
    p = Path(path)
    try:
        st = os.stat(path)
        arrays = dict(arrays, __src_size__=np.int64(st.st_size),
                      __src_mtime_ns__=np.int64(st.st_mtime_ns))
    except OSError:
        pass  # artifact gone mid-build: cache without the stat fast path
    targets = _cache_candidates(path, digest, kind)
    # Evict stale siblings first (older digests or layout versions of the
    # SAME artifact, in both candidate locations).
    for cand in targets:
        try:
            for old in cand.parent.glob(f"{p.name}.{kind}.v*.npz"):
                if old.name != cand.name:
                    old.unlink()
        except OSError:
            pass
    for cand in targets:
        try:
            cand.parent.mkdir(parents=True, exist_ok=True)
            tmp = cand.with_suffix(f".tmp{os.getpid()}")
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            tmp.replace(cand)  # atomic under concurrent builders
            return
        except OSError:
            continue  # read-only dir: fall through to the user cache
    import logging

    logging.getLogger(__name__).warning(
        "device-LM cache not written (no writable location for %s)", path)


@dataclass(frozen=True)
class DeviceLMArrays:
    """The device view of a :class:`DeviceLM`.

    ``table`` (S, 4) int32 rows: key1, key2, bits(log10 prob),
    bits(log10 backoff) — the uint32 words of the JAX layout, bit for bit;
    ``edges`` (SE, 3) int32 rows: node * n_chars + char, child, the child's
    terminal word id (-1: not a word).  ``oov_ctx_id`` is the context id of
    an out-of-vocabulary completed word: it hashes to nothing, as the host
    search keeps the literal unknown string in its context."""

    table: torch.Tensor
    edges: torch.Tensor
    unk_id: int
    oov_ctx_id: int       # == n_words
    probe: int = 8        # gram-table probe window
    edge_probe: int = 8   # trie-edge probe window


@dataclass(frozen=True)
class DeviceProbingLMArrays:
    """The device view of a :class:`DeviceProbingLM`: the gram rows hold
    the KenLM binary's own 64-bit chain keys, salted by gram length (row[0]
    = low 32 bits, the bucket source, row[1] = high 32 bits); unigrams live
    in dense by-word-id tensors.  KenLM maps an OOV context word to <unk>
    (id 0), so ``oov_ctx_id`` is 0."""

    table: torch.Tensor         # (S, 4) int32
    uni_prob: torch.Tensor      # (counts[0]+1,) float32, index = KenLM word id
    uni_backoff: torch.Tensor   # (counts[0]+1,) float32
    edges: torch.Tensor         # vocab trie, as in DeviceLMArrays
    unk_id: int = 0
    oov_ctx_id: int = 0
    probe: int = 8
    edge_probe: int = 8


_M1 = np.uint32(1000003)
_M2 = np.uint32(2654435761)
_SEED1 = np.uint32(0x811C9DC5)
_SEED2 = np.uint32(0x85EBCA6B)
PROBE = 8             # linear-probe window (one contiguous gather)
_SENTINEL = np.uint32(0xFFFFFFFF)
_FIB = np.uint32(0x9E3779B1)


def _bucket(k1, size: int):
    """Fibonacci hashing: the chain hash's low bits carry structure (short
    chains differ mostly in high bits), so buckets come from the HIGH bits
    of a multiply."""
    shift = 32 - int(size).bit_length() + 1
    with np.errstate(over="ignore"):
        return (k1 * _FIB) >> np.uint32(shift)


_MAX_PROBE = 64
_MIN_LOAD = 0.25  # below this, spills widen the probe instead of doubling


def _probe_table(k1, k2, payloads, min_size: int = 64):
    """Open-addressing table: place each entry at the first free slot in
    its probe window (vectorized round per probe distance: first entry per
    slot wins, the rest retry at the next distance).  On spill past the
    window: double the table while load > ``_MIN_LOAD``, then widen the
    probe (8 → 16 → 32 → 64).  Returns (keys1, keys2, payloads, probe)."""
    n = len(k1)
    if n and bool(np.any((k1 == _SENTINEL) & (k2 == _SENTINEL))):
        raise ValueError("hash equals the empty-slot sentinel "
                         "(astronomically unlikely); rebuild the LM")
    size = max(min_size, 1 << int(np.ceil(np.log2(max(n, 1) * 2))))
    probe = PROBE
    while True:
        tk1 = np.full(size, _SENTINEL, np.uint32)
        tk2 = np.full(size, _SENTINEL, np.uint32)
        tp = [np.zeros(size, p.dtype) for p in payloads]
        occupied = np.zeros(size, bool)
        base = _bucket(k1, size).astype(np.int64)
        remaining = np.arange(n)
        for d in range(probe):
            if not len(remaining):
                break
            slots = (base[remaining] + d) & (size - 1)
            free = ~occupied[slots]
            cand, cslots = remaining[free], slots[free]
            order = np.argsort(cslots, kind="stable")
            cs, ci = cslots[order], cand[order]
            first = np.ones(len(cs), bool)
            first[1:] = cs[1:] != cs[:-1]
            ps, pi = cs[first], ci[first]
            tk1[ps], tk2[ps] = k1[pi], k2[pi]
            for t, p in zip(tp, payloads):
                t[ps] = p[pi]
            occupied[ps] = True
            placed = np.zeros(n, bool)
            placed[pi] = True
            remaining = remaining[~placed[remaining]]
        if not len(remaining):
            return tk1, tk2, tp, probe
        if n / size > _MIN_LOAD or probe >= _MAX_PROBE:
            size *= 2
        else:
            probe *= 2


_M1_INT, _M2_INT = int(_M1), int(_M2)
_U32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1


def _order_salt(n: int) -> int:
    """Per-gram-length 64-bit salt, XORed onto KenLM chain keys so grams of
    every order share one open-addressing table without structural
    cross-order collisions (shared by the host table build and the probe in
    ops/beam_decode.py)."""
    from tone_tpu_torch.decoding.kenlm_binary import murmur64a

    return murmur64a(b"tone-device-lm-order", seed=n)


def _salt_split(keys: "np.ndarray", n: int) -> tuple["np.ndarray", "np.ndarray"]:
    """Salt u64 KenLM keys by gram length and split into (low, high) u32."""
    salted = keys.astype(np.uint64) ^ np.uint64(_order_salt(n))
    return ((salted & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (salted >> np.uint64(32)).astype(np.uint32))


def _build_vocab_trie(pairs) -> tuple["np.ndarray", "np.ndarray", "np.ndarray", int]:
    """Character trie over the decoder's label set: ``pairs`` is an
    iterable of (word, id).  Words with characters outside LABELS are
    skipped (the decoder can never emit them).  Returns the probe-table
    edge arrays + terminal word id per node + the edge probe width."""
    n_chars = len(LABELS)
    children: list[dict[int, int]] = [{}]
    node_word = [-1]
    for w, word_id in pairs:
        node = 0
        ok = True
        for ch in w:
            c = LABELS.find(ch)
            if c < 0:
                ok = False  # word not producible by the decoder
                break
            nxt = children[node].get(c)
            if nxt is None:
                nxt = len(children)
                children[node][c] = nxt
                children.append({})
                node_word.append(-1)
            node = nxt
        if ok:
            node_word[node] = word_id
    edges = [(node * n_chars + c, child)
             for node, kids in enumerate(children)
             for c, child in kids.items()]
    ek = np.array([k for k, _ in edges] or [0], np.uint32)
    ec = np.array([c for _, c in edges] or [-1], np.int32)
    if edges and int(ek.max()) >= int(_SENTINEL):
        raise ValueError("vocab trie too large for u32 edge keys")
    edge_keys, _, (edge_child,), edge_probe = _probe_table(ek, ek, (ec,))
    return edge_keys, edge_child, np.asarray(node_word, np.int32), edge_probe


def _pack_rows(*cols: "np.ndarray") -> "np.ndarray":
    """Interleave same-length u32/i32/f32 columns into (S, n) u32 rows
    (floats/ints bitcast) — the array-of-structs layout that lets one row
    gather serve both key comparison and payload read."""
    return np.stack([np.ascontiguousarray(c).view(np.uint32) for c in cols],
                    axis=1)


def _pack_edges(edge_keys, edge_child, node_word) -> "np.ndarray":
    """Edge rows (key, child, node_word[child]): the child's terminal word
    id rides in the edge so a trie step resolves node AND word in one row
    gather (empty slots hold child 0 — their word column is never read,
    the key can't match)."""
    child_word = node_word[np.clip(edge_child, 0, len(node_word) - 1)]
    return _pack_rows(edge_keys, edge_child, child_word)


def _to_device_rows(rows: "np.ndarray", device) -> torch.Tensor:
    """(S, n) uint32 rows as an int32 tensor on ``device`` (a bitcast)."""
    return torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)).to(device)


def _hash_ids(ids: "list[int] | np.ndarray") -> tuple[np.uint32, np.uint32]:
    """Chain hash of a word-id sequence (twin of the device version; plain
    Python ints — numpy scalar ops are ~20x slower per call)."""
    h1, h2 = 0x811C9DC5, 0x85EBCA6B
    for i in ids:
        u = (int(i) + 1) & _U32
        h1 = ((h1 * _M1_INT) & _U32) ^ u
        h2 = ((h2 * _M2_INT) + u) & _U32
    return np.uint32(h1), np.uint32(h2)


class _DeviceViews:
    """``arrays(device)``: the device view, uploaded once per device and
    kept on the LM object, so every decoder sharing the LM (an engine's
    per-stream override, say) shares one upload."""

    def arrays(self, device="cpu"):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        views = self.__dict__.setdefault("_device_arrays", {})
        view = views.get(device)
        if view is None:
            view = views[device] = self._make_arrays(device)
        return view


@dataclass
class DeviceLM(_DeviceViews):
    """Flat-array n-gram LM + vocab trie (host container; ``arrays(device)``
    is the view the fused search reads)."""

    order: int
    unk_id: int
    bos_id: int
    n_words: int
    words: list[str]
    # one combined table over ALL orders (see DeviceLMArrays)
    keys1: np.ndarray     # (N,) u32
    keys2: np.ndarray     # (N,) u32
    probs: np.ndarray     # (N,) f32  log10
    backoffs: np.ndarray  # (N,) f32  log10
    # vocab trie: edges keyed by node * n_chars + char
    edge_keys: np.ndarray       # (E,) u32
    edge_child: np.ndarray      # (E,) i32
    node_word: np.ndarray       # (nodes,) i32  terminal word id or -1
    probe: int = PROBE          # gram-table probe window (static per LM)
    edge_probe: int = PROBE     # trie-edge probe window

    @classmethod
    def from_ngrams(cls, ngrams) -> "DeviceLM":
        """``ngrams[k]``: dict mapping (k+1)-word tuples -> (log10 prob,
        log10 backoff) — the shared table format of tone_tpu_torch.decoding."""
        words = sorted({w for (w,) in ngrams[0]})
        wid = {w: i for i, w in enumerate(words)}
        if "<unk>" not in wid:
            raise ValueError("device LM requires an <unk> unigram")
        order = len(ngrams)

        total = sum(len(t) for t in ngrams)
        k1 = np.empty(total, np.uint32)
        k2 = np.empty(total, np.uint32)
        pr = np.empty(total, np.float32)
        bo = np.empty(total, np.float32)
        i = 0
        for table in ngrams:
            for gram, entry in table.items():
                ids = [wid.get(w, wid["<unk>"]) for w in gram]
                k1[i], k2[i] = _hash_ids(ids)
                pr[i] = entry[0]
                bo[i] = entry[1] if len(entry) > 1 else 0.0
                i += 1
        keys1, keys2, (probs, backoffs), probe = _probe_table(k1, k2, (pr, bo))

        edge_keys, edge_child, node_word, edge_probe = _build_vocab_trie(
            (w, wid[w]) for w in words if w not in ("<s>", "</s>", "<unk>"))

        return cls(
            order=order, unk_id=wid["<unk>"],
            bos_id=wid.get("<s>", wid["<unk>"]), n_words=len(words),
            words=words, keys1=keys1, keys2=keys2, probs=probs,
            backoffs=backoffs, edge_keys=edge_keys, edge_child=edge_child,
            node_word=node_word, probe=probe, edge_probe=edge_probe)

    @classmethod
    def from_file(cls, path, cache: bool | None = None) -> "DeviceLM":
        """Build from an enumerable LM artifact: ARPA text (optionally .gz)
        or a KenLM trie-family binary, through load_lm's format dispatch.
        Probing binaries fuse through :class:`DeviceProbingLM`
        (:func:`load_device_lm` dispatches on the artifact).

        The built tables are cached on disk (see the module docs);
        ``cache=False`` (or env ``TONE_TPU_LM_CACHE=0``) forces a rebuild."""
        if cache is None:
            cache = _cache_enabled()
        digest = ""
        if cache:
            z = _cache_load_statmatch(path, "device-lm")
            if z is None:
                digest = _artifact_digest(path)
                z = _cache_load(path, digest, "device-lm")
            if z is not None:
                return cls(
                    order=int(z["order"]), unk_id=int(z["unk_id"]),
                    bos_id=int(z["bos_id"]), n_words=int(z["n_words"]),
                    words=z["words"].tolist(),
                    keys1=z["keys1"], keys2=z["keys2"],
                    probs=z["probs"], backoffs=z["backoffs"],
                    edge_keys=z["edge_keys"], edge_child=z["edge_child"],
                    node_word=z["node_word"],
                    probe=int(z["probe"]), edge_probe=int(z["edge_probe"]))
        from tone_tpu_torch.decoding.lm import ArpaLM, load_lm

        lm = load_lm(path)
        if isinstance(lm, ArpaLM):
            built = cls.from_ngrams(lm._ngrams)
        else:
            from tone_tpu_torch.decoding.kenlm_trie import KenLMTrie, trie_to_ngrams

            if not isinstance(lm, KenLMTrie):
                raise ValueError(
                    f"{path}: probing-format KenLM binaries cannot be "
                    "enumerated into DeviceLM tables; load through "
                    "load_device_lm (which probes the binary's own hash "
                    "tables via DeviceProbingLM)")
            built = cls.from_ngrams(trie_to_ngrams(lm))
        if cache:
            if not digest:
                digest = _artifact_digest(path)
            _cache_save(path, digest, "device-lm", dict(
                order=built.order, unk_id=built.unk_id, bos_id=built.bos_id,
                n_words=built.n_words, words=np.asarray(built.words),
                keys1=built.keys1, keys2=built.keys2, probs=built.probs,
                backoffs=built.backoffs, edge_keys=built.edge_keys,
                edge_child=built.edge_child, node_word=built.node_word,
                probe=built.probe, edge_probe=built.edge_probe))
        return built

    def _make_arrays(self, device) -> DeviceLMArrays:
        return DeviceLMArrays(
            table=_to_device_rows(_pack_rows(self.keys1, self.keys2,
                                             self.probs, self.backoffs), device),
            edges=_to_device_rows(_pack_edges(self.edge_keys, self.edge_child,
                                              self.node_word), device),
            unk_id=int(self.unk_id), oov_ctx_id=int(self.n_words),
            probe=self.probe, edge_probe=self.edge_probe)

    # -- host twins (for tests and trailing-word scoring) -------------------

    def _lookup_host(self, ids) -> tuple[bool, float, float]:
        k1, k2 = _hash_ids(ids)
        size = len(self.keys1)
        base = int(_bucket(k1, size))
        for d in range(self.probe):
            j = (base + d) & (size - 1)
            if self.keys1[j] == k1 and self.keys2[j] == k2:
                return True, float(self.probs[j]), float(self.backoffs[j])
        return False, 0.0, 0.0

    def score_ids(self, context_ids, word_id: int) -> float:
        """log10 P(word | context) with Katz backoff — id-level twin of
        ArpaLM.score (decoding/lm.py)."""
        context_ids = list(context_ids)[-(self.order - 1):]
        backoff_sum = 0.0
        for start in range(len(context_ids) + 1):
            ctx = context_ids[start:]
            if len(ctx) + 1 <= self.order:
                found, prob, _ = self._lookup_host([*ctx, word_id])
                if found:
                    return prob + backoff_sum
            if ctx:
                cfound, _, cb = self._lookup_host(ctx)
                if cfound:
                    backoff_sum += cb
        found, prob, _ = self._lookup_host([word_id])
        return prob + backoff_sum  # <unk> is guaranteed present

    def word_id(self, word: str) -> int:
        import bisect

        i = bisect.bisect_left(self.words, word)
        if i < len(self.words) and self.words[i] == word:
            return i
        return self.unk_id

    def ctx_id(self, word: str) -> int:
        """Context id of a word: its vocab id, or the OOV sentinel (which
        misses every table probe — matching ArpaLM, which keeps the
        literal unknown string in context rather than substituting <unk>)."""
        import bisect

        i = bisect.bisect_left(self.words, word)
        if i < len(self.words) and self.words[i] == word:
            return i
        return self.n_words

    def score(self, context, word: str) -> float:
        """String-level scorer (LanguageModel-compatible), host-side."""
        return self.score_ids([self.ctx_id(w) for w in context],
                              self.word_id(word))

    def begin_context(self) -> tuple[str, ...]:
        return ("<s>",)


@dataclass
class DeviceProbingLM(_DeviceViews):
    """Device fusion for KenLM probing binaries — the published
    ``kenlm.bin`` format (KenLM ``build_binary``'s default ModelType).

    Re-buckets the binary's OWN per-order hash tables (parsed by
    decoding/kenlm_binary.py) into one salted open-addressing table; the
    search recomputes KenLM's 64-bit chain key (``combine_word_hash``) from
    beam word ids (ops/beam_decode.py ``_combine64``/``_lm_score_probing``).
    The vocab trie comes from the binary's bundled word strings.

    Scoring semantics (and the host twins used by fused_beam_nbest) are
    exactly :class:`~tone_tpu_torch.decoding.kenlm_binary.KenLMBinary`: OOV
    words map to ``<unk>`` (id 0) both as prediction and in context.
    """

    order: int
    unk_id: int          # always 0 in KenLM binaries
    bos_id: int
    binary: "object"     # KenLMBinary host twin
    keys1: np.ndarray    # combined salted gram table (orders 2..N)
    keys2: np.ndarray
    probs: np.ndarray
    backoffs: np.ndarray
    uni_prob: np.ndarray     # dense by word id (the binary's unigram array)
    uni_backoff: np.ndarray
    edge_keys: np.ndarray    # vocab trie (shared search machinery)
    edge_child: np.ndarray
    node_word: np.ndarray
    probe: int = PROBE       # gram-table probe window (static per LM)
    edge_probe: int = PROBE  # trie-edge probe window

    @classmethod
    def from_file(cls, path, cache: bool | None = None) -> "DeviceProbingLM":
        """Tables are disk-cached like :meth:`DeviceLM.from_file`; the
        ``KenLMBinary`` host twin (a straight parse of the file) is
        reconstructed on every load."""
        from tone_tpu_torch.decoding.kenlm_binary import KenLMBinary

        binary = KenLMBinary(path)
        p = binary._p
        if not p.words:
            raise ValueError(
                f"{path}: probing binary has no bundled vocabulary strings "
                "(build_binary was run on vocab-less input); device fusion "
                "needs them to map decoded words to ids — use host fusion "
                "or n-best rescoring instead")
        if cache is None:
            cache = _cache_enabled()
        digest = ""
        if cache:
            z = _cache_load_statmatch(path, "device-probing-lm")
            if z is None:
                digest = _artifact_digest(path)
                z = _cache_load(path, digest, "device-probing-lm")
            if z is not None:
                return cls(
                    order=p.order, unk_id=0, bos_id=binary.word_id("<s>"),
                    binary=binary,
                    keys1=z["keys1"], keys2=z["keys2"],
                    probs=z["probs"], backoffs=z["backoffs"],
                    uni_prob=np.ascontiguousarray(p.uni_prob, np.float32),
                    uni_backoff=np.ascontiguousarray(p.uni_backoff,
                                                     np.float32),
                    edge_keys=z["edge_keys"], edge_child=z["edge_child"],
                    node_word=z["node_word"],
                    probe=int(z["probe"]), edge_probe=int(z["edge_probe"]))

        k1s, k2s, prs, bos = [], [], [], []
        for n, (keys, probs_n, backoffs_n) in enumerate(p.middles, start=2):
            a, b = _salt_split(keys, n)
            k1s.append(a)
            k2s.append(b)
            prs.append(probs_n)
            bos.append(backoffs_n)
        if p.order > 1:
            a, b = _salt_split(p.longest[0], p.order)
            k1s.append(a)
            k2s.append(b)
            prs.append(p.longest[1])
            bos.append(np.zeros(len(p.longest[1]), np.float32))

        def cat(xs, dt):
            return np.concatenate(xs) if xs else np.zeros(0, dt)

        keys1, keys2, (probs, backoffs), probe = _probe_table(
            cat(k1s, np.uint32), cat(k2s, np.uint32),
            (cat(prs, np.float32), cat(bos, np.float32)))

        # words[i] is the string for id i (id 0 = <unk>)
        edge_keys, edge_child, node_word, edge_probe = _build_vocab_trie(
            (w, i) for i, w in enumerate(p.words)
            if w not in ("<s>", "</s>", "<unk>"))

        if cache:
            if not digest:
                digest = _artifact_digest(path)
            _cache_save(path, digest, "device-probing-lm", dict(
                keys1=keys1, keys2=keys2, probs=probs, backoffs=backoffs,
                edge_keys=edge_keys, edge_child=edge_child,
                node_word=node_word, probe=probe, edge_probe=edge_probe))
        return cls(
            order=p.order, unk_id=0, bos_id=binary.word_id("<s>"),
            binary=binary, keys1=keys1, keys2=keys2, probs=probs,
            backoffs=backoffs,
            uni_prob=np.ascontiguousarray(p.uni_prob, np.float32),
            uni_backoff=np.ascontiguousarray(p.uni_backoff, np.float32),
            edge_keys=edge_keys, edge_child=edge_child,
            node_word=node_word, probe=probe, edge_probe=edge_probe)

    def _make_arrays(self, device) -> DeviceProbingLMArrays:
        return DeviceProbingLMArrays(
            table=_to_device_rows(_pack_rows(self.keys1, self.keys2,
                                             self.probs, self.backoffs), device),
            uni_prob=torch.from_numpy(self.uni_prob.copy()).to(device),
            uni_backoff=torch.from_numpy(self.uni_backoff.copy()).to(device),
            edges=_to_device_rows(_pack_edges(self.edge_keys, self.edge_child,
                                              self.node_word), device),
            probe=self.probe, edge_probe=self.edge_probe)

    # -- host twins (KenLMBinary semantics) ---------------------------------

    def word_id(self, word: str) -> int:
        return self.binary.word_id(word)

    def ctx_id(self, word: str) -> int:
        return self.binary.word_id(word)

    def score_ids(self, context_ids, word_id: int) -> float:
        return self.binary.score_ids(tuple(context_ids), word_id)

    def score(self, context, word: str) -> float:
        return self.binary.score(tuple(context), word)

    def begin_context(self) -> tuple[str, ...]:
        return ("<s>",)


def load_device_lm(path) -> "DeviceLM | DeviceProbingLM":
    """Device-fusable LM from any supported artifact: ARPA text
    (optionally .gz) or any of the six KenLM binary formats — enumerable
    formats build :class:`DeviceLM` tables, probing formats probe the
    binary's own tables via :class:`DeviceProbingLM`."""
    from tone_tpu_torch.decoding.kenlm_binary import (
        MODEL_PROBING, MODEL_REST_PROBING, kenlm_model_type)

    if kenlm_model_type(path) in (MODEL_PROBING, MODEL_REST_PROBING):
        return DeviceProbingLM.from_file(path)
    return DeviceLM.from_file(path)
