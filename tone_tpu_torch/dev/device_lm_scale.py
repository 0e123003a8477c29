"""Scale envelope of the device-resident LM (port of ``dev/device_lm_scale.py``).

A production Russian-telephony LM has tens of millions of grams.  This
script procedurally generates ``DeviceLM`` tables at increasing gram counts
(the vectorized twin of ``DeviceLM.from_ngrams`` — same chain hash, same
probe-table layout, realistic 300k-word vocab trie; the hash constants and
table functions are the port's own, ``decoding/device_lm.py``) and measures, per
size:

* host build time;
* the device bytes of the uploaded ``DeviceLMArrays`` (``memory_allocated``
  before and after the upload on the card; the tables' own bytes anywhere);
* steady-state fused-search throughput (``fused_beam_advance``, by a
  two-point slope: RTFx from the marginal cost of extra frames).

The tables take about 16 bytes per slot at a load of 0.25–0.5, so
``--grams 25e6`` needs several GB on the device and minutes of host build.

Run:  python -m tone_tpu_torch.dev.device_lm_scale [--grams 0.6e6 2.5e6 10e6 25e6] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tone_tpu_torch.device import resolve_device


def _chain_hash_cols(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized twin of device_lm._hash_ids over rows of an (N, K) id
    matrix (-1 columns = absent, must be trailing)."""
    from tone_tpu_torch.decoding.device_lm import _M1, _M2, _SEED1, _SEED2

    h1 = np.full(len(ids), _SEED1, np.uint32)
    h2 = np.full(len(ids), _SEED2, np.uint32)
    with np.errstate(over="ignore"):
        for k in range(ids.shape[1]):
            col = ids[:, k]
            live = col >= 0
            u = (col.astype(np.int64) + 1).astype(np.uint32)
            h1 = np.where(live, (h1 * _M1) ^ u, h1)
            h2 = np.where(live, h2 * _M2 + u, h2)
    return h1, h2


def _words(n_words: int) -> list[str]:
    """Distinct word strings: base-32-ish encodings of their id (6-8 chars)."""
    from tone_tpu_torch.config import LABELS

    chars = [c for c in LABELS if c != " "]
    words = []
    for i in range(n_words):
        w, x = [], i + n_words
        while x:
            w.append(chars[x % len(chars)])
            x //= len(chars)
        words.append("".join(w))
    return words


def synth_device_lm(n_grams: int, n_words: int = 300_000, order: int = 3,
                    seed: int = 0):
    """A DeviceLM with ``n_grams`` total entries over a realistic vocab.

    Unigrams cover the whole vocab; the rest split 60/40 between bigrams
    and trigrams of uniformly random word ids (deduplicated).  Payloads
    are plausible log10 probabilities.  The trie is built from real
    generated word strings, so the search-side trie walk is realistic.
    Returns (lm, entries, {"trie_s", "tables_s"}).
    """
    from tone_tpu_torch.decoding.device_lm import DeviceLM, _build_vocab_trie, _probe_table

    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    words = _words(n_words)
    edge_keys, edge_child, node_word, edge_probe = _build_vocab_trie(
        (w, i + 3) for i, w in enumerate(words))
    t_trie = time.monotonic() - t0

    t0 = time.monotonic()
    n_uni = n_words + 3  # + <s> </s> <unk>
    n_bi = max(0, int((n_grams - n_uni) * 0.6))
    n_tri = max(0, n_grams - n_uni - n_bi)
    parts = []
    uni = np.full((n_uni, order), -1, np.int64)
    uni[:, 0] = np.arange(n_uni)
    parts.append(uni)
    for n, count in ((2, n_bi), (3, n_tri)):
        ids = np.full((count, order), -1, np.int64)
        ids[:, :n] = rng.integers(0, n_uni, (count, n))
        parts.append(ids)
    ids = np.concatenate(parts)
    k1, k2 = _chain_hash_cols(ids)
    # dedupe on the 64-bit hash (collisions here = same gram, effectively)
    _, keep = np.unique(k1.astype(np.uint64) << np.uint64(32) | k2, return_index=True)
    k1, k2 = k1[keep], k2[keep]
    pr = rng.uniform(-6.0, -0.5, len(k1)).astype(np.float32)
    bo = rng.uniform(-1.5, 0.0, len(k1)).astype(np.float32)
    keys1, keys2, (probs, backoffs), probe = _probe_table(k1, k2, (pr, bo))
    t_tables = time.monotonic() - t0

    lm = DeviceLM(
        order=order, unk_id=0, bos_id=1, n_words=n_uni,
        words=["<unk>", "<s>", "</s>", *words],
        keys1=keys1, keys2=keys2, probs=probs, backoffs=backoffs,
        edge_keys=edge_keys, edge_child=edge_child, node_word=node_word,
        probe=probe, edge_probe=edge_probe)
    return lm, len(k1), {"trie_s": t_trie, "tables_s": t_tables}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def upload(lm, device: torch.device) -> tuple[object, dict]:
    """``lm.arrays(device)`` and its bytes: the tables' own, and on the card
    the growth of ``torch.cuda.memory_allocated`` across the upload."""
    before = torch.cuda.memory_allocated(device) if device.type == "cuda" else None
    t0 = time.monotonic()
    arrs = lm.arrays(device)
    _sync(device)
    upload_s = time.monotonic() - t0
    tensors = [v for v in vars(arrs).values() if isinstance(v, torch.Tensor)]
    out = {"table_bytes": sum(t.numel() * t.element_size() for t in tensors),
           "upload_s": upload_s,
           "device_bytes": (torch.cuda.memory_allocated(device) - before
                            if before is not None else None)}
    return arrs, out


def measure(lm, n_grams_actual: int, beam_width: int, batch: int, device=None) -> dict:
    """Device bytes of the tables and the fused search's cost per frame at
    ``batch`` streams and ``beam_width`` (``device``: cuda unless the caller
    asks for the CPU)."""
    from tone_tpu_torch.config import BLANK_ID, LABELS
    from tone_tpu_torch.ops.beam_decode import fused_beam_advance, init_fused_beam_state

    device = resolve_device(device)
    arrs, nbytes = upload(lm, device)
    v = len(LABELS) + 1
    rng = np.random.default_rng(1)

    def logprobs(t):
        x = rng.normal(0, 3.0, (batch, t, v)).astype(np.float32)
        x[..., BLANK_ID] += 2.0
        return x - np.log(np.exp(x).sum(-1, keepdims=True))

    t_short, t_long = 64, 256
    lp_short, lp_long = logprobs(t_short), logprobs(t_long)
    lens_s = np.full(batch, t_short)
    lens_l = np.full(batch, t_long)

    def run(lp, lens):
        st = init_fused_beam_state(batch, beam_width, lm, device=device)
        st = fused_beam_advance(st, lp, arrs, lens)
        _sync(device)
        return st

    run(lp_short, lens_s), run(lp_long, lens_l)  # warm both shapes
    reps = 3
    t0 = time.monotonic()
    for _ in range(reps):
        run(lp_short, lens_s)
    t_s = (time.monotonic() - t0) / reps
    t0 = time.monotonic()
    for _ in range(reps):
        run(lp_long, lens_l)
    t_l = (time.monotonic() - t0) / reps
    per_frame = (t_l - t_s) / (t_long - t_short)
    rtfx = (batch * 0.03) / per_frame  # 30 ms of audio per frame per stream
    return {"grams": n_grams_actual, "device": str(device), **nbytes,
            "per_frame_us": per_frame * 1e6,
            "rtfx_batch%d_w%d" % (batch, beam_width): rtfx}


def synth_probing_lm(n_grams: int, n_words: int = 100_000, seed: int = 0):
    """The published-artifact variant: write a PROBING ``kenlm.bin`` of
    ``n_grams`` entries through the first-party writer (the reference
    artifact's format, tone/decoder.py:84-95), then load it back through
    DeviceProbingLM — binary write + parse + re-bucketing + vocab-trie
    build, all at production scale."""
    from tone_tpu_torch.decoding.device_lm import DeviceProbingLM
    from tone_tpu_torch.decoding.kenlm_binary import write_kenlm_binary

    rng = np.random.default_rng(seed)
    words = _words(n_words)

    t0 = time.monotonic()
    uni = {("<unk>",): (-3.0, -0.5), ("<s>",): (-99.0, -0.4),
           ("</s>",): (-2.0, 0.0)}
    for w in words:
        uni[(w,)] = (round(float(rng.uniform(-6, -1)), 4), -0.3)
    n_bi = max(0, int((n_grams - len(uni)) * 0.6))
    n_tri = max(0, n_grams - len(uni) - n_bi)
    bi, tri = {}, {}
    for a, b in rng.integers(0, n_words, (n_bi, 2)):
        bi[(words[a], words[b])] = (-1.5, -0.2)
    for a, b, c in rng.integers(0, n_words, (n_tri, 3)):
        tri[(words[a], words[b], words[c])] = (-1.0, 0.0)
    t_tables = time.monotonic() - t0

    with tempfile.TemporaryDirectory(prefix="tone_lm_scale_") as tmp:
        path = Path(tmp) / "kenlm.bin"
        t0 = time.monotonic()
        write_kenlm_binary([uni, bi, tri], path)
        t_write = time.monotonic() - t0
        t0 = time.monotonic()
        lm = DeviceProbingLM.from_file(path)
        t_load = time.monotonic() - t0
        t0 = time.monotonic()
        DeviceProbingLM.from_file(path)  # second load rides the disk cache
        t_reload = time.monotonic() - t0
        bin_bytes = path.stat().st_size
    total = len(uni) + len(bi) + len(tri)
    return lm, total, {"synth_s": t_tables, "write_s": t_write, "load_s": t_load,
                       "cached_reload_s": t_reload, "bin_bytes": bin_bytes,
                       "probe": lm.probe}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--grams", type=float, nargs="+",
                        default=[6e5, 2.5e6, 1e7, 2.5e7])
    parser.add_argument("--beam-width", type=int, default=16)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--cpu", action="store_true", help="same as --device cpu")
    parser.add_argument("--probing", action="store_true",
                        help="go through a written probing kenlm.bin and "
                             "DeviceProbingLM (the published-artifact path) "
                             "instead of synthetic DeviceLM tables")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)

    for g in args.grams:
        if args.probing:
            lm, actual, build = synth_probing_lm(int(g))
        else:
            lm, actual, build = synth_device_lm(int(g))
        row = measure(lm, actual, args.beam_width, args.batch, device)
        row.update(build)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
