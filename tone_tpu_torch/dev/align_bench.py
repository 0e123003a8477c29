"""Batched forced-alignment benchmark (port of ``dev/align_bench.py``):
device (``ops.align_device.align_words_batch``) against host
(``align.align_words``) throughput on realistic phrase shapes.

The serving engine aligns word times on the host decode pool; the batched
device path exists for bulk transcription (``transcribe --batch-size``,
``python -m tone_tpu_torch align``).  Reading the word tuples back waits for
the device, so the wall clock is sound here.  ``--kernel`` also times the
Viterbi recursion alone on staged device inputs, by the two-point slope
(chains of 5 and 25 calls, each ending in a read of the path).  Run:

    python -m tone_tpu_torch.dev.align_bench [--batch 64] [--frames 200] [--words 8] [--iters 20] [--kernel] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.profiling import device_label


def make_phrases(batch: int, frames: int, words: int, seed: int = 0):
    """Feasible (logprobs, text) pairs with realistic shapes: random
    acoustics (alignment cost doesn't depend on their values) and
    `words`-word texts drawn from a small lexicon."""
    from tone_tpu_torch.config import LABELS

    rng = np.random.default_rng(seed)
    lexicon = ["да", "нет", "алло", "привет", "дом", "мир", "дата", "центр",
               "сан", "заказ", "номер", "карта"]
    texts, lps = [], []
    for _ in range(batch):
        text = " ".join(rng.choice(lexicon) for _ in range(words))
        needed = 2 * len(text) + 1
        t = max(frames, needed + 8)
        logits = rng.normal(0.0, 2.0, (t, len(LABELS) + 1))
        lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))
              ).astype(np.float32)
        texts.append(text)
        lps.append(lp)
    return lps, texts


def kernel_seconds(lps, texts, device) -> float:
    """Seconds per call of ``_viterbi_path`` on the batch staged on
    ``device`` as one (T, S) bucket: the two-point slope over chains of 5
    and 25 calls."""
    from tone_tpu_torch.ops.align_device import (
        _bucket,
        _extended_labels,
        _stage_bucket,
        _viterbi_path,
    )

    exts = [_extended_labels(tx) for tx in texts]
    t_pad = _bucket(max(lp.shape[0] for lp in lps))
    s_pad = _bucket(max(e.size for e in exts))
    staged = [torch.from_numpy(a).to(device)
              for a in _stage_bucket(lps, exts, list(range(len(lps))), t_pad, s_pad)]

    def chain(n):
        t0 = time.perf_counter()
        path = None
        for _ in range(n):
            path, _score = _viterbi_path(*staged)
        float(path.sum())  # forced sync
        return time.perf_counter() - t0

    chain(3)
    n1, n2 = 5, 25
    t1 = min(chain(n1) for _ in range(2))
    t2 = min(chain(n2) for _ in range(2))
    return max((t2 - t1) / (n2 - n1), 1e-9)


def measure(batch: int = 64, frames: int = 200, words: int = 8, iters: int = 20,
            kernel: bool = False, device=None) -> dict:
    """The JAX script's report.  Raises AssertionError when the device and
    host aligners give different words or frames."""
    from tone_tpu_torch.align import align_words
    from tone_tpu_torch.ops.align_device import align_words_batch

    dev = resolve_device(device)
    lps, texts = make_phrases(batch, frames, words)
    audio_s = sum(lp.shape[0] for lp in lps) * 0.03

    # warmup: the first call at every (T, S) bucket this batch hits
    device_out = align_words_batch(lps, texts, device=dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        device_out = align_words_batch(lps, texts, device=dev)
    dt_dev = (time.perf_counter() - t0) / iters

    t0 = time.perf_counter()
    host_out = [align_words(lp, tx) for lp, tx in zip(lps, texts)]
    dt_host = time.perf_counter() - t0

    report = {}
    if kernel:
        dt_k = kernel_seconds(lps, texts, dev)
        report = {
            "kernel_ms_per_batch": round(dt_k * 1e3, 2),
            "kernel_phrases_per_s": round(batch / dt_k, 1),
            "kernel_audio_rtfx": round(audio_s / dt_k, 1),
        }

    device_words = [[w[:3] for w in p] for p in device_out]
    if device_words != [[w[:3] for w in p] for p in host_out]:
        raise AssertionError("device/host mismatch")
    return {
        "backend": dev.type,
        "batch": batch,
        "frames": frames,
        "words": words,
        "device_ms_per_batch": round(dt_dev * 1e3, 2),
        "device_phrases_per_s": round(batch / dt_dev, 1),
        "device_audio_rtfx": round(audio_s / dt_dev, 1),
        "host_ms_per_phrase": round(dt_host / batch * 1e3, 3),
        "host_audio_rtfx": round(audio_s / dt_host, 1),
        **report,
        **device_label(dev),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=200,
                    help="frames per phrase (200 = 6 s of audio)")
    ap.add_argument("--words", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernel", action="store_true",
                    help="also time the Viterbi recursion alone "
                         "(staged device inputs, two-point slope)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.batch, args.frames, args.words, args.iters, args.kernel,
                             args.device)))


if __name__ == "__main__":
    main()
