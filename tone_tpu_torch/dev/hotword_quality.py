"""Quantify hotword biasing on a TRAINED model: entity recall vs false
alarms (port of ``dev/hotword_quality.py``).

Hotword biasing targets the reference's weakest WER category — named
entities (reference README.md:153).  This harness trains the tiny synthetic
Conformer (``examples/train_tiny_e2e``), picks an "entity" word from its
corpus, then decodes noise-corrupted eval audio with the host beam search
and the device search at hotword weights {0, 1, 2, 4, 8} and reports, per
noise level and weight:

* entity recall   — P(entity in hypothesis | entity in reference);
* false alarms    — P(entity in hypothesis | entity NOT in reference);
* overall WER.

The useful regime is where recall rises before false alarms do; the curve
shows the over-biasing cliff (a too-large weight hallucinates the entity —
same failure mode as pyctcdecode's hotword_weight).  Run:

    python -m tone_tpu_torch.dev.hotword_quality [--steps 150] [--weights 0 1 2 4 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tone_tpu_torch.dev.beam_quality_sweep import utterance_logprobs
from tone_tpu_torch.device import resolve_device

ENTITY = "дед"  # in-corpus word standing in for a client/product name


def entity_stats(refs: list[str], hyps: list[str], entity: str = ENTITY) -> dict:
    """Entity recall, false-alarm rate and WER of ``hyps``."""
    from tone_tpu_torch.training.wer import word_error_rate

    rec_n = rec_hit = fa_n = fa_hit = 0
    for ref, hyp in zip(refs, hyps):
        got = entity in hyp.split()
        if entity in ref.split():
            rec_n += 1
            rec_hit += got
        else:
            fa_n += 1
            fa_hit += got
    return {"recall": round(rec_hit / max(rec_n, 1), 3),
            "false_alarm": round(fa_hit / max(fa_n, 1), 3),
            "wer": round(word_error_rate(hyps, refs), 3)}


def hotword_sweep(cfg, variables, items: list[dict], weights=(0.0, 1.0, 2.0, 4.0, 8.0),
                  noises=(0.3, 0.45), copies: int = 6, device=None) -> list[dict]:
    """One row per (noise, weight): the host beam's and the device search's
    entity statistics (both width 32, no LM)."""
    from tone_tpu_torch.config import LABELS
    from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder
    from tone_tpu_torch.decoding.beam import ctc_beam_search
    from tone_tpu_torch.decoding.hotwords import HotwordScorer
    from tone_tpu_torch.examples.train_tiny_e2e import synth

    device = resolve_device(device)
    with_e = [it["text"] for it in items if ENTITY in it["text"].split()]
    without = [it["text"] for it in items if ENTITY not in it["text"].split()]
    texts = with_e + without
    rng = np.random.default_rng(0)

    results = []
    for noise in noises:
        cases = [(text, utterance_logprobs(variables, cfg, synth(text).astype(np.float32),
                                           noise, rng))
                 for _ in range(copies) for text in texts]
        refs = [text for text, _ in cases]
        for weight in weights:
            hw = HotwordScorer([ENTITY], weight) if weight else None
            host_hyps = [ctc_beam_search(lp.astype(np.float64), LABELS, None, beam_width=32,
                                         hotwords=hw) for _, lp in cases]
            dev_dec = DeviceBeamSearchCTCDecoder(
                beam_width=32, hotwords=[ENTITY] if weight else None,
                hotword_weight=weight or 10.0, device=device)
            dev_hyps = dev_dec.forward_batch([lp for _, lp in cases])
            row = {"noise": noise, "weight": weight, "host": entity_stats(refs, host_hyps),
                   "device": entity_stats(refs, dev_hyps)}
            results.append(row)
            print(json.dumps(row, ensure_ascii=False), flush=True)
    return results


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=150)
    parser.add_argument("--weights", type=float, nargs="+",
                        default=[0.0, 1.0, 2.0, 4.0, 8.0])
    parser.add_argument("--noises", type=float, nargs="+", default=[0.3, 0.45])
    parser.add_argument("--copies", type=int, default=6)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    from tone_tpu_torch.examples.train_tiny_e2e import run_training, trained_variables

    cfg, trainer, state, _, items = run_training(steps=args.steps, device=args.device)
    results = hotword_sweep(cfg, trained_variables(state), items, args.weights,
                            args.noises, args.copies, trainer.device)

    # Sanity: at some positive weight, recall must not fall below weight 0.
    by_noise: dict = {}
    for r in results:
        by_noise.setdefault(r["noise"], {})[r["weight"]] = r
    for noise, rows in by_noise.items():
        base = rows[min(rows)]["host"]["recall"]
        best = max(r["host"]["recall"] for r in rows.values())
        print(f"# noise {noise}: host recall {base} -> best {best}")


if __name__ == "__main__":
    main()
