"""Domain adaptation, end to end and in-framework — no external tools (port
of ``examples/domain_adapt.py``).

The full loop a telephony deployment runs when a new domain (client, product
line) arrives:

  1. fine-tune the acoustic model on domain audio (here: the tiny synthetic
     corpus of ``train_tiny_e2e``);
  2. estimate a domain n-gram LM from the transcripts with the built-in
     modified-Kneser-Ney estimator and write a KenLM-format binary;
  3. decode with the device beam search with the LM fully fused, biased
     toward a domain entity word (hotwords);
  4. read word-level timestamps + confidences off the result.

    python -m tone_tpu_torch.examples.domain_adapt [--steps 150] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.examples.train_tiny_e2e import int_audio, synth

NOISE = 0.25        # σ of the Gaussian noise added to the eval audio
EVAL_ITEMS = 4


def domain_lm(items: list[dict], out_dir: Path):
    """Step 2: (n-gram tables, train perplexity, path of the KenLM binary)
    of an order-3 modified-KN LM over the items' transcripts."""
    from tone_tpu_torch.decoding.estimate import estimate_ngram_lm, perplexity
    from tone_tpu_torch.decoding.kenlm_binary import write_kenlm_binary
    from tone_tpu_torch.decoding.lm import ArpaLM

    sentences = [it["text"].split() for it in items]
    tables = estimate_ngram_lm(sentences, order=3)
    ppl = perplexity(ArpaLM(tables), sentences)
    lm_path = Path(out_dir) / "domain_lm.bin"
    write_kenlm_binary(tables, lm_path)
    return tables, ppl, lm_path


def domain_decoder(lm_path: Path, entity: str, device=None):
    """Step 3: the fused-LM device search, width 16, biased toward ``entity``."""
    from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder
    from tone_tpu_torch.decoding.device_lm import load_device_lm

    return DeviceBeamSearchCTCDecoder(
        load_device_lm(lm_path), fusion=True, beam_width=16,
        hotwords=[entity], hotword_weight=2.0, device=device)


def noisy_audios(items: list[dict]) -> tuple[list[np.ndarray], list[str]]:
    """The first items re-synthesized with noise of σ ``NOISE`` from
    ``np.random.default_rng(0)``, as int32 samples, and their texts."""
    rng = np.random.default_rng(0)
    audios, refs = [], []
    for it in items[:EVAL_ITEMS]:
        wav = synth(it["text"]).astype(np.float32)
        audios.append(int_audio(wav + rng.normal(0, NOISE, len(wav))))
        refs.append(it["text"])
    return audios, refs


def adapt(cfg, variables, items: list[dict], device=None) -> dict:
    """Steps 2–4 on trained ``variables``: the LM's gram counts and
    perplexity, the entity, the references, each utterance's phrases (with
    word times) and the number of exact matches."""
    device = resolve_device(device)
    from tone_tpu_torch.offline import OfflineTranscriber

    with tempfile.TemporaryDirectory(prefix="tone_domain_") as tmp:
        tables, ppl, lm_path = domain_lm(items, Path(tmp))
        print(f"== domain LM: {[len(t) for t in tables]} n-grams, "
              f"train ppl {ppl:.1f}, written to {lm_path}")
        entity = items[0]["text"].split()[0]
        decoder = domain_decoder(lm_path, entity, device)
    transcriber = OfflineTranscriber(variables, cfg, decoder=decoder,
                                     word_timestamps=True, device=device)
    audios, refs = noisy_audios(items)
    results = transcriber.transcribe(audios)
    correct = 0
    for ref, phrases in zip(refs, results):
        hyp = " ".join(p.text for p in phrases if p.text)
        correct += hyp == ref
        print(f"   ref: {ref}")
        print(f"   hyp: {hyp}")
        for p in phrases:
            for w in p.words or ():
                print(f"        [{w.start_time:5.2f}–{w.end_time:5.2f}] "
                      f"({w.confidence:.2f}) {w.word}")
    print(f"== {correct}/{len(refs)} exact matches "
          f"(fused domain LM + hotword '{entity}' + word times)")
    return {"grams": [len(t) for t in tables], "ppl": ppl, "entity": entity,
            "refs": refs, "audio_samples": [len(a) for a in audios],
            "results": results, "correct": correct}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=150)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    from tone_tpu_torch.examples.train_tiny_e2e import run_training, trained_variables

    # 1. fine-tune on the domain corpus ---------------------------------
    print(f"== training ({args.steps} steps on the synthetic domain corpus)")
    cfg, trainer, state, _, items = run_training(steps=args.steps, device=args.device)
    out = adapt(cfg, trained_variables(state), items, trainer.device)
    if out["correct"] == 0:
        raise SystemExit("domain adaptation produced no exact match")


if __name__ == "__main__":
    main()
