"""Quantify the device-beam quality gap on a TRAINED model (port of
``dev/beam_quality_sweep.py``).

The device search defaults to width 32 with 8-hypothesis rescoring, against
the reference's width-200 full fusion (tone/decoder.py:133).  This harness
trains the tiny synthetic Conformer (``examples/train_tiny_e2e``), builds a
bigram word LM over its corpus, then decodes noise-corrupted eval audio
with:

* host prefix beam search, width 200, full LM fusion (the reference
  configuration — the gold standard);
* the device search at widths 16/32/64, in both LM modes (host n-best
  rescoring and full device fusion);

and reports WER vs ground truth plus transcript agreement with the
host-200 decode at each noise level.  Run:

    python -m tone_tpu_torch.dev.beam_quality_sweep [--steps 150] [--widths 16 32 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
from collections import Counter

import numpy as np
import torch

from tone_tpu_torch.bridge import tree_leaves
from tone_tpu_torch.device import resolve_device

HOST = "host_w200_fusion"


def corpus_lm(order: int = 2):
    """Bigram LM over the synthetic training corpus' word distribution."""
    from tone_tpu_torch.examples.train_tiny_e2e import make_dataset

    sents = [it["text"].split() for it in make_dataset()]
    counters = [Counter() for _ in range(order)]
    for s in sents:
        toks = ["<s>"] + s + ["</s>"]
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                counters[n - 1][tuple(toks[i:i + n])] += 1
    counters[0][("<unk>",)] += 1
    ngrams = []
    for n, counter in enumerate(counters, start=1):
        tot = sum(counter.values())
        ngrams.append({g: (round(math.log10(c / tot), 4),
                           0.0 if n == order else -0.35)
                       for g, c in counter.items()})
    return ngrams


@torch.no_grad()
def utterance_logprobs(model, cfg, audio_f32: np.ndarray, noise: float,
                       rng: np.random.Generator) -> np.ndarray:
    """Offline logprobs for one noisy utterance via the streaming model
    (``model``: the variables, on the device the step runs on)."""
    from tone_tpu_torch.core.model import apply_streaming, init_streaming_state

    device = tree_leaves(model)[0].device
    noisy = audio_f32 + rng.normal(0, noise, len(audio_f32))
    audio = np.clip(noisy * 32767, -32768, 32767).astype(np.int32)
    audio = np.pad(audio, (2400, 2400))
    audio = np.pad(audio, (0, -len(audio) % 2400))
    chunks = torch.from_numpy(audio.reshape(-1, 2400)).to(device)
    state = init_streaming_state(cfg, 1, device=device)
    out = []
    for chunk in chunks:
        lp, state = apply_streaming(model, cfg, chunk[None], state)
        out.append(lp[0])
    return torch.cat(out).float().cpu().numpy()


def make_decoders(ngrams, widths, device) -> dict:
    """The host width-200 fusion decoder, then the device search at each
    width with n-best rescoring and with the LM fused."""
    from tone_tpu_torch.decoder import BeamSearchCTCDecoder, DeviceBeamSearchCTCDecoder
    from tone_tpu_torch.decoding.device_lm import DeviceLM
    from tone_tpu_torch.decoding.lm import ArpaLM

    arpa = ArpaLM(ngrams)
    dev_lm = DeviceLM.from_ngrams(ngrams)
    decoders = {HOST: BeamSearchCTCDecoder(arpa, beam_width=200)}
    for w in widths:
        decoders[f"device_w{w}_rescore"] = DeviceBeamSearchCTCDecoder(
            arpa, beam_width=w, nbest=8, device=device)
        decoders[f"device_w{w}_fusion"] = DeviceBeamSearchCTCDecoder(
            dev_lm, beam_width=w, fusion=True, device=device)
    return decoders


def blended_items(items: list[dict]) -> list[dict]:
    """Acoustically ambiguous eval: two utterances' audio mixed, so that the
    AM is torn between transcripts and the LM/beam must arbitrate — without
    this, the tiny task is so separable that every width makes identical
    decisions and the sweep can't discriminate."""
    from tone_tpu_torch.examples.train_tiny_e2e import synth

    blended = []
    texts = sorted({it["text"] for it in items})
    for i, ta in enumerate(texts):
        for tb in texts[i + 1:]:
            a, b = synth(ta), synth(tb)
            n = min(len(a), len(b))
            for mix in (0.4, 0.5, 0.6):
                blended.append({"audio": mix * a[:n] + (1 - mix) * b[:n],
                                "text": ta if mix >= 0.5 else tb})
    return blended


def decode_all(decoders: dict, logprobs: list[np.ndarray]) -> dict[str, list[str]]:
    """Every decoder's texts: the device decoders in one batch, the host
    decoder one utterance at a time."""
    return {name: dec.forward_batch(logprobs) if hasattr(dec, "forward_batch")
            else [dec.forward(lp) for lp in logprobs] for name, dec in decoders.items()}


def sweep(cfg, variables, widths=(16, 32, 64), noises=(0.15, 0.3, 0.45), repeats: int = 4,
          blend: bool = False, device=None) -> list[dict]:
    """One row per (noise, decoder): WER, agreement with the host width-200
    decode and the number of utterances."""
    from tone_tpu_torch.examples.train_tiny_e2e import make_dataset
    from tone_tpu_torch.training.wer import word_error_rate

    device = resolve_device(device)
    decoders = make_decoders(corpus_lm(), widths, device)
    items = make_dataset()
    if blend:
        items = blended_items(items)
    rng = np.random.default_rng(7)
    rows = []
    for noise in noises:
        evals = [(utterance_logprobs(variables, cfg, it["audio"], noise, rng), it["text"])
                 for _ in range(repeats) for it in items]
        refs = [ref for _, ref in evals]
        hyps = decode_all(decoders, [lp for lp, _ in evals])
        gold = hyps[HOST]
        for name in decoders:
            agree = float(np.mean([h == g for h, g in zip(hyps[name], gold)]))
            rows.append({"noise": noise, "decoder": name,
                         "wer": round(word_error_rate(hyps[name], refs), 4),
                         "agree_vs_host200": round(agree, 4), "n": len(refs)})
            print(json.dumps(rows[-1], ensure_ascii=False), flush=True)
    return rows


def host_agreement(cfg, variables, noise: float = 0.3, seed: int = 3,
                   device=None) -> tuple[float, list[str], list[str]]:
    """The quality pin of tests/test_e2e_synthetic.py: the device search at
    its default width (32, n-best 8 rescored with the corpus LM) against
    the host width-200 fusion on the corpus at ``noise``; returns the share
    of equal texts and both decoders' texts."""
    from tone_tpu_torch.decoder import BeamSearchCTCDecoder, DeviceBeamSearchCTCDecoder
    from tone_tpu_torch.decoding.lm import ArpaLM
    from tone_tpu_torch.examples.train_tiny_e2e import make_dataset

    device = resolve_device(device)
    arpa = ArpaLM(corpus_lm())
    host = BeamSearchCTCDecoder(arpa, beam_width=200)
    dev = DeviceBeamSearchCTCDecoder(arpa, beam_width=32, nbest=8, device=device)
    rng = np.random.default_rng(seed)
    evals = [utterance_logprobs(variables, cfg, it["audio"], noise, rng)
             for it in make_dataset()]
    dev_out = dev.forward_batch(evals)
    host_out = [host.forward(lp) for lp in evals]
    agree = float(np.mean([d == h for d, h in zip(dev_out, host_out)]))
    return agree, dev_out, host_out


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=150)
    parser.add_argument("--widths", type=int, nargs="+", default=[16, 32, 64])
    parser.add_argument("--noises", type=float, nargs="+",
                        default=[0.15, 0.3, 0.45])
    parser.add_argument("--repeats", type=int, default=4,
                        help="noisy copies of each eval utterance")
    parser.add_argument("--blend", action="store_true",
                        help="evaluate on blends of two utterances "
                             "(acoustically ambiguous — beams must compete)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    from tone_tpu_torch.examples.train_tiny_e2e import run_training, trained_variables

    cfg, trainer, state, _, _ = run_training(steps=args.steps, device=args.device)
    rows = sweep(cfg, trained_variables(state), args.widths, args.noises, args.repeats,
                 args.blend, trainer.device)

    print("\n== summary (WER delta vs host_w200_fusion) ==")
    for noise in args.noises:
        base = next(r["wer"] for r in rows if r["noise"] == noise and r["decoder"] == HOST)
        for r in rows:
            if r["noise"] == noise:
                print(f"noise={noise} {r['decoder']:24s} wer={r['wer']:.4f} "
                      f"delta={r['wer'] - base:+.4f} agree={r['agree_vs_host200']:.3f}")


if __name__ == "__main__":
    main()
