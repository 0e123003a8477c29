"""End-to-end proof on synthetic data: train -> deploy -> stream (port of
``examples/train_tiny_e2e.py``).

Trains a tiny (1.5 M-param) Conformer CTC from scratch on synthetic
tone-audio (each character rendered as a pure tone), then deploys the
trained weights through the STREAMING pipeline — chunked 300 ms inference
with carried recurrent state and greedy decoding — and checks exact
transcription.  Demonstrates the whole framework loop (data -> training ->
checkpoint -> streaming serving numerics) without any external dataset or
pretrained weights.

On a host with more than one GPU the training runs one rank per position
of the JAX script's mesh (``parallel/ranks.py train_on_mesh``); with one
GPU, or on the CPU, a plain ``Trainer``.

    python -m tone_tpu_torch.examples.train_tiny_e2e [--device cpu]

Expected output: train WER 0.000 and 6/6 exact streaming matches.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import torch

from tone_tpu_torch.bridge import tree_map
from tone_tpu_torch.config import LABELS, EncoderConfig, ToneConfig
from tone_tpu_torch.device import resolve_device

EVAL_ITEMS = 6  # utterances streamed through the deployed pipeline


def tiny_config() -> ToneConfig:
    enc = EncoderConfig(
        n_layers=4, d_model=128, n_heads=4, rope_dim=16, ff_expansion_factor=2,
        conv_kernel_size=15, subsampling_conv_channels=(16, 32),
        mhsa_stateless_layers=3, reduction_position=1, upsample_position=2,
        should_recompute_att_scores=(True, True, True, True),
        dropout=0.0, dropout_att=0.0,
    )
    return ToneConfig(encoder=enc, compute_dtype="float32")


def synth(text: str, sr: int = 8000, char_dur: float = 0.12) -> np.ndarray:
    """Render text as a sequence of character-specific pure tones."""
    freqs = {c: 300 + 150 * i for i, c in enumerate(LABELS[:12])}
    parts = [np.zeros(800)]
    for ch in text:
        n = int(char_dur * sr)
        t = np.arange(n) / sr
        parts.append(0.5 * np.sin(2 * np.pi * freqs[ch] * t) if ch in freqs
                     else np.zeros(n))
    parts.append(np.zeros(800))
    return np.concatenate(parts).astype(np.float32)


def make_dataset() -> list[dict]:
    words = ["аб", "вг", "дед", "абв", "где", "ба"]
    texts = [" ".join([words[i % 6], words[(i + 2) % 6]]) for i in range(12)]
    return [{"audio": synth(t), "text": t} for t in texts]


def make_collator(items: list[dict]):
    """The collator that pads every batch to the dataset's longest
    utterance, rounded up to whole 300 ms chunks."""
    from tone_tpu_torch.training import DataCollatorCTCWithPadding

    max_audio = max(len(i["audio"]) for i in items)
    return DataCollatorCTCWithPadding(pad_audio_to_multiple_of=-(-max_audio // 2400) * 2400)


def training_batches(items: list[dict], collator, steps: int, seed: int) -> list[dict]:
    """The collated batch of each step: 8 utterances drawn with replacement
    from ``np.random.default_rng(seed)``, as the JAX script draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        idx = rng.choice(len(items), 8)
        out.append(collator([{"input_values": items[j]["audio"], "labels": items[j]["text"]}
                             for j in idx]))
    return out


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """(data, model) ranks of the JAX script's mesh on ``n_devices``."""
    return min(4, n_devices), 2 if n_devices >= 8 else 1


def run_training(steps: int = 400, lr: float = 1e-3, seed: int = 0, variables=None,
                 device=None, devices=None):
    """Train the tiny model; returns (cfg, trainer, state, collator, items).

    ``variables``: the initial ``{"params", "batch_stats"}`` (torch
    tensors), by default the JAX script's, ``init_model_params(
    jax.random.PRNGKey(seed))``, drawn by the port's numpy copy of JAX's
    PRNG (``core/jax_random.py``).  The result depends on them: the corpus
    holds 0.1 s of silence around each utterance, the streaming pipeline
    pads 0.3 s more, and what the model emits on the longer silence no loss
    teaches.  From JAX's PRNGKey(0) weights it emits blanks there (6/6
    exact); from the port's own ``init_model_params`` with
    ``torch.Generator`` seeds 0-3, 0, 4, 6 and 0 of 6 exact, mostly for
    stray letters in the padding (on the CPU; PERF.md).  ``device``: ``cuda`` unless
    the caller asks for the CPU; the returned trainer and state live there.
    ``devices``: the training mesh's devices, by default every GPU of a
    host with more than one; with more than one device the steps run as
    one rank per mesh position and the state is the saved one, restored on
    ``device``."""
    from tone_tpu_torch.core.jax_random import jax_init_model_params
    from tone_tpu_torch.training import Trainer, TrainerConfig

    dev = resolve_device(device)  # first: it turns TF32 off on the card
    cfg = tiny_config()
    if variables is None:
        variables = jax_init_model_params(seed, cfg)
    items = make_dataset()
    collator = make_collator(items)
    batches = training_batches(items, collator, steps, seed)
    tcfg = TrainerConfig(total_steps=steps, learning_rate=lr)
    trainer = Trainer(cfg, tcfg, device=dev)
    if devices is None and dev.type == "cuda" and torch.cuda.device_count() > 1:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if devices is not None and len(devices) > 1:
        from tone_tpu_torch.parallel.ranks import train_on_mesh

        n_data, n_model = mesh_shape(len(devices))
        spec = {"config": cfg.to_dict(), "trainer": dataclasses.asdict(tcfg),
                "variables": tree_map(lambda t: t.detach().cpu(), variables),
                "batches": [{k: torch.as_tensor(v) for k, v in b.items()} for b in batches],
                "steps": steps, "n_data": n_data, "n_model": n_model, "save": True}
        with tempfile.TemporaryDirectory(prefix="tone_tiny_") as tmp:
            ranks = train_on_mesh(spec, devices[:n_data * n_model], Path(tmp))
            state = trainer.restore(Path(tmp) / "checkpoint")
        for step in range(0, steps, 50):
            print(f"step {step}: loss {ranks[0]['losses'][step]:.3f}", flush=True)
        return cfg, trainer, state, collator, items
    state = trainer.create_state(variables)
    for step, batch in enumerate(batches):
        state, loss = trainer.train_step(state, batch)
        if step % 50 == 0:
            print(f"step {step}: loss {float(loss):.3f}", flush=True)
    return cfg, trainer, state, collator, items


def trained_variables(state) -> dict:
    """``{"params", "batch_stats"}`` of a train state, detached."""
    return {"params": tree_map(lambda t: t.detach().clone(), state.params),
            "batch_stats": tree_map(lambda t: t.detach().clone(), state.batch_stats)}


def int_audio(audio: np.ndarray) -> np.ndarray:
    """Float audio in [-1, 1] as int32 samples of the 16-bit range."""
    return np.clip(audio * 32767, -32768, 32767).astype(np.int32)


def deploy(cfg: ToneConfig, variables, device=None):
    """The streaming pipeline (greedy decoding) over ``variables``."""
    from tone_tpu_torch.acoustic import StreamingCTCModel
    from tone_tpu_torch.decoder import GreedyCTCDecoder
    from tone_tpu_torch.pipeline import StreamingCTCPipeline
    from tone_tpu_torch.splitter import StreamingLogprobSplitter

    model = StreamingCTCModel(variables, cfg, device=device)
    return StreamingCTCPipeline(model, StreamingLogprobSplitter(), GreedyCTCDecoder())


def stream_texts(pipe, items: list[dict]) -> list[str]:
    """Each item's text through ``pipe.forward_offline``."""
    return [" ".join(p.text for p in pipe.forward_offline(int_audio(it["audio"])))
            for it in items]


def run(steps: int = 400, lr: float = 1e-3, seed: int = 0,
        device=None) -> tuple[float, int, int]:
    """Returns (train WER, exact streaming matches, total checked)."""
    cfg, trainer, state, collator, items = run_training(steps, lr, seed, device=device)

    eval_batch = collator([{"input_values": it["audio"], "labels": it["text"]}
                           for it in items])
    wer = trainer.eval_wer(state, [eval_batch], [it["text"] for it in items])
    print(f"train WER: {wer:.3f}")

    checked = items[:EVAL_ITEMS]
    texts = stream_texts(deploy(cfg, trained_variables(state), trainer.device), checked)
    hits = 0
    for it, text in zip(checked, texts):
        print(f"  ref={it['text']!r} hyp={text!r}")
        hits += text == it["text"]
    print(f"streaming pipeline exact matches: {hits}/{len(checked)}")
    return wer, hits, len(checked)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
