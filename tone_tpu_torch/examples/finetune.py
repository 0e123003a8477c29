"""Fine-tuning example (port of ``examples/finetune.py``).

Runs end-to-end with a JSONL manifest of {"audio_filepath": ..., "text": ...}
lines (or with --synthetic for a smoke run without data).  Mirrors the
reference recipe: AdamW, lr 5e-5, linear schedule with 5% warmup, bf16
compute, greedy-WER eval per epoch, with train-state checkpointing and
resume.

    python -m tone_tpu_torch.examples.finetune --manifest train.jsonl \
        --eval-manifest dev.jsonl --init-checkpoint model.safetensors \
        --epochs 5 --batch-size 16
    python -m tone_tpu_torch.examples.finetune --synthetic   # smoke test, random data

``--init-checkpoint`` takes whatever ``StreamingCTCModel.from_local``
loads: a torch .safetensors/.bin/.pt in the reference's naming, the
reference's model.onnx, a .nemo archive or the port's checkpoint
directory.  Departure from the JAX recipe: the train state is saved with
``Trainer.save`` (``torch.save``'s format, not orbax), and the inference
checkpoint ``OUT/model`` is the port's checkpoint directory
(``config.json`` + ``variables.safetensors``, ``checkpoint.save_checkpoint``),
which ``from_local`` and the CLI's ``--checkpoint`` load.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tone_tpu_torch.device import resolve_device


def load_items(manifest: Path) -> list[dict]:
    from tone_tpu_torch.audio import read_audio
    from tone_tpu_torch.eval import read_manifest

    items = read_manifest(manifest)
    for item in items:
        item["audio"] = read_audio(item["audio_filepath"]).astype(np.float32) / 32767.0
    return items


def synthetic_items(n: int = 32) -> list[dict]:
    rng = np.random.default_rng(0)
    texts = ["да", "нет", "привет мир", "добрый день"]
    return [{"audio": rng.normal(0, 0.1, rng.integers(4000, 12000)).astype(np.float32),
             "text": texts[i % len(texts)]} for i in range(n)]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--manifest", type=Path)
    parser.add_argument("--eval-manifest", type=Path)
    parser.add_argument("--init-checkpoint", type=Path,
                        help="torch .safetensors/.bin, model.onnx, .nemo or the "
                             "port's checkpoint dir")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=5e-5)
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="gradient accumulation steps (effective batch = "
                             "batch-size x grad-accum)")
    parser.add_argument("--out", type=Path, default=Path("finetuned"))
    parser.add_argument("--resume", type=Path, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    return parser


def initial_variables(args, config) -> dict:
    """The weights fine-tuning starts from: ``--init-checkpoint`` loaded as
    the JAX recipe loads it (through ``from_local``, so with ``config``'s
    serving cast: bf16-rounded matrices under a bf16 config), cast to
    float32, with the GLU in-projections split again for training; else
    ``init_model_params`` from seed 0."""
    import torch

    from tone_tpu_torch.bridge import tree_map

    if args.init_checkpoint:
        from tone_tpu_torch.acoustic import StreamingCTCModel
        from tone_tpu_torch.interop import _split_ff

        variables = StreamingCTCModel.from_local(
            args.init_checkpoint, config=config, device="cpu").variables
        enc = dict(variables["params"]["encoder"])
        enc["layers"] = tuple({**layer, "ff1": _split_ff(layer["ff1"]),
                               "ff2": _split_ff(layer["ff2"])} for layer in enc["layers"])
        variables = {**variables, "params": {**variables["params"], "encoder": enc}}
        return tree_map(lambda t: t.to(torch.float32), variables)
    from tone_tpu_torch.core.model import init_model_params

    print("note: training from random init (no --init-checkpoint)")
    return init_model_params(torch.Generator().manual_seed(0), config)


def run(args, config) -> dict:
    """Fine-tune ``config`` as ``args`` say; returns each epoch's losses,
    mean loss and greedy WER, the step the run resumed at (None without
    ``--resume``), the last step and the inference checkpoint's path."""
    from tone_tpu_torch.checkpoint import save_checkpoint
    from tone_tpu_torch.training import DataCollatorCTCWithPadding, Trainer, TrainerConfig

    device = resolve_device(args.device)  # first: it turns TF32 off on the card
    variables = initial_variables(args, config)

    items = synthetic_items() if args.synthetic else load_items(args.manifest)
    eval_items = (items[:8] if args.synthetic or not args.eval_manifest
                  else load_items(args.eval_manifest))

    steps_per_epoch = max(len(items) // args.batch_size, 1)
    trainer = Trainer(config, TrainerConfig(
        learning_rate=args.lr,
        total_steps=max(steps_per_epoch * args.epochs // args.grad_accum, 1),
        grad_accum_steps=args.grad_accum,
    ), device=device)
    state = trainer.create_state(variables)
    resumed_at = None
    if args.resume:
        state = trainer.restore(args.resume, state)
        resumed_at = state.step
        print(f"resumed at step {resumed_at}")

    # Pad every batch to the dataset-max audio length, so that every step
    # has one shape.
    max_audio = max(len(it["audio"]) for it in items + eval_items)
    collator = DataCollatorCTCWithPadding(
        pad_audio_to_multiple_of=-(-max_audio // 2400) * 2400)
    rng = np.random.default_rng(0)

    def batches(data):
        order = rng.permutation(len(data))
        for i in range(0, len(data) - args.batch_size + 1, args.batch_size):
            feats = [{"input_values": data[j]["audio"], "labels": data[j]["text"]}
                     for j in order[i:i + args.batch_size]]
            yield collator(feats)

    def eval_batches():
        for i in range(0, len(eval_items), args.batch_size):
            chunk = eval_items[i:i + args.batch_size]
            yield collator([{"input_values": it["audio"], "labels": it["text"]}
                            for it in chunk])

    refs = [it["text"] for it in eval_items]
    epochs = []
    for epoch in range(args.epochs):
        losses = []
        for batch in batches(items):
            state, loss = trainer.train_step(state, batch)
            losses.append(float(loss))
        wer = trainer.eval_wer(state, eval_batches(), refs)
        print(f"epoch {epoch}: loss {np.mean(losses):.3f}  greedy WER {wer:.4f}")
        epochs.append({"loss": float(np.mean(losses)), "wer": wer, "losses": losses})
        trainer.save(args.out / "train_state", state)

    save_checkpoint(args.out / "model",
                    {"params": state.params, "batch_stats": state.batch_stats}, config)
    print(f"saved inference checkpoint to {args.out / 'model'}")
    return {"epochs": epochs, "resumed_at": resumed_at, "step": state.step,
            "model": args.out / "model"}


def main(argv: list[str] | None = None) -> None:
    from tone_tpu_torch.config import ToneConfig

    run(build_parser().parse_args(argv), ToneConfig())


if __name__ == "__main__":
    main()
