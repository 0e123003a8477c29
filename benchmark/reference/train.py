"""Plain reference of T-one's fine-tuning step, in float32.

The reference recipe (``tone/training``, the Hugging Face Trainer with
optax's arithmetic as the program states it): the CTC loss of the offline
forward in training mode, blank = the last class, each utterance's loss
divided by its label count and averaged over the batch, an utterance
without an alignment counting 0; the gradient clipped to a global norm
of ``max_grad_norm``; AdamW (b1 0.9, b2 0.999, eps 1e-8 added to the root
of the corrected second moment, decoupled weight decay) on a linear warm-up
over ``warmup_ratio`` of ``total_steps`` and a linear decay to 0, the rate
read at the update count before it is incremented.  The dropout seed of
step k is split from the run's seed as ``mix_seed`` does.

It imports nothing of the program it judges.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .model import FLOAT32, Precision, mix_seed, offline_forward, tree_items

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _ramp(start: float, end: float, steps: int, count: int) -> float:
    """From ``start`` to ``end`` over ``steps``, in float32."""
    if steps <= 0:
        return float(np.float32(start))
    frac = np.float32(1) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
    return float(np.float32(start - end) * frac + np.float32(end))


def learning_rate(count: int, lr: float, warmup_ratio: float, total_steps: int) -> float:
    warmup = max(int(total_steps * warmup_ratio), 1)
    if count < warmup:
        return _ramp(0.0, lr, warmup, count)
    return _ramp(lr, 0.0, total_steps - warmup, count - warmup)


def ctc_loss(logprobs, out_lens, labels, blank):
    mask = labels >= 0
    label_lens = mask.sum(-1)
    per = F.ctc_loss(logprobs.transpose(0, 1), torch.where(mask, labels, 0).long(),
                     out_lens.long(), label_lens.long(), blank=blank, reduction="none",
                     zero_infinity=True)
    per = torch.where(torch.isfinite(per) & (per < 1e5), per, torch.zeros_like(per))
    return (per / label_lens.clamp(min=1).to(per.dtype)).mean()


def train_steps(variables, s, batches, seed: int, hyper: dict, pr: Precision = FLOAT32):
    """Run ``len(batches)`` steps from ``variables`` (left unchanged).

    ``batches``: dicts of ``input_values`` (B, samples) float32,
    ``input_lengths`` (B,) and ``labels`` (B, L) padded with -100, on the
    device.  ``hyper``: learning_rate, warmup_ratio, total_steps,
    weight_decay, max_grad_norm.

    Returns {"loss": [per step], "grad": {path: norm of the clipped first
    gradient}, "change": {path: norm of the parameters' change after the
    last step}}.
    """
    paths, init = zip(*tree_items(variables["params"]))
    params = [p.detach().clone().requires_grad_(True) for p in init]
    stats = variables["batch_stats"]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    rng, count = seed, 0
    out = {"loss": [], "grad": {}, "change": {}}

    def tree(leaves):
        it = iter(leaves)

        def build(t):
            if isinstance(t, dict):
                return {k: build(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(build(v) for v in t)
            return next(it)
        return build(variables["params"])

    for k, batch in enumerate(batches):
        step_seed = mix_seed(rng, 1)
        rng = mix_seed(rng, 0)
        logprobs, out_lens, stats = offline_forward(
            {"params": tree(params), "batch_stats": stats}, s, batch["input_values"],
            batch["input_lengths"], pr, training=True, dropout_seed=step_seed)
        loss = ctc_loss(logprobs, out_lens, batch["labels"], s.vocab - 1)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.detach() for g, p in zip(grads, params)]
        out["loss"].append(float(loss.detach()))
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if not norm < hyper["max_grad_norm"]:
            grads = [g / norm * hyper["max_grad_norm"] for g in grads]
        if k == 0:
            out["grad"] = {p: float(torch.linalg.vector_norm(g)) for p, g in zip(paths, grads)}
        lr = learning_rate(count, hyper["learning_rate"], hyper["warmup_ratio"],
                           hyper["total_steps"])
        count += 1
        bc1 = 1 - ADAM_B1 ** count
        bc2 = 1 - ADAM_B2 ** count
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(ADAM_B1).add_(g * (1 - ADAM_B1))
                v.mul_(ADAM_B2).add_(g * g * (1 - ADAM_B2))
                update = (m / bc1) / ((v / bc2).sqrt() + ADAM_EPS)
                if hyper["weight_decay"]:
                    update = update + hyper["weight_decay"] * p
                p.add_(-lr * update)
    out["change"] = {path: float(torch.linalg.vector_norm(p.detach() - p0))
                     for path, p, p0 in zip(paths, params, init)}
    return out
