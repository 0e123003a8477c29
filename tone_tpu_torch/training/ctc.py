"""CTC loss with the reference's torch semantics (port of
``tone_tpu/training/ctc.py``).

Blank is the pad id 34; ``reduction="mean"`` divides each sequence's loss
by its target length, then averages over the batch; ``zero_infinity``
zeroes a sequence whose loss is not finite or at least 1e5 (e.g. a target
longer than the output), together with its gradient.  The per-sequence loss
is ``torch.nn.functional.ctc_loss``'s, where the JAX package takes
``optax.ctc_loss``'s: the two agree per sequence and in their gradient with
respect to the logits of a log-softmax.  Where no alignment exists, optax
returns a large finite value and torch ``inf``; both become 0 under
``zero_infinity``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# A per-sequence loss at or above this counts as infinite (the reference's
# optax returns large finite values where no alignment exists).
INFINITE_LOSS = 1e5


def ctc_loss(logprobs: torch.Tensor, logprob_lens: torch.Tensor, labels: torch.Tensor, *,
             blank_id: int, reduction: str = "mean",
             zero_infinity: bool = True) -> torch.Tensor:
    """The CTC loss.

    Args:
        logprobs: (B, T, V) log-probabilities (log-softmaxed), float32.
        logprob_lens: (B,) valid output frames.
        labels: (B, L) integer labels padded with -100 (the Hugging Face
            convention of the reference's collator).
        blank_id: the CTC blank class id.
        reduction: "mean" (torch semantics), "sum" or "none".
        zero_infinity: zero the loss, and its gradient, of a sequence whose
            loss is not finite or at least 1e5.

    Returns:
        a scalar loss, or (B,) losses when ``reduction="none"``.
    """
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    label_mask = labels >= 0
    label_lens = label_mask.sum(-1)
    targets = torch.where(label_mask, labels, 0).long()
    per_seq = F.ctc_loss(logprobs.float().transpose(0, 1), targets, logprob_lens.long(),
                         label_lens.long(), blank=blank_id, reduction="none",
                         zero_infinity=zero_infinity)
    if zero_infinity:
        finite = torch.isfinite(per_seq) & (per_seq < INFINITE_LOSS)
        per_seq = torch.where(finite, per_seq, torch.zeros_like(per_seq))
    if reduction == "none":
        return per_seq
    if reduction == "sum":
        return per_seq.sum()
    return (per_seq / label_lens.clamp(min=1).to(per_seq.dtype)).mean()
