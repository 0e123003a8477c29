"""Batched greedy CTC decode with the argmax and collapse on the device
(port of ``tone_tpu/ops/greedy.py``).

The host greedy decoder (``decoder.GreedyCTCDecoder``) takes one phrase at
a time; this op computes the argmax, the repeat-collapse and the blank-drop
masks of a whole batch as tensor ops on the logprobs' device, leaving only
the joining of strings to the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tone_tpu_torch.config import BLANK_ID, LABELS

__all__ = ["batched_greedy_decode", "greedy_collapse_tokens"]


def greedy_collapse_tokens(logprobs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, V) logprobs -> (tokens (B, T) int32, keep (B, T) bool), on the
    logprobs' device.

    ``keep`` marks the frames that survive CTC collapse: the first frame of
    each run of a non-blank token.  ``torch.argmax`` takes the first maximal
    index, as ``jnp.argmax`` does.
    """
    tokens = torch.argmax(logprobs, dim=-1).to(torch.int32)
    prev = F.pad(tokens[:, :-1], (1, 0), value=-1)
    keep = (tokens != prev) & (tokens != BLANK_ID)
    return tokens, keep


def batched_greedy_decode(logprobs, lengths=None) -> list[str]:
    """Decode a batch of logprobs to texts: argmax and collapse on the
    logprobs' device (a numpy array is read on the CPU), join on the host.

    Args:
        logprobs: (B, T, V) tensor or numpy array.
        lengths: optional (B,) valid frame counts.
    """
    tokens, keep = greedy_collapse_tokens(torch.as_tensor(logprobs))
    tokens, keep = tokens.cpu().numpy(), keep.cpu().numpy()
    if lengths is not None:
        keep = keep & (np.arange(tokens.shape[1])[None, :] < np.asarray(lengths)[:, None])
    return ["".join(LABELS[i] for i in row_tokens[row_keep]).strip()
            for row_tokens, row_keep in zip(tokens, keep)]
