"""The bytes the steps of an attention decoder's greedy loop must read at
least (``aed.step_bytes``, which the program counts and
``metrics/decode_bandwidth_share.aed_bulk.py`` reads), from the
configuration's sizes alone.

A step feeds each live row one token.  It reads, at the least:

* once, whichever rows are live: every decoder layer's self-attention
  query, key, value and output matrices, its cross-attention query and
  output matrices (the cross keys and values were projected before the
  loop) and its feed-forward's two, at the compute dtype's size; their
  biases and the layers' three LayerNorms, the embedding's and the final
  LayerNorm, in float32; the head's matrix and bias;
* for each live row: its cross-attention keys and values, every layer, over
  the row's frames, and its self-attention keys and values up to and with
  its position (step s at position len(prompt) - 1 + s), at the compute
  dtype's size.

The embedding's and the position table's rows (two of V a row) are left
out.  A step with no live row reads nothing.
"""

from __future__ import annotations


def weight_bytes(s, compute_bytes: int) -> int:
    """The weights a step reads (module docstring), for ``reference.aed``
    sizes ``s``."""
    d, f, v = s.hidden, s.inner, s.vocab
    matrices = s.n_layers * (4 * d * d + 2 * d * d + 2 * d * f) + d * v
    vectors = s.n_layers * (4 * d + 2 * d + f + d + 3 * 2 * d) + 2 * 2 * d + v
    return compute_bytes * matrices + 4 * vectors


def step_bytes(s, compute_bytes: int, live, frames) -> int:
    """Bytes of a batch's steps: ``live[b][t]`` whether row b was live at
    step t, ``frames[b]`` its encoder frames."""
    total = 0
    kv = 2 * s.n_layers * s.hidden * compute_bytes
    for t in range(len(live[0]) if len(live) else 0):
        rows = [b for b in range(len(live)) if live[b][t]]
        if rows:
            total += weight_bytes(s, compute_bytes)
        position = len(s.prompt) - 1 + t
        total += sum(kv * (frames[b] + position + 1) for b in rows)
    return total
