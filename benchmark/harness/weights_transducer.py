"""A FastConformer transducer's weights from the run's seed, made on the
device in one call: the ``state_dict`` under NeMo's published names
(``reference.transducer.param_layout``), drawn as
``harness/weights_fastconformer.py`` draws the encoder's, with the
embedding's blank row zero (``blank_as_pad``).  The reference reads this
``state_dict``; the program loads it through its own converter
(``checkpoint.convert_fastconformer_state_dict``).

The joint's bias of the duration ``ADVANCE`` is raised by ``RAISE``, so
that every step advances ``ADVANCE`` frames on every seed.  Drawn as they
are, the encoder's outputs differ little from frame to frame and one
duration wins nearly every step, a different one for each seed: the loop
took 0.25, 0.5 and 1.0 steps a frame on three seeds (an H100, 700 W), and
a seed whose winner is 0 takes ``max_symbols`` steps a frame, so a run's
rate hung on its seed.  Two frames a step is the greedy loop's load at a
trained model's pace of about one token every two frames.
"""

from __future__ import annotations

import math

import torch

from reference.transducer import param_layout, sizes

EMBED = "decoder.prediction.embed.weight"
JOINT_BIAS = "joint.joint_net.2.bias"
ADVANCE = 2        # frames: the duration every step takes
RAISE = 4.0        # over the other durations' logits (PERF.md: their spread on the card)


def make_state_dict(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    layout = param_layout(sizes(model))
    total = sum(math.prod(leaf.shape) for leaf in layout.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    for name, leaf in layout.items():
        n = math.prod(leaf.shape)
        x = flat[at:at + n].view(leaf.shape).mul_(leaf.scale)
        out[name] = x.add_(1.0) if leaf.kind == "one" else x
        at += n
    out[EMBED][-1] = 0.0
    s = sizes(model)
    out[JOINT_BIAS][s.blank + 1 + s.durations.index(ADVANCE)] += RAISE
    return out
