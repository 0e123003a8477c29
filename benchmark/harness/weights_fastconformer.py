"""A FastConformer's weights from the run's seed, made on the device in one
call: the ``state_dict`` under NeMo's published names
(``reference.fastconformer.param_layout``).

One ``torch.rand`` of every parameter's and statistic's elements from a
generator on the device, cut into the layout's leaves and scaled there:
weights and biases uniform in 1/sqrt(fan-in), norm scales and running
variances about 1, shifts, running means and position biases about 0.
Float32, the published checkpoint's type.  The reference reads this
``state_dict``; the program loads it through its own converter
(``checkpoint.convert_fastconformer_state_dict``).
"""

from __future__ import annotations

import math

import torch

from reference.fastconformer import param_layout, sizes


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
    return out
