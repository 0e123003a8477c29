"""A FastConformer attention encoder-decoder's weights from the run's
seed, made on the device in one call: the ``state_dict`` under NeMo's names
(``reference.aed.param_layout``), drawn as
``harness/weights_fastconformer.py`` draws the encoder's.  The reference
reads this ``state_dict``; the program loads it through its own converter
(``checkpoint.convert_fastconformer_state_dict``).

Each decoder layer's cross-attention output matrix (``out_projection``) is
multiplied by ``CROSS_GAIN``, so that the logits depend on the audio.
Drawn as they are, the encoder's outputs of two windows differ by about
12 % an element and the cross-attention adds little to the decoder's
stream: decoding a row over another row's frames moved the logits only
1.3 to 1.6 times the sound program's distance to the reference (an H100,
700 W); at a gain of 4 it moves them about twice as far, and a gain of 8
moved them no further.  Nothing else is raised: ``<|endoftext|>`` wins
about one step in V, so that every row runs to its cap, which stands in
for the ``<|endoftext|>`` a trained model emits after the speech
(``configs/canary-1b-v2.json``, ``assumed``).
"""

from __future__ import annotations

import math

import torch

from reference.aed import DECODER, param_layout, sizes

CROSS_OUT = "second_sub_layer.out_projection.weight"
CROSS_GAIN = 4.0


def make_state_dict(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    s = sizes(model)
    layout = param_layout(s)
    total = sum(math.prod(leaf.shape) for leaf in layout.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    for name, leaf in layout.items():
        n = math.prod(leaf.shape)
        x = flat[at:at + n].view(leaf.shape).mul_(leaf.scale)
        out[name] = x.add_(1.0) if leaf.kind == "one" else x
        at += n
    for i in range(s.n_layers):
        out[f"{DECODER}.layers.{i}.{CROSS_OUT}"].mul_(CROSS_GAIN)
    return out
