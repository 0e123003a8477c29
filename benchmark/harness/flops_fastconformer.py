"""A FastConformer's operations per call, counted from the configuration's
shapes (``reference.fastconformer.Sizes``) and the call's length: the
multiply-adds of the products and convolutions, two to each, as a model's
FLOPs are counted; norms, activations, softmax and the position
encodings' sines are left out.

Everything but the attention's scores and weights grows with the call's
frames; those grow with their square: 8 T^2 d per layer (2 T^2 d for
(q + u) . k, 4 T^2 d for (q + v) . p over the 2T - 1 positions, 2 T^2 d
for the weights times V).
"""

from __future__ import annotations


def _halved(n: int) -> int:
    """Length after one k3, s2, p1 convolution."""
    return (n - 1) // 2 + 1


def call_flops(s, n_samples: int) -> int:
    """Operations of one call of ``n_samples`` alone."""
    d, f, c, v = s.d_model, s.d_ff, s.sub_channels, s.vocab
    n_freqs = s.n_fft // 2 + 1
    t_feat = n_samples // s.hop + 1
    ops = t_feat * (2 * s.win * 2 * n_freqs + 2 * n_freqs * s.n_mels)      # STFT, mels
    t, w = _halved(t_feat), _halved(s.n_mels)
    ops += 2 * t * w * c * 9                                                # conv 1 -> C
    for _ in range(s.n_sub_convs - 1):
        t, w = _halved(t), _halved(w)
        ops += 2 * t * w * c * 9 + 2 * t * w * c * c                        # depthwise, pointwise
    ops += 2 * t * c * w * d                                                # out
    per_frame = (2 * 2 * (2 * d * f)              # two feed-forwards, two linears each
                 + 4 * 2 * d * d                  # q, k, v, out
                 + 2 * d * 2 * d + 2 * d * s.conv_kernel + 2 * d * d)   # the convolution module
    per_layer = t * per_frame + 2 * (2 * t - 1) * d * d + 8 * t * t * d   # + linear_pos, scores
    return ops + s.n_layers * per_layer + 2 * t * d * v                     # + head
