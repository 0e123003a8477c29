"""The yardstick's arithmetic: the card's peaks, the model's operations
counted from the configuration's shapes, and kernel B1's least time.

Operations are the multiply-adds of the products and convolutions, two to
each, as a model's FLOPs are counted; norms, activations and softmax are
left out.  Bytes are each input read once and each output written once.
"""

from __future__ import annotations

# Published dense peaks per card (NVIDIA's data sheet, SXM, at 700 W):
# bf16 tensor-core operations and HBM bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peak(kind: str) -> dict | None:
    """The peaks of the card named ``kind``; None for a card not in the
    table (and for the CPU), so that no share of a peak is made up."""
    return PEAKS.get(kind)


def chunk_flops(s) -> int:
    """Operations of one stream's streaming step on one chunk
    (``reference.model.Sizes``): frontend, subsampling, the layers at
    their chunk and reduced lengths with their attention windows, the
    reduction and the head.  The offline forward does the same per frame."""
    d, f, v = s.d_model, s.d_ff, s.vocab
    t_feat = (s.carry + s.chunk_samples - s.win) // s.hop + 1
    n_freqs = s.n_fft // 2 + 1
    ops = 2 * t_feat * s.win * 2 * n_freqs + 2 * t_feat * n_freqs * s.n_mels
    t, width = t_feat, s.feat_in
    in_ch = 1
    for ch, k, st, tail in zip(s.sub_channels, s.sub_kernels, s.sub_strides, s.sub_tails):
        t = (t + tail - k[0]) // st[0] + 1
        width = (width - k[1]) // st[1] + 1
        ops += 2 * t * width * ch * in_ch * k[0] * k[1]
        in_ch = ch
    full = t
    ops += 2 * full * s.sub_channels[-1] * width * d
    r, kr = s.red_factor, s.red_kernel
    red = (full + (kr - r) - kr) // r + 1
    for i in range(s.n_layers):
        ti = red if s.reduced(i) else full
        window = (s.window // r if s.reduced(i) else s.window) if i >= s.stateless else 0
        tkv = ti + window
        ops += 2 * (2 * ti * d * 2 * f + 2 * ti * f * d)          # ff1, ff2 (B1's)
        if s.recompute[i]:
            ops += 2 * ti * d * d + 2 * tkv * d * d + 2 * ti * tkv * d   # q, k, scores
        ops += 2 * tkv * d * d + 2 * ti * tkv * d + 2 * ti * d * d      # v, weights x v, out
        ops += 2 * ti * d * 2 * d + 2 * ti * d * s.conv_kernel + 2 * ti * d * d  # conv module
    ops += 2 * red * 4 * d * kr + 2 * red * 4 * d * d                  # reduction
    ops += 2 * full * d * v                                            # head
    return ops


def b1_bytes(m: int, f: int, d: int) -> int:
    """B1 reads [a | v] (M, 2F) and W2 (F, D) in bf16 and the float32 bias,
    and writes y (M, D) in bf16."""
    return m * 2 * f * 2 + f * d * 2 + d * 4 + m * d * 2


def b1_flops(m: int, f: int, d: int) -> int:
    return 2 * m * f * d


def b1_bound_s(m: int, f: int, d: int, peaks: dict) -> float:
    """The least time of one B1 launch: its bytes at the HBM bandwidth or
    its operations at the bf16 peak, whichever is longer."""
    return max(b1_bytes(m, f, d) / peaks["hbm_bytes"], b1_flops(m, f, d) / peaks["bf16_flops"])
