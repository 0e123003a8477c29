"""The JAX package's initial weights without JAX: JAX's default PRNG
(threefry-2x32 with partitionable counters, ``jax_threefry_partitionable``,
the default since JAX 0.5) copied in numpy, and the key tree of
``tone_tpu.core.model.init_model_params`` (``tone_tpu/core/model.py:53``,
``encoder.py:81-145``, ``layers.py:36-60, :261``) walked with it.

``jax_init_model_params(seed, config)`` gives the variables that
``init_model_params(jax.random.PRNGKey(seed), config)`` gives, bit for bit,
as float32 torch tensors on the CPU (tests/test_torch_recipes.py).  The
port's own ``core.model.init_model_params`` draws from a torch generator
and gives other weights; this copy lets the port train a recipe from the
very weights the JAX recipe starts from.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tone_tpu_torch.config import EncoderConfig, ToneConfig
from tone_tpu_torch.core import layers as L

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry-2x32 block cipher (20 rounds) of key (k1, k2) over the
    counter words (x0, x1), as JAX computes it."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The (high, low) 32-bit words of the flat indices 0 … n-1."""
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): (0, seed)."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed {seed} is not in [0, 2**32)")
    return np.array([0, seed], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key[0], key[1], *_counters(num))
    return np.stack([b1, b2], axis=1)


def uniform(key: np.ndarray, shape: tuple[int, ...], minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    n = math.prod(shape)
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key[0], key[1], *_counters(n))
    bits = b1 ^ b2
    floats = ((bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)).view(np.float32)
    floats = floats - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA fuses ``floats * (hi - lo) + lo`` into one multiply-add with one
    # rounding: the product of two float32 values is exact in extended
    # precision, and the sum rounded from there to float32 gives the FMA's
    # result (bar a double rounding, which no weight of the model meets).
    fma = (floats.astype(np.longdouble) * np.longdouble(hi - lo) + np.longdouble(lo))
    return np.maximum(lo, fma.astype(np.float32)).reshape(shape)


def _uniform(key, shape, bound: float) -> torch.Tensor:
    return torch.from_numpy(uniform(key, shape, -bound, bound))


def _linear(key, d_in: int, d_out: int, bias: bool = True) -> dict:
    k1, k2 = split(key)
    bound = 1.0 / np.sqrt(d_in)
    p = {"w": _uniform(k1, (d_in, d_out), bound)}
    if bias:
        p["b"] = _uniform(k2, (d_out,), bound)
    return p


def _conv(key, out_ch: int, in_ch_per_group: int, kernel: tuple[int, ...]) -> dict:
    k1, k2 = split(key)
    bound = 1.0 / np.sqrt(in_ch_per_group * int(np.prod(kernel)))
    return {"w": _uniform(k1, (out_ch, in_ch_per_group, *kernel), bound),
            "b": _uniform(k2, (out_ch,), bound)}


def _mhsa(key, d_model: int, n_heads: int, recompute_scores: bool) -> dict:
    keys = split(key, 4)
    p = {"linear_v": _linear(keys[0], d_model, d_model),
         "linear_out": _linear(keys[1], d_model, d_model)}
    if recompute_scores:
        p["linear_q"] = _linear(keys[2], d_model, d_model)
        p["linear_k"] = _linear(keys[3], d_model, d_model)
        p["q_ln"] = L.init_layernorm(d_model // n_heads)
        p["k_ln"] = L.init_layernorm(d_model // n_heads)
    return p


def _ff(key, d_model: int, d_ff: int) -> dict:
    k = split(key, 3)
    return {"lin1": _linear(k[0], d_model, d_ff), "linv": _linear(k[1], d_model, d_ff),
            "lin2": _linear(k[2], d_ff, d_model)}


def _encoder(key, cfg: EncoderConfig) -> tuple[dict, dict]:
    keys = split(key, cfg.n_layers + 3)
    ch, ks = cfg.subsampling_conv_channels, cfg.subsampling_kernel_size
    k_pre = split(keys[0], 4)
    bn1_p, bn1_s = L.init_batchnorm(ch[0])
    bn2_p, bn2_s = L.init_batchnorm(ch[1])
    pre_encode = {
        "pre_norm": L.init_rmsnorm(cfg.feat_in),
        "conv1": _conv(k_pre[0], ch[0], 1, ks[0]),
        "bn1": bn1_p,
        "conv2": _conv(k_pre[1], ch[1], ch[0], ks[1]),
        "bn2": bn2_p,
        "out": _linear(k_pre[2], ch[1] * cfg.subsampling_hidden_features[1], cfg.d_model,
                       bias=False),
        "out_norm": L.init_rmsnorm(cfg.d_model),
    }
    layers, stats = [], []
    for i in range(cfg.n_layers):
        k = split(keys[1 + i], 8)
        bn_p, bn_s = L.init_batchnorm(cfg.d_model)
        layers.append({
            "norm_ff1": L.init_rmsnorm(cfg.d_model),
            "ff1": _ff(k[0], cfg.d_model, cfg.d_ff),
            "norm_att": L.init_rmsnorm(cfg.d_model),
            "att": _mhsa(k[1], cfg.d_model, cfg.n_heads, cfg.should_recompute_att_scores[i]),
            "norm_conv": L.init_rmsnorm(cfg.d_model),
            "conv": {"pw1": _linear(k[2], cfg.d_model, cfg.d_model * 2),
                     "dw": _conv(k[3], cfg.d_model, 1, (cfg.conv_kernel_size,)),
                     "bn": bn_p,
                     "pw2": _linear(k[4], cfg.d_model, cfg.d_model)},
            "norm_ff2": L.init_rmsnorm(cfg.d_model),
            "ff2": _ff(k[5], cfg.d_model, cfg.d_ff),
            "norm_out": L.init_rmsnorm(cfg.d_model),
        })
        stats.append({"conv_bn": bn_s})
    k_red = split(keys[-1], 2)
    reduction = {"dw": _conv(k_red[0], cfg.d_model * 4, 1, (cfg.reduction_kernel_size,)),
                 "pw": _linear(k_red[1], cfg.d_model * 4, cfg.d_model)}
    return ({"pre_encode": pre_encode, "layers": tuple(layers), "reduction": reduction},
            {"pre_encode": {"bn1": bn1_s, "bn2": bn2_s}, "layers": tuple(stats)})


def jax_init_model_params(seed: int, config: ToneConfig) -> dict:
    """``tone_tpu.core.model.init_model_params(jax.random.PRNGKey(seed),
    config)`` as float32 torch tensors on the CPU."""
    k_enc, k_head = split(prng_key(seed))
    params, stats = _encoder(k_enc, config.encoder)
    head = _linear(k_head, config.encoder.d_model, config.vocab_size_with_blank)
    return {"params": {"encoder": params, "head": head}, "batch_stats": stats}
