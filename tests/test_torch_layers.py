"""The port's primitives (tone_tpu_torch/core/layers.py) against the JAX
package's (tone_tpu/core/layers.py) on the same numpy inputs.

float32 at 1e-5.  The bf16 ``linear`` is also held to the reference's
single rounding (product summed in float32, float32 bias, one rounding).
"""

import test_torch_common  # noqa: F401  (keeps torch's thread count small)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tone_tpu.core import layers as JL
from tone_tpu_torch.core import layers as TL

TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _both(tree):
    """(jnp tree, torch tree) of a numpy tree of dicts."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(np.ascontiguousarray(tree))


def _close(jax_out, torch_out, tol=TOL):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32), atol=tol, rtol=0)


def _f32(*shape, seed=0, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_fp32(bias):
    p = {"w": _f32(24, 16, seed=1, scale=0.2)}
    if bias:
        p["b"] = _f32(16, seed=2)
    jp, tp = _both(p)
    x = _f32(3, 5, 24)
    _close(JL.linear(jp, jnp.asarray(x), jnp.float32),
           TL.linear(tp, torch.from_numpy(x), torch.float32))


def test_linear_bf16_rounds_once():
    """bf16 x bf16 summed in float32, float32 bias, ONE rounding: equal to
    the reference's bf16 linear to within one bf16 ulp of the output."""
    p = {"w": _f32(64, 32, seed=1, scale=0.2), "b": _f32(32, seed=2)}
    jp, tp = _both(p)
    x = _f32(4, 7, 64)
    ref = np.asarray(JL.linear(jp, jnp.asarray(x), jnp.bfloat16), np.float32)
    got = TL.linear(tp, torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ulp = np.abs(ref) * 2.0 ** -7 + 1e-6
    assert (np.abs(got.float().numpy() - ref) <= ulp).all()


@pytest.mark.parametrize("d", [8, 64])
def test_rmsnorm(d):
    jp, tp = _both({"weight": _f32(d, seed=3)})
    x = _f32(2, 5, d, scale=3.0)
    _close(JL.rmsnorm(jp, jnp.asarray(x)), TL.rmsnorm(tp, torch.from_numpy(x)))


def test_layernorm():
    jp, tp = _both({"scale": _f32(12, seed=3), "bias": _f32(12, seed=4)})
    x = _f32(2, 3, 5, 12, scale=2.0) + 1.0
    _close(JL.layernorm(jp, jnp.asarray(x)), TL.layernorm(tp, torch.from_numpy(x)))


@pytest.mark.parametrize("channel_axis", [1, 2])
def test_batchnorm_eval(channel_axis):
    c = 6
    jp, tp = _both({"scale": _f32(c, seed=1), "bias": _f32(c, seed=2)})
    js, ts = _both({"mean": _f32(c, seed=3), "var": np.abs(_f32(c, seed=4)) + 0.5})
    shape = [2, 5, 7]
    shape[channel_axis] = c
    x = _f32(*shape)
    ref, _ = JL.batchnorm(jp, js, jnp.asarray(x), channel_axis=channel_axis)
    y, stats = TL.batchnorm(tp, ts, torch.from_numpy(x), channel_axis=channel_axis)
    _close(ref, y)
    assert stats is ts  # eval mode hands the running statistics back


@pytest.mark.parametrize("channel_axis", [1, 2])
def test_batchnorm_train(channel_axis):
    """Batch statistics for the output, running statistics updated with
    momentum 0.1 from the unbiased variance, as the JAX package's."""
    c = 6
    jp, tp = _both({"scale": _f32(c, seed=1), "bias": _f32(c, seed=2)})
    js, ts = _both({"mean": _f32(c, seed=3), "var": np.abs(_f32(c, seed=4)) + 0.5})
    shape = [2, 5, 7]
    shape[channel_axis] = c
    x = _f32(*shape, seed=5, scale=2.0)
    ref, ref_stats = JL.batchnorm(jp, js, jnp.asarray(x), channel_axis=channel_axis,
                                  training=True)
    y, stats = TL.batchnorm(tp, ts, torch.from_numpy(x), channel_axis=channel_axis,
                            training=True)
    _close(ref, y)
    for k in ("mean", "var"):
        _close(ref_stats[k], stats[k])
        assert not stats[k].requires_grad


def test_silu_and_conv_glu():
    x = _f32(3, 10, scale=3.0)
    _close(JL.silu(jnp.asarray(x)), TL.silu(torch.from_numpy(x)))
    # The conv-module GLU is a * sigmoid(b), not silu(a) * b.
    _close(JL.glu(jnp.asarray(x), axis=-1), TL.glu(torch.from_numpy(x), dim=-1))


@pytest.mark.parametrize("stride", [(1, 1), (3, 1)])
def test_conv2d(stride):
    jp, tp = _both({"w": _f32(4, 2, 5, 3, seed=1, scale=0.3), "b": _f32(4, seed=2)})
    x = _f32(2, 2, 13, 9)
    _close(JL.conv2d(jp, jnp.asarray(x), stride, jnp.float32),
           TL.conv2d(tp, torch.from_numpy(x), stride, torch.float32))


@pytest.mark.parametrize("case", ["plain", "depthwise", "x4_grouped_stride2"])
def test_conv1d_nhc(case):
    c = 8
    if case == "plain":
        w, groups, stride, out = _f32(5, c, 3, seed=1), 1, 1, 5
    elif case == "depthwise":
        w, groups, stride, out = _f32(c, 1, 7, seed=1), c, 1, c
    else:  # the temporal reduction: out channel o reads input channel o // 4
        w, groups, stride, out = _f32(4 * c, 1, 3, seed=1), c, 2, 4 * c
    jp, tp = _both({"w": w, "b": _f32(out, seed=2)})
    x = _f32(2, 11, c)
    ref = JL.conv1d_nhc(jp, jnp.asarray(x), stride, groups, jnp.float32)
    got = TL.conv1d_nhc(tp, torch.from_numpy(x), stride, groups, torch.float32)
    assert tuple(got.shape) == ref.shape
    _close(ref, got)


@pytest.mark.parametrize("offset", [0, 15, 30])
def test_apply_rope(offset):
    x = _f32(2, 3, offset + 10, 12)
    _close(JL.apply_rope(jnp.asarray(x), 8, offset), TL.apply_rope(torch.from_numpy(x), 8, offset))


def _mhsa_params(d, n_heads, recompute):
    p = {"linear_v": {"w": _f32(d, d, seed=1, scale=0.2), "b": _f32(d, seed=2)},
         "linear_out": {"w": _f32(d, d, seed=3, scale=0.2), "b": _f32(d, seed=4)}}
    if recompute:
        dh = d // n_heads
        p["linear_q"] = {"w": _f32(d, d, seed=5, scale=0.2), "b": _f32(d, seed=6)}
        p["linear_k"] = {"w": _f32(d, d, seed=7, scale=0.2), "b": _f32(d, seed=8)}
        p["q_ln"] = {"scale": _f32(dh, seed=9), "bias": _f32(dh, seed=10)}
        p["k_ln"] = {"scale": _f32(dh, seed=11), "bias": _f32(dh, seed=12)}
    return _both(p)


@pytest.mark.parametrize("masked", [False, True])
def test_mhsa(masked):
    d, h, tq, window = 32, 4, 5, 15
    jp, tp = _mhsa_params(d, h, recompute=True)
    q = _f32(2, tq, d, seed=20)
    kv = _f32(2, window + tq, d, seed=21)
    mask = None
    if masked:  # stream 0: 10 invalid leading window rows, stream 1: none
        cols = np.arange(window + tq)[None, :] < np.array([10, 0])[:, None]
        mask = np.broadcast_to(cols[:, None, :], (2, tq, window + tq)).copy()
    kw = dict(n_heads=h, rope_dim=4, k_offset=window, cached_scores=None)
    ref_out, ref_scores = JL.mhsa(jp, jnp.asarray(q), jnp.asarray(kv),
                                  mask=None if mask is None else jnp.asarray(mask),
                                  compute_dtype=jnp.float32, **kw)
    out, scores = TL.mhsa(tp, torch.from_numpy(q), torch.from_numpy(kv),
                          mask=None if mask is None else torch.from_numpy(mask),
                          compute_dtype=torch.float32, **kw)
    _close(ref_scores, scores)
    _close(ref_out, out)


def test_mhsa_cached_scores():
    """A score-reuse layer has no q/k weights and takes the scores given."""
    d, h, t = 32, 4, 10
    jp, tp = _mhsa_params(d, h, recompute=False)
    x = _f32(2, t, d, seed=20)
    scores = _f32(2, h, t, t, seed=22)
    kw = dict(n_heads=h, rope_dim=4, k_offset=0, mask=None)
    ref_out, _ = JL.mhsa(jp, jnp.asarray(x), jnp.asarray(x), cached_scores=jnp.asarray(scores),
                         compute_dtype=jnp.float32, **kw)
    out, got_scores = TL.mhsa(tp, torch.from_numpy(x), torch.from_numpy(x),
                              cached_scores=torch.from_numpy(scores),
                              compute_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(got_scores.numpy(), scores)
    _close(ref_out, out)
