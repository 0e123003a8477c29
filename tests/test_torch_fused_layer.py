"""The port's fused Conformer layer (tone_tpu_torch/ops/fused_layer.py,
ops/fused_encoder.py) against the JAX package's, on the CPU.

The JAX kernel runs in Pallas interpret mode; the port runs its plain
version (the CUDA kernel is held against that on the card, in
tests/test_torch_gpu.py and chip_smoke.py).  Weights are the tiny model's
with every norm, LayerNorm and BatchNorm perturbed from the identity, so
the packing and the BatchNorm fold are exercised.

Tolerances:
* one layer: y, new conv state and new window within 0.05 max and 2e-3
  mean; scores within 2e-2 (both sides round at the same points, so what
  is left is float32 summation order and the bf16 ulps it flips);
* the fused step, 4 chunks of 2 streams: logprobs within 0.05 of the JAX
  fused step and every state leaf within 0.1; within 0.1 of the port's
  eager step (the JAX package's own bound for fused vs eager,
  tests/test_fused_layer.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import audio, tiny_configs

from tone_tpu.core import model as JM
from tone_tpu.ops import fused_encoder as JFE
from tone_tpu.ops import fused_layer as JFL
from tone_tpu_torch.bridge import from_jax_variables
from tone_tpu_torch.core import model as TM
from tone_tpu_torch.ops import fused_encoder as TFE
from tone_tpu_torch.ops import fused_layer as TFL

B = 4
N_CHUNKS = 4

# (tiny-model layer, t, window, recompute, invalid prefixes per stream)
LAYER_KINDS = {
    "stateless_recompute_t10": (0, 10, 0, True, None),
    "stateless_recompute_t5": (2, 5, 0, True, None),
    "stateless_reuse": (1, 10, 0, False, None),
    "stateful_w15": (3, 5, 15, True, [15, 10, 5, 0]),
    "stateful_w30": (4, 10, 30, True, [30, 20, 10, 0]),
}


def _perturb(tree, rng):
    """Norm weights, LayerNorm/BatchNorm scales and biases and BatchNorm
    statistics moved off the identity (numpy leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list, tuple)):
                out[k] = _perturb(v, rng)
            elif k in ("weight", "scale"):
                out[k] = (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out
    return type(tree)(_perturb(v, rng) for v in tree)


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_configs("bfloat16")
    jv = jax.tree.map(np.asarray, JM.init_model_params(jax.random.PRNGKey(0), jc))
    jv = _perturb(jv, np.random.default_rng(7))
    tv = from_jax_variables(jv, tc, "cpu")
    return jc, tc, jax.tree.map(jnp.asarray, jv), tv


def _layer_weights(tiny, layer, t, window, recompute):
    jc, tc, jv, tv = tiny
    jw = JFL.flatten_layer_params(jv["params"]["encoder"]["layers"][layer],
                                  jv["batch_stats"]["layers"][layer], jc.encoder,
                                  t=t, window=window, recompute=recompute)
    tw = TFL.flatten_layer_params(tv["params"]["encoder"]["layers"][layer],
                                  tv["batch_stats"]["layers"][layer], tc.encoder,
                                  t=t, window=window, recompute=recompute, device="cpu")
    return jw, tw


def _strip_padding(name, arr, e):
    """A leaf of the JAX package's flattened list without its 128-lane head
    padding, in the port's shape."""
    h, dh, pad = e.n_heads, e.d_model // e.n_heads, JFL.PAD_DH
    arr = np.asarray(arr, np.float32)
    if name in ("wq", "wk", "wv"):
        return arr.reshape(e.d_model, h, pad)[:, :, :dh].reshape(e.d_model, -1)
    if name in ("bq", "bk", "bv"):
        return arr.reshape(h, pad)[:, :dh].reshape(-1)
    if name == "wout":
        return arr.reshape(h, pad, e.d_model)[:, :dh].reshape(-1, e.d_model)
    if name in ("qln_s", "qln_b", "kln_s", "kln_b"):
        return arr.reshape(h, pad)[0, :dh]
    if name.startswith(("cos", "sin")):
        return arr.reshape(arr.shape[0], h, pad)[:, 0, :e.rope_dim]
    return arr.reshape(arr.shape[1:]) if arr.ndim == 2 and arr.shape[0] == 1 else arr


@pytest.mark.parametrize("kind", sorted(LAYER_KINDS))
def test_packing_matches_jax_flatten(tiny, kind):
    """Every leaf (BatchNorm fold and RoPE tables included) equals the JAX
    package's flattened leaf with its head padding stripped."""
    layer, t, window, recompute, _ = LAYER_KINDS[kind]
    jw, tw = _layer_weights(tiny, layer, t, window, recompute)
    names = tw.names()
    assert len(names) == len(jw)
    for name, jleaf in zip(names, jw):
        ref = _strip_padding(name, jleaf, tiny[0].encoder)
        got = tw.leaf(name)
        assert got.dtype == (torch.bfloat16 if name in TFL.MAT_NAMES else torch.float32), name
        assert tuple(got.shape) == ref.shape, name
        tol = 1e-6 if name in ("bn_scale", "bn_shift") else 0.0  # rsqrt of two libraries
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=tol, err_msg=name)
    assert tw.mats.is_contiguous() and tw.vecs.is_contiguous()


@pytest.mark.parametrize("kind", sorted(LAYER_KINDS))
def test_plain_layer_matches_jax_kernel(tiny, kind):
    layer, t, window, recompute, invalid = LAYER_KINDS[kind]
    e = tiny[0].encoder
    jw, tw = _layer_weights(tiny, layer, t, window, recompute)
    rng = np.random.default_rng(layer)
    d, h, k = e.d_model, e.n_heads, e.conv_kernel_size
    x = rng.standard_normal((B, t, d)).astype(np.float32)
    conv = 0.5 * rng.standard_normal((B, k - 1, d)).astype(np.float32)
    win = rng.standard_normal((B, window, d)).astype(np.float32) if window else None
    inv = np.asarray(invalid, np.int32)[:, None] if window else None
    scores_in = (None if recompute else
                 2.0 * rng.standard_normal((B, h, t, window + t)).astype(np.float32))

    jb = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jout = JFL.fused_conformer_layer(
        jb(x), jb(conv), jb(win), None if inv is None else jnp.asarray(inv),
        None if scores_in is None else jnp.asarray(scores_in), tuple(jw),
        t=t, d=d, d_ff=e.d_ff, n_heads=h, rope_dim=e.rope_dim, window=window,
        recompute=recompute, conv_k=k, block_b=B, interpret=True)
    tb = lambda a: None if a is None else torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    tout = TFL.fused_conformer_layer(
        tb(x), tb(conv), tb(win), None if inv is None else torch.from_numpy(inv),
        None if scores_in is None else torch.from_numpy(scores_in), tw,
        t=t, window=window, recompute=recompute, n_heads=h, rope_dim=e.rope_dim, conv_k=k)

    for name, j, p in zip(("y", "new_conv", "new_win", "scores"), jout, tout):
        if j is None:
            assert p is None, name
            continue
        ref = np.asarray(j, np.float32)
        got = p.float().numpy()
        assert got.shape == ref.shape, name
        err = np.abs(got - ref)
        if name == "scores":
            assert err.max() < 2e-2, (name, err.max())
        else:
            assert err.max() < 0.05 and err.mean() < 2e-3, (name, err.max(), err.mean())
    assert tout[0].dtype == torch.bfloat16
    assert TFL.fused_conformer_layer.launches == 0  # CPU tensors never launch


def test_layer_rejects_a_mismatched_packing(tiny):
    _, tw = _layer_weights(tiny, 0, 10, 0, True)
    e = tiny[0].encoder
    x = torch.zeros(1, 5, e.d_model, dtype=torch.bfloat16)
    conv = torch.zeros(1, e.conv_kernel_size - 1, e.d_model, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="packed for"):
        TFL.fused_conformer_layer(x, conv, None, None, None, tw, t=5, window=0,
                                  recompute=True, n_heads=e.n_heads, rope_dim=e.rope_dim,
                                  conv_k=e.conv_kernel_size)


LEAVES = ("sub1", "sub2", "mhsa", "conv", "mhsa_len", "reduction")


def _leaves(state):
    return {"preproc": state.preproc, **{n: getattr(state.encoder, n) for n in LEAVES}}


@pytest.fixture(scope="module")
def jax_fused_run(tiny):
    """The JAX fused step (interpret mode), traced once: logprobs per chunk
    and the final state, for 2 streams over 4 chunks."""
    jc, _, jv, _ = tiny
    plan = JFE.prepare_fused_params(jv, jc)
    step = jax.jit(lambda v, p, a, s: JFE.apply_streaming_fused(v, p, jc, a, s, block_b=2,
                                                                interpret=True))
    wav = audio(2400 * N_CHUNKS, 2, seed=11)
    state = JM.init_streaming_state(jc, 2)
    logprobs = []
    for i in range(N_CHUNKS):
        lp, state = step(jv, plan, jnp.asarray(wav[:, i * 2400:(i + 1) * 2400]), state)
        logprobs.append(np.asarray(lp))
    final = {"preproc": state.preproc, **{n: getattr(state.encoder, n) for n in LEAVES}}
    return wav, logprobs, {k: np.asarray(v, np.float32) for k, v in final.items()}


def _port_runs(tc, tv, wav, fused_cfg=None):
    """(fused logprobs, eager logprobs, fused final state) of the port."""
    fused_cfg = fused_cfg or tc
    plan = TFE.prepare_fused_params(tv, fused_cfg, device="cpu")
    sf = TM.init_streaming_state(fused_cfg, 2)
    se = TM.init_streaming_state(fused_cfg, 2)
    fused, eager = [], []
    for i in range(N_CHUNKS):
        chunk = torch.from_numpy(wav[:, i * 2400:(i + 1) * 2400])
        lf, sf = TFE.apply_streaming_fused(tv, plan, fused_cfg, chunk, sf)
        le, se = TM.apply_streaming(tv, fused_cfg, chunk, se)
        fused.append(lf.numpy())
        eager.append(le.numpy())
    return fused, eager, sf, se


def test_fused_step_matches_jax_fused_and_port_eager(tiny, jax_fused_run):
    _, tc, _, tv = tiny
    wav, jax_lp, jax_state = jax_fused_run
    fused, eager, state, _ = _port_runs(tc, tv, wav)
    for i in range(N_CHUNKS):
        assert fused[i].shape == jax_lp[i].shape == (2, 10, tc.vocab_size_with_blank)
        assert np.abs(fused[i] - jax_lp[i]).max() < 0.05, i
        assert np.abs(fused[i] - eager[i]).max() < 0.1, i
    for name, got in _leaves(state).items():
        got = got.float().numpy()
        assert got.shape == jax_state[name].shape, name
        assert np.abs(got - jax_state[name]).max() < 0.1, name
    assert TFE.fused_conformer_layer.launches == 0


def test_fused_step_honours_emulate_reference_fp16(tiny):
    """The JAX package's fused step ignores the flag; the port quantises the waveform and
    the frontend carry to fp16 as its eager step does."""
    _, tc, _, tv = tiny
    wav = audio(2400 * N_CHUNKS, 2, seed=12)
    emu = dataclasses.replace(tc, emulate_reference_fp16=True)
    fused, eager, sf, se = _port_runs(tc, tv, wav, fused_cfg=emu)
    for i in range(N_CHUNKS):
        assert np.abs(fused[i] - eager[i]).max() < 0.1, i
    torch.testing.assert_close(sf.preproc, se.preproc, rtol=0, atol=0)
    carry = sf.preproc.float()
    assert torch.equal(carry, carry.to(torch.float16).float())


def test_fused_plan_follows_the_layer_statics(tiny):
    _, tc, _, tv = tiny
    plan = TFE.prepare_fused_params(tv, tc, device="cpu")
    got = [(w.t, w.window, w.recompute) for w in plan.layers]
    # tiny model: reduced layers 2-3, stateful layers 3-4, layer 1 reuses scores
    assert got == [(10, 0, True), (10, 0, False), (5, 0, True), (5, 15, True), (10, 30, True)]


def test_prepare_fused_params_needs_a_device(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    _, tc, _, tv = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFE.prepare_fused_params(tv, tc)
