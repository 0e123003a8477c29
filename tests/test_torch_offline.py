"""The port's full-sequence forward (core/frontend.py ``log_mel_offline``,
core/layers.py ``mhsa_blocked``, core/encoder.py ``encoder_offline``,
core/model.py ``apply_offline``) against the JAX package on the same
numpy-made weights and audio.

Tolerances:
* frontend and blocked attention, float32: 1e-5 on features, outputs and
  scores;
* ``apply_offline`` float32: 1e-4 on logprobs (tests/test_model_core.py's
  streaming-vs-offline bound), output lengths equal;
* bf16 against the JAX default: 0.05 on logprobs (the streaming step's
  bound, tests/test_torch_model.py);
* the port's blocked against its masked attention: 2e-3
  (tests/test_encoder_blocked.py);
* the port's offline forward against its own chunked streaming step,
  float32: 1e-4 (tests/test_model_core.py:55's contract).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import audio, tiny_configs, tiny_variables_with_stats

from tone_tpu.core import frontend as JF
from tone_tpu.core import layers as JL
from tone_tpu.core import model as JM
from tone_tpu_torch.bridge import tree_map
from tone_tpu_torch.core import frontend as TF
from tone_tpu_torch.core import layers as TL
from tone_tpu_torch.core import model as TM

N = 2400


@functools.lru_cache(maxsize=None)
def _models(dtype):
    jc, tc = tiny_configs(dtype)
    jv, tv = tiny_variables_with_stats(jc, tc)
    return jc, tc, jv, tv


@functools.lru_cache(maxsize=None)
def _jax_offline(dtype, blocked):
    jc, _, _, _ = _models(dtype)
    return jax.jit(lambda v, a, n: JM.apply_offline(v, jc, a, n, blocked_attention=blocked))


def _ragged_batch():
    """Three rows, one full, one cut mid-chunk, one short; T not a chunk
    multiple."""
    wav = audio(N * 5 + 313, 3, seed=4)
    return wav, np.array([wav.shape[1], 9000, 3000], np.int32)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_log_mel_offline_matches_jax(with_lengths):
    jc, tc, _, _ = _models("float32")
    wav = audio(N * 3 + 77, 2, seed=1).astype(np.float32) / 32767.0
    lens = np.array([wav.shape[1], 5000], np.int32) if with_lengths else None
    jf, jl = JF.log_mel_offline(jnp.asarray(wav), None if lens is None else jnp.asarray(lens),
                                JF.get_frontend_constants(jc.frontend))
    tf, tl = TF.log_mel_offline(torch.from_numpy(wav),
                                None if lens is None else torch.from_numpy(lens),
                                TF.get_frontend_constants(tc.frontend, torch.device("cpu")))
    assert tuple(tf.shape) == jf.shape
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5, rtol=1e-6)
    if with_lengths:
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    else:
        assert tl is None and jl is None


@pytest.mark.parametrize("t, chunk, left_context", [(40, 10, 0), (37, 10, 30), (23, 5, 15)])
def test_mhsa_blocked_matches_jax(t, chunk, left_context):
    """Output and score blocks, from q/k and reused as ``cached_scores``."""
    _, _, jv, tv = _models("float32")
    jp = jv["params"]["encoder"]["layers"][0]["att"]
    tp = tv["params"]["encoder"]["layers"][0]["att"]
    x = np.random.default_rng(t).normal(0.0, 1.0, (2, t, 64)).astype(np.float32)
    lens = np.array([t, t - 7], np.int32)
    kw = dict(n_heads=4, rope_dim=8, chunk=chunk, left_context=left_context)
    jy, js = JL.mhsa_blocked(jp, jnp.asarray(x), lengths=jnp.asarray(lens),
                             cached_scores=None, compute_dtype=jnp.float32, **kw)
    ty, ts = TL.mhsa_blocked(tp, torch.from_numpy(x), lengths=torch.from_numpy(lens),
                             cached_scores=None, compute_dtype=torch.float32, **kw)
    assert tuple(ts.shape) == js.shape == (2, 4, -(-t // chunk), chunk, left_context + chunk)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    # a score-sharing layer reuses the blocks
    jy2, _ = JL.mhsa_blocked(jp, jnp.asarray(x) * 0.5, lengths=jnp.asarray(lens),
                             cached_scores=js, compute_dtype=jnp.float32, **kw)
    ty2, ts2 = TL.mhsa_blocked(tp, torch.from_numpy(x) * 0.5, lengths=torch.from_numpy(lens),
                               cached_scores=ts, compute_dtype=torch.float32, **kw)
    assert ts2 is ts
    np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), atol=1e-5, rtol=1e-5)


def _run_both(dtype, blocked, with_lengths=True):
    jc, tc, jv, tv = _models(dtype)
    wav, lens = _ragged_batch()
    jlp, jlen, jstats = _jax_offline(dtype, blocked)(
        jv, jnp.asarray(wav), jnp.asarray(lens) if with_lengths else None)
    tlp, tlen, tstats = TM.apply_offline(
        tv, tc, torch.from_numpy(wav), torch.from_numpy(lens) if with_lengths else None,
        blocked_attention=blocked)
    return np.asarray(jlp), np.asarray(jlen), jstats, tlp.numpy(), tlen.numpy(), tstats


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_apply_offline_fp32_matches_jax(blocked, with_lengths):
    jlp, jlen, jstats, tlp, tlen, tstats = _run_both("float32", blocked, with_lengths)
    assert tlp.shape == jlp.shape and tlp.dtype == np.float32
    np.testing.assert_array_equal(tlen, jlen)
    for row, n in enumerate(jlen):
        np.testing.assert_allclose(tlp[row, :n], jlp[row, :n], atol=1e-4, rtol=0)
    # inference: the running statistics come back as they went in
    for j, t in zip(jax.tree.leaves(jstats), jax.tree.leaves(tree_map(np.asarray, tstats))):
        np.testing.assert_array_equal(t, np.asarray(j))


@pytest.mark.parametrize("blocked", [True, False])
def test_apply_offline_bf16_matches_jax_default(blocked):
    jlp, jlen, _, tlp, tlen, _ = _run_both("bfloat16", blocked)
    np.testing.assert_array_equal(tlen, jlen)
    for row, n in enumerate(jlen):
        assert np.abs(tlp[row, :n] - jlp[row, :n]).max() < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_matches_masked_attention(dtype):
    """The port's two attention paths of the offline forward, as
    tests/test_encoder_blocked.py holds the JAX package's; float input
    taken as it is, int input scaled by 1/32767."""
    _, tc, _, tv = _models(dtype)
    wav, lens = _ragged_batch()
    for x in (torch.from_numpy(wav), torch.from_numpy(wav.astype(np.float32) / 32767.0)):
        lp_b, len_b, _ = TM.apply_offline(tv, tc, x, torch.from_numpy(lens))
        lp_m, len_m, _ = TM.apply_offline(tv, tc, x, torch.from_numpy(lens),
                                          blocked_attention=False)
        np.testing.assert_array_equal(len_b.numpy(), len_m.numpy())
        for row, n in enumerate(len_m.tolist()):
            np.testing.assert_allclose(lp_b[row, :n].numpy(), lp_m[row, :n].numpy(),
                                       atol=2e-3, rtol=1e-3)


def test_offline_forward_equals_chunked_streaming():
    """The central contract: the offline forward with chunk-simulating masks
    equals chunked streaming with carried state."""
    _, tc, _, tv = _models("float32")
    b, n_chunks = 2, 6
    wav = audio(N * n_chunks, b, seed=5)
    lp_off, out_len, _ = TM.apply_offline(tv, tc, torch.from_numpy(wav))
    state = TM.init_streaming_state(tc, b)
    outs = []
    for i in range(n_chunks):
        lp, state = TM.apply_streaming(tv, tc, torch.from_numpy(wav[:, i * N:(i + 1) * N]),
                                       state)
        outs.append(lp.numpy())
    assert out_len.tolist() == [n_chunks * tc.encoder.chunk_size] * b
    np.testing.assert_allclose(lp_off.numpy(), np.concatenate(outs, axis=1), atol=1e-4)


def test_training_raises():
    _, tc, _, tv = _models("float32")
    with pytest.raises(NotImplementedError, match="A13"):
        TM.apply_offline(tv, tc, torch.zeros(1, N, dtype=torch.int32), training=True)
