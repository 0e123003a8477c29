"""The port's full-sequence forward (core/frontend.py ``log_mel_offline``,
core/layers.py ``mhsa_blocked``, core/encoder.py ``encoder_offline``,
core/model.py ``apply_offline``) against the JAX package on the same
numpy-made weights and audio.  The port has one attention path offline,
per-chunk blocks; the JAX package's two forms, blocked and masked (T, T),
are both its oracles.  The JAX blocked form takes only windows of whole
chunks, so the 400 ms geometry (chunk 13, window 30; reduced: chunk 6,
window 15) is held to the masked form.

Tolerances:
* frontend and blocked attention, float32: 1e-5 on features, outputs and
  scores;
* ``apply_offline`` float32: 1e-4 on logprobs (tests/test_model_core.py's
  streaming-vs-offline bound), output lengths equal;
* bf16 against the JAX default: 0.05 on logprobs (the streaming step's
  bound, tests/test_torch_model.py);
* the 400 ms geometry against the JAX masked form: the bounds above,
  1e-4 in float32 and 0.05 in bf16 on logprobs; in train mode 1e-5 on the
  float32 statistics, 2e-2 relative on the bf16 ones
  (tests/test_torch_training.py's bf16 bound);
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
from tone_tpu.core import encoder as JE
from tone_tpu.core import layers as JL
from tone_tpu.core import model as JM
from tone_tpu_torch.bridge import tree_map
from tone_tpu_torch.core import frontend as TF
from tone_tpu_torch.core import layers as TL
from tone_tpu_torch.core import model as TM
from tone_tpu_torch.offline import OfflineTranscriber

N = 2400


@functools.lru_cache(maxsize=None)
def _models(dtype, chunk_ms=300):
    """The tiny model at 300 ms chunks (windows of whole chunks) or at 400 ms
    (chunk 13, window 30: a window of 2.3 chunks)."""
    jc, tc = (c.with_chunk_duration_ms(chunk_ms) for c in tiny_configs(dtype))
    jv, tv = tiny_variables_with_stats(jc, tc)
    return jc, tc, jv, tv


@functools.lru_cache(maxsize=None)
def _jax_offline(dtype, blocked, chunk_ms=300, training=False):
    jc, _, _, _ = _models(dtype, chunk_ms)
    return jax.jit(lambda v, a, n: JM.apply_offline(v, jc, a, n, training=training,
                                                    blocked_attention=blocked))


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


# The bounds of the port against the JAX package, by compute dtype: on
# logprobs, and on updated BatchNorm statistics.
LOGPROBS = {"float32": dict(atol=1e-4, rtol=0), "bfloat16": dict(atol=0.05, rtol=0)}
STATS = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-3, rtol=2e-2)}


def _jax_mhsa_masked(jp, x, lens, chunk, left_context, cached_scores):
    """The JAX package's ``mhsa`` under its offline (T, T) mask."""
    mask = JE._offline_att_mask(x.shape[1], chunk, left_context, lens)
    return JL.mhsa(jp, x, x, n_heads=4, rope_dim=8, k_offset=0, mask=mask,
                   cached_scores=cached_scores, compute_dtype=jnp.float32)


def _score_blocks(scores, t, chunk, left_context):
    """The (B, H, T, T) scores that the blocks (B, H, n, c, w + c) hold,
    gathered into the blocks' layout: (index into the blocks, values)."""
    n = -(-t // chunk)
    i, r, s = np.meshgrid(np.arange(n), np.arange(chunk), np.arange(left_context + chunk),
                          indexing="ij")
    row, col = i * chunk + r, i * chunk - left_context + s
    ok = (row < t) & (col >= 0) & (col < t)
    return (i[ok], r[ok], s[ok]), np.asarray(scores)[:, :, row[ok], col[ok]]


@pytest.mark.parametrize("t, chunk, left_context", [(40, 10, 0), (37, 10, 30), (23, 5, 15),
                                                    (45, 13, 30), (23, 6, 15), (37, 10, 25),
                                                    (30, 13, 4)])
def test_mhsa_blocked_matches_jax(t, chunk, left_context):
    """Output and score blocks, from q/k and reused as ``cached_scores``:
    against JAX's ``mhsa_blocked`` where the window is whole chunks, against
    its ``mhsa`` under the offline mask where it is not."""
    _, _, jv, tv = _models("float32")
    jp = jv["params"]["encoder"]["layers"][0]["att"]
    tp = tv["params"]["encoder"]["layers"][0]["att"]
    x = np.random.default_rng(t).normal(0.0, 1.0, (2, t, 64)).astype(np.float32)
    lens = np.array([t, t - 7], np.int32)
    kw = dict(n_heads=4, rope_dim=8, chunk=chunk, left_context=left_context)
    whole = left_context % chunk == 0

    def jax_attention(x, cached):
        if whole:
            return JL.mhsa_blocked(jp, jnp.asarray(x), lengths=jnp.asarray(lens),
                                   cached_scores=cached, compute_dtype=jnp.float32, **kw)
        return _jax_mhsa_masked(jp, jnp.asarray(x), jnp.asarray(lens), chunk, left_context,
                                cached)

    jy, js = jax_attention(x, None)
    ty, ts = TL.mhsa_blocked(tp, torch.from_numpy(x), lengths=torch.from_numpy(lens),
                             cached_scores=None, compute_dtype=torch.float32, **kw)
    assert tuple(ts.shape) == (2, 4, -(-t // chunk), chunk, left_context + chunk)
    if whole:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)
    else:
        at, want = _score_blocks(js, t, chunk, left_context)
        np.testing.assert_allclose(ts.numpy()[:, :, at[0], at[1], at[2]], want,
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    # a score-sharing layer reuses the blocks
    jy2, _ = jax_attention(x * 0.5, js)
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
        tv, tc, torch.from_numpy(wav), torch.from_numpy(lens) if with_lengths else None)
    return np.asarray(jlp), np.asarray(jlen), jstats, tlp.numpy(), tlen.numpy(), tstats


@pytest.mark.parametrize("jax_form", ["blocked", "masked"])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_apply_offline_fp32_matches_jax(jax_form, with_lengths):
    jlp, jlen, jstats, tlp, tlen, tstats = _run_both("float32", jax_form == "blocked",
                                                     with_lengths)
    assert tlp.shape == jlp.shape and tlp.dtype == np.float32
    np.testing.assert_array_equal(tlen, jlen)
    for row, n in enumerate(jlen):
        np.testing.assert_allclose(tlp[row, :n], jlp[row, :n], atol=1e-4, rtol=0)
    # inference: the running statistics come back as they went in
    for j, t in zip(jax.tree.leaves(jstats), jax.tree.leaves(tree_map(np.asarray, tstats))):
        np.testing.assert_array_equal(t, np.asarray(j))


@pytest.mark.parametrize("jax_form", ["blocked", "masked"])
def test_apply_offline_bf16_matches_jax_default(jax_form):
    jlp, jlen, _, tlp, tlen, _ = _run_both("bfloat16", jax_form == "blocked")
    np.testing.assert_array_equal(tlen, jlen)
    for row, n in enumerate(jlen):
        assert np.abs(tlp[row, :n] - jlp[row, :n]).max() < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_matches_masked_attention(dtype):
    """The 400 ms geometry, whose windows are not whole chunks: the port's
    blocked forward against the JAX package's masked one; float input taken
    as it is, int input scaled by 1/32767."""
    _, tc, jv, tv = _models(dtype, 400)
    wav, lens = _ragged_batch()
    for x in (wav, wav.astype(np.float32) / 32767.0):
        lp_m, len_m, _ = _jax_offline(dtype, False, 400)(jv, jnp.asarray(x), jnp.asarray(lens))
        lp_b, len_b, _ = TM.apply_offline(tv, tc, torch.from_numpy(x), torch.from_numpy(lens))
        np.testing.assert_array_equal(len_b.numpy(), np.asarray(len_m))
        for row, n in enumerate(len_b.tolist()):
            np.testing.assert_allclose(lp_b[row, :n].numpy(), np.asarray(lp_m)[row, :n],
                                       **LOGPROBS[dtype])


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
    """A training mesh is a ``ProcessMesh`` of ranks: a device mesh of the
    bulk and serving paths is refused.  ``apply_offline(training=True)``
    itself runs (the case below)."""
    from tone_tpu_torch.parallel.mesh import make_mesh
    from tone_tpu_torch.training import Trainer

    _, tc, _, _ = _models("float32")
    with pytest.raises(TypeError, match="ProcessMesh"):
        Trainer(tc, mesh=make_mesh(devices=["cpu"]), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_blocked_matches_masked_attention(dtype):
    """Training mode (batch statistics, no dropout key) at the 400 ms
    geometry: the port's blocked forward against the JAX package's masked
    one, logprobs and updated statistics, and the statistics differ from
    the running ones that went in."""
    _, tc, jv, tv = _models(dtype, 400)
    wav, lens = _ragged_batch()
    lp_m, _, st_m = _jax_offline(dtype, False, 400, True)(jv, jnp.asarray(wav),
                                                          jnp.asarray(lens))
    lp_b, len_b, st_b = TM.apply_offline(tv, tc, torch.from_numpy(wav), torch.from_numpy(lens),
                                         training=True)
    for row, n in enumerate(len_b.tolist()):
        np.testing.assert_allclose(lp_b[row, :n].detach().numpy(), np.asarray(lp_m)[row, :n],
                                   **LOGPROBS[dtype])
    for a, b, before in zip(jax.tree.leaves(tree_map(np.asarray, st_b)),
                            jax.tree.leaves(st_m),
                            jax.tree.leaves(tree_map(np.asarray, tv["batch_stats"]))):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **STATS[dtype])
        assert not np.array_equal(a, before)


def test_offline_transcriber_runs_the_400ms_geometry():
    """``OfflineTranscriber(use_offline_forward=True)`` on the 400 ms
    geometry: each call's logprobs are the JAX masked forward's on that call
    between the config's zero padding, padded to whole chunks (one call a
    batch, buckets of one chunk), within 1e-4; the calls transcribe."""
    jc, tc, jv, tv = _models("float32", 400)
    chunk = tc.audio_chunk_samples
    calls = [audio(n, seed=n) for n in (9000, 3000, 13_100)]
    tr = OfflineTranscriber(tv, tc, batch_size=1, bucket_samples=chunk,
                            use_offline_forward=True, device="cpu")
    for call, got in zip(calls, tr.logprobs(calls)):
        n_chunks = -(-(len(call) + 2 * tc.padding) // chunk)
        row = np.zeros((1, n_chunks * chunk), np.int32)
        row[0, tc.padding:tc.padding + len(call)] = call
        want, _, _ = _jax_offline("float32", False, 400)(jv, jnp.asarray(row), None)
        assert got.shape == (n_chunks * tc.encoder.chunk_size, want.shape[-1])
        np.testing.assert_allclose(got, np.asarray(want)[0, :got.shape[0]], atol=1e-4, rtol=0)
    assert len(tr.transcribe(calls)) == len(calls)
