"""The port's streaming model (tone_tpu_torch/core, bridge, acoustic) against
the JAX package on the same weights and audio.

Tolerances:
* float32 step: 1e-4 on logprobs and on every state leaf, over 6 chunks
  (the 30-frame windows fill past their masks after 3);
* bf16 step against the JAX default (kernel off, so its gate is all-bf16
  while the port's gate follows the kernel's fp32 sigmoid, and bf16
  elementwise chains round at other places): 0.05 on logprobs and 0.1 on
  state leaves, a few bf16 ulps of values up to ~8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import audio, tiny_configs, tiny_variables

from tone_tpu.acoustic import StreamingCTCModel as JaxModel
from tone_tpu.acoustic import cast_params_for_inference as jax_cast
from tone_tpu.core import frontend as JF
from tone_tpu.core import model as JM
from tone_tpu_torch.acoustic import StreamingCTCModel
from tone_tpu_torch.acoustic import cast_params_for_inference as torch_cast
from tone_tpu_torch.bridge import tree_leaves
from tone_tpu_torch.config import ToneConfig
from tone_tpu_torch.core import frontend as TF
from tone_tpu_torch.core import model as TM

LEAVES = ("sub1", "sub2", "mhsa", "conv", "mhsa_len", "reduction")


def _state_errors(jstate, tstate):
    errs = {"preproc": np.abs(np.asarray(jstate.preproc, np.float32)
                              - tstate.preproc.float().numpy()).max()}
    for name in LEAVES:
        ref = np.asarray(getattr(jstate.encoder, name)).astype(np.float32)
        got = getattr(tstate.encoder, name).float().numpy()
        assert got.shape == ref.shape, name
        errs[name] = np.abs(ref - got).max()
    return errs


def _run_both(dtype, n_chunks, batch=2):
    jc, tc = tiny_configs(dtype)
    jv, tv = tiny_variables(jc, tc)
    jv, tv = jax_cast(jv, jc), torch_cast(tv, tc)
    step = jax.jit(lambda v, a, s: JM.apply_streaming(v, jc, a, s))
    wav = audio(2400 * n_chunks, batch)
    js, ts = JM.init_streaming_state(jc, batch), TM.init_streaming_state(tc, batch)
    out = []
    for i in range(n_chunks):
        chunk = wav[:, i * 2400:(i + 1) * 2400]
        jl, js = step(jv, jnp.asarray(chunk), js)
        tl, ts = TM.apply_streaming(tv, tc, torch.from_numpy(chunk), ts)
        out.append((np.asarray(jl), tl.numpy(), _state_errors(js, ts)))
    return out


def test_bridge_keeps_leaf_shapes_and_values():
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc)
    jleaves = jax.tree.leaves(jv)
    tleaves = tree_leaves(tv)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_port_init_has_the_reference_layout():
    jc, tc = tiny_configs()
    jv = JM.init_model_params(jax.random.PRNGKey(0), jc)
    tv = TM.init_model_params(torch.Generator().manual_seed(0), tc)
    jshapes = jax.tree.map(lambda x: x.shape, jv)
    tshapes = jax.tree.map(lambda x: tuple(x.shape), tv)
    assert jax.tree.structure(jshapes) == jax.tree.structure(tshapes)
    assert jax.tree.leaves(jshapes) == jax.tree.leaves(tshapes)


def test_full_width_param_count():
    cfg = ToneConfig()
    variables = TM.init_model_params(torch.Generator().manual_seed(0), cfg)
    n = sum(t.numel() for t in tree_leaves(variables["params"]))
    assert 70e6 < n < 73e6  # the reference's "T-one (71M)"
    assert cfg.flat_state_size == 219729


def test_frontend_features_and_carry():
    jc, tc = tiny_configs()
    jconst = JF.get_frontend_constants(jc.frontend)
    tconst = TF.get_frontend_constants(tc.frontend, torch.device("cpu"))
    wav = audio(2400 * 3, 2).astype(np.float32) / 32767.0
    jcarry = np.zeros((2, 80), np.float32)
    tcarry = torch.zeros(2, 80)
    for i in range(3):
        chunk = wav[:, i * 2400:(i + 1) * 2400]
        jf, jcarry = JF.log_mel_streaming(jnp.asarray(chunk), jnp.asarray(jcarry), jconst)
        tf, tcarry = TF.log_mel_streaming(torch.from_numpy(chunk), tcarry, tconst)
        assert tuple(tf.shape) == jf.shape == (2, 30, 64)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4, rtol=1e-5)
        np.testing.assert_array_equal(tcarry.numpy(), np.asarray(jcarry))


def test_streaming_fp32_matches_jax():
    for jl, tl, errs in _run_both("float32", n_chunks=6):
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
        assert max(errs.values()) < 1e-4, errs


def test_streaming_bf16_matches_jax_default():
    for jl, tl, errs in _run_both("bfloat16", n_chunks=6):
        assert np.abs(tl - jl).max() < 0.05
        assert max(errs.values()) < 0.1, errs


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_stream_moves_between_packages(direction):
    """Run 3 chunks in one package, pack the state into the fp16 blob,
    unpack it in the other and continue 3 chunks: the logprobs match a
    stream that stayed in the first package and went through the same blob."""
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc)
    wav = audio(2400 * 6, 2, seed=3)
    chunks = [wav[:, i * 2400:(i + 1) * 2400] for i in range(6)]
    jstep = jax.jit(lambda v, a, s: JM.apply_streaming(v, jc, a, s))

    def jax_run(state, cs):
        out = []
        for c in cs:
            lp, state = jstep(jv, jnp.asarray(c), state)
            out.append(np.asarray(lp))
        return out, state

    def port_run(state, cs):
        out = []
        for c in cs:
            lp, state = TM.apply_streaming(tv, tc, torch.from_numpy(c), state)
            out.append(lp.numpy())
        return out, state

    if direction == "jax_to_port":
        _, js = jax_run(JM.init_streaming_state(jc, 2), chunks[:3])
        blob = JM.pack_state(js, jc)
        ref, _ = jax_run(JM.unpack_state(blob, jc), chunks[3:])
        got, _ = port_run(TM.unpack_state(blob, tc), chunks[3:])
    else:
        _, ts = port_run(TM.init_streaming_state(tc, 2), chunks[:3])
        blob = TM.pack_state(ts, tc)
        ref, _ = port_run(TM.unpack_state(blob, tc), chunks[3:])
        got, _ = jax_run(JM.unpack_state(blob, jc), chunks[3:])
    assert blob.dtype == np.float16 and blob.shape == (2, tc.flat_state_size)
    np.testing.assert_allclose(np.concatenate(got, 1), np.concatenate(ref, 1), atol=1e-4)


def test_pack_state_matches_jax_blob():
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc)
    wav = audio(2400, 3, seed=4)
    _, js = jax.jit(lambda v, a, s: JM.apply_streaming(v, jc, a, s))(
        jv, jnp.asarray(wav), JM.init_streaming_state(jc, 3))
    _, ts = TM.apply_streaming(tv, tc, torch.from_numpy(wav), TM.init_streaming_state(tc, 3))
    np.testing.assert_allclose(TM.pack_state(ts, tc).astype(np.float32),
                               JM.pack_state(js, jc).astype(np.float32),
                               atol=1e-4, rtol=2e-3)  # one fp16 ulp


_BAD_CALLS = {
    "chunk_type": lambda: ([[0] * 2400], None),
    "chunk_shape": lambda: (np.zeros((1, 2400), np.int32), None),
    "chunk_dtype": lambda: (np.zeros((1, 2400, 1), np.int16), None),
    "chunk_range": lambda: (np.full((1, 2400, 1), 40000, np.int32), None),
    "state_type": lambda: (np.zeros((1, 2400, 1), np.int32), [0.0]),
    "state_shape": lambda: (np.zeros((1, 2400, 1), np.int32), np.zeros((1, 10), np.float16)),
    "state_dtype": lambda: (np.zeros((1, 2400, 1), np.int32),
                            np.zeros((1, 219729), np.float32)),
}


@pytest.fixture(scope="module")
def tiny_models():
    jc, tc = tiny_configs()
    jv, tv = tiny_variables(jc, tc)
    return JaxModel(jv, jc), StreamingCTCModel(tv, tc, device="cpu")


@pytest.mark.parametrize("case", sorted(_BAD_CALLS))
def test_forward_validation_errors_match_jax(tiny_models, case):
    jmodel, tmodel = tiny_models
    with pytest.raises((TypeError, ValueError)) as jerr:
        jmodel.forward(*_BAD_CALLS[case]())
    with pytest.raises((TypeError, ValueError)) as terr:
        tmodel.forward(*_BAD_CALLS[case]())
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


def test_forward_blob_roundtrip_leaves_caller_arrays_alone():
    """Full width, float32, one stream: ``forward`` with the flat blob equals
    ``forward_native`` on the unpacked state, and never mutates its inputs."""
    cfg = dataclasses.replace(ToneConfig(), compute_dtype="float32")
    variables = TM.init_model_params(torch.Generator().manual_seed(0), cfg)
    model = StreamingCTCModel(variables, cfg, device="cpu")
    wav = audio(4800, 1, seed=5)
    c1, c2 = wav[:, :2400, None].copy(), wav[:, 2400:, None].copy()
    lp1, blob = model.forward(c1)
    assert lp1.shape == (1, 10, 35) and lp1.dtype == np.float32
    assert blob.shape == (1, 219729) and blob.dtype == np.float16
    blob_before, c2_before = blob.copy(), c2.copy()
    lp2, _ = model.forward(c2, blob)
    np.testing.assert_array_equal(blob, blob_before)
    np.testing.assert_array_equal(c2, c2_before)
    ref, _ = model.forward_native(c2[:, :, 0], TM.unpack_state(blob, cfg))
    np.testing.assert_allclose(lp2, ref.numpy(), atol=1e-6)


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    jc, tc = tiny_configs()
    _, tv = tiny_variables(jc, tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingCTCModel(tv, tc)
