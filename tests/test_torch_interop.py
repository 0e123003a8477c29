"""The port's interop (tone_tpu_torch/interop.py) against the JAX package's
(tone_tpu/interop.py): the reference-named state_dict, .safetensors and
.nemo files crossing between the two packages in both directions, the
reference config, and the hand-written YAML of the archive against
PyYAML."""

import math

import jax
import numpy as np
import pytest
import torch
import yaml

import tone_tpu.acoustic as JA
import tone_tpu.checkpoint as JC
import tone_tpu.config as jcfg
import tone_tpu.interop as JI
import tone_tpu_torch.acoustic as TA
import tone_tpu_torch.checkpoint as TC
import tone_tpu_torch.config as tcfg
import tone_tpu_torch.interop as TI
from test_torch_common import ARTIFACT_ENCODER, assert_trees_equal, tiny_configs, tiny_variables


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_configs("float32", ARTIFACT_ENCODER)
    jv, tv = tiny_variables(jc, tc, seed=5)
    return jc, tc, jv, tv


def _assert_state_dicts_equal(port, jax_sd):
    assert list(port) == list(jax_sd)
    for k, v in jax_sd.items():
        want = np.asarray(v)
        got = port[k]
        assert tuple(got.shape) == want.shape, k
        assert got.is_contiguous() and got.device.type == "cpu", k
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32), err_msg=k)
    assert port[next(k for k in port if k.endswith("num_batches_tracked"))].dtype == torch.int64


@pytest.mark.parametrize("variant", ["float32", "tone_prefix", "serving_cast"])
def test_to_torch_state_dict_matches_jax(tiny, variant):
    """Key for key in the reference naming, values bit-equal; serving
    variables (bf16 matrices, the merged ``lin12``) split back as in JAX."""
    jc, tc, jv, tv = tiny
    prefix = "tone." if variant == "tone_prefix" else ""
    if variant == "serving_cast":
        jc, tc = tiny_configs("bfloat16", ARTIFACT_ENCODER)
        jv = JA.cast_params_for_inference(jv, jc)
        tv = TA.cast_params_for_inference(tv, tc)
        assert "lin12" in tv["params"]["encoder"]["layers"][0]["ff1"]
    _assert_state_dicts_equal(TI.to_torch_state_dict(tv, tc, prefix),
                              JI.to_torch_state_dict(jax.tree.map(np.asarray, jv), jc, prefix))


def test_round_trip_is_exact(tiny):
    _, tc, _, tv = tiny
    assert_trees_equal(TC.convert_torch_state_dict(TI.to_torch_state_dict(tv, tc), tc), tv)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_safetensors_cross_packages(tmp_path, tiny, direction):
    jc, tc, jv, tv = tiny
    path = tmp_path / "model.safetensors"
    if direction == "port_to_jax":
        TI.save_torch_checkpoint(path, tv, tc, prefix="tone.")
    else:
        JI.save_torch_checkpoint(path, jax.tree.map(np.asarray, jv), jc, prefix="tone.")
    assert_trees_equal(JC.load_torch_checkpoint(path, jc), jv)
    assert_trees_equal(TC.load_torch_checkpoint(path, tc), tv)


@pytest.mark.parametrize("case", ["default", "artifact", "chunk_600ms"])
def test_reference_config_matches_jax(case):
    if case == "default":
        jc, tc = jcfg.ToneConfig(), tcfg.ToneConfig()
    elif case == "artifact":
        jc, tc = tiny_configs("float32", ARTIFACT_ENCODER)
    else:
        jc = jcfg.ToneConfig().with_chunk_duration_ms(600)
        tc = tcfg.ToneConfig().with_chunk_duration_ms(600)
    ref = TI.to_reference_config(tc)
    assert ref == JI.to_reference_config(jc)
    back = TI.from_reference_config(ref)
    assert back.to_dict() == JI.from_reference_config(ref).to_dict()
    assert back.encoder == tc.encoder and back.frontend == tc.frontend


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_nemo_archive_cross_packages(tmp_path, tiny, direction):
    """A .nemo written by either package loads in both, the same weights and
    the same config."""
    jc, tc, jv, tv = tiny
    path = tmp_path / "model.nemo"
    if direction == "port_to_jax":
        TI.save_nemo_archive(path, tv, tc)
    else:
        JI.save_nemo_archive(path, jax.tree.map(np.asarray, jv), jc)
    jax_vars, jax_cfg = JI.load_nemo_archive(path)
    port_vars, port_cfg = TI.load_nemo_archive(path)
    assert port_cfg.to_dict() == jax_cfg.to_dict()
    assert port_cfg.encoder == tc.encoder
    assert_trees_equal(port_vars, tv)
    assert_trees_equal(jax_vars, jv)


def test_nemo_archive_of_serving_variables(tmp_path):
    """A serving model's variables (bf16 matrices, merged ``lin12``) go into
    the archive as a float32 state_dict, and load back to the same model."""
    import io
    import tarfile

    jc, tc = tiny_configs("bfloat16", ARTIFACT_ENCODER)
    _, tv = tiny_variables(jc, tc, seed=13)
    model = TA.StreamingCTCModel(tv, tc, device="cpu")
    TI.save_nemo_archive(tmp_path / "m.nemo", model.variables, tc)
    with tarfile.open(tmp_path / "m.nemo", "r:gz") as tar:
        raw = tar.extractfile("./model_weights.ckpt").read()
    sd = torch.load(io.BytesIO(raw), weights_only=True)
    assert {v.dtype for v in sd.values()} == {torch.float32, torch.int64}
    variables, config = TI.load_nemo_archive(tmp_path / "m.nemo")
    assert config.encoder == tc.encoder
    assert_trees_equal(TA.StreamingCTCModel(variables, tc, device="cpu").variables,
                       model.variables)


def _nemo_cfg(config):
    return {"tone_config": TI.to_reference_config(config),
            "decoding": {"strategy": "greedy"},
            "target": "tone.nemo_wrapper.ToneCTCNemoModel"}


SCALARS = {
    "small": 1e-05, "tenth": 0.1, "big": 1e20, "one": 1.0, "inf": math.inf, "ninf": -math.inf,
    "none": None, "empty": "", "yes_word": "yes", "digit_str": "1", "float_str": "1.5",
    "nested": [[1, 2], [3, [4, 5]], []], "empty_map": {}, "neg_zero": -0.0, "tiny": 3e-7,
    "long": 12345678.9, "apostrophe": "it's", "colon": "a: b", "dash_word": "-x",
    "dash_space": "- x", "lead_space": " lead", "hash": "x #y", "maps": [{"a": 1, "b": [1, 2]}],
    "cyrillic": "ёж", "tab": "tab\there", "date": "2020-01-01", "null_word": "null",
    "hex_str": "0x1F", "time_str": "1:30", "comma": "a,b", "at": "@x", "neg": -5,
    "flag": False, "7": "numeric key", "deep": {"a": {"b": [True, None]}}, "space": " ",
}


@pytest.mark.parametrize("case", ["default", "artifact", "scalars"])
def test_yaml_dump_equals_safe_dump(case):
    data = {"default": lambda: _nemo_cfg(tcfg.ToneConfig()),
            "artifact": lambda: _nemo_cfg(tiny_configs("float32", ARTIFACT_ENCODER)[1]),
            "scalars": lambda: SCALARS}[case]()
    text = TI.dump_yaml(data)
    assert text == yaml.safe_dump(data, sort_keys=False)
    assert yaml.safe_load(text) == data


@pytest.mark.parametrize("case", ["default", "artifact", "scalars"])
def test_yaml_reads_safe_dump(case):
    data = {"default": lambda: _nemo_cfg(tcfg.ToneConfig()),
            "artifact": lambda: _nemo_cfg(tiny_configs("float32", ARTIFACT_ENCODER)[1]),
            "scalars": lambda: SCALARS}[case]()
    assert TI.load_yaml(yaml.safe_dump(data, sort_keys=False)) == data
    if case == "default":  # the archive's vocabulary: \\uXXXX escapes, ' ' quoted
        text = TI.dump_yaml(data)
        assert '- "\\u0430"' in text and "- ' '" in text
