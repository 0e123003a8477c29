"""The port's checkpoint I/O (tone_tpu_torch/checkpoint.py) against the JAX
package's (tone_tpu/checkpoint.py): the reference-state_dict conversion,
the hand-written safetensors reader and writer against the safetensors
library, and the port's checkpoint directory."""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

import tone_tpu.checkpoint as JC
import tone_tpu.interop as JI
import tone_tpu_torch.checkpoint as TC
from test_torch_common import (
    ARTIFACT_ENCODER,
    assert_trees_equal,
    leaves_with_paths,
    tiny_configs,
    tiny_variables,
)
from tone_tpu_torch.acoustic import StreamingCTCModel


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_configs("float32", ARTIFACT_ENCODER)
    jv, tv = tiny_variables(jc, tc, seed=3)
    return jc, tc, jv, tv


@pytest.mark.parametrize("variant", ["numpy", "tone_prefix", "torch_values"])
def test_convert_matches_jax(tiny, variant):
    """The port's tree equals JAX's leaf for leaf, bit-exact in float32, for
    a bare or ``tone.``-prefixed state_dict of numpy or torch values."""
    jc, tc, jv, _ = tiny
    sd = JI.to_torch_state_dict(jax.tree.map(np.asarray, jv), jc,
                                prefix="tone." if variant == "tone_prefix" else "")
    ported = sd
    if variant == "torch_values":
        ported = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    out = TC.convert_torch_state_dict(ported, tc)
    assert_trees_equal(out, JC.convert_torch_state_dict(sd, jc))
    assert all(leaf.dtype == torch.float32 for _, leaf in leaves_with_paths(out))


def test_convert_reads_qk_only_where_scores_are_computed(tiny):
    """Layer 1 reuses layer 0's scores: it has no q/k leaves, as in JAX."""
    jc, tc, jv, _ = tiny
    sd = JI.to_torch_state_dict(jax.tree.map(np.asarray, jv), jc)
    layers = TC.convert_torch_state_dict(sd, tc)["params"]["encoder"]["layers"]
    assert ["linear_q" in layer["att"] for layer in layers] == [True, False, True, True]


def _library_file(path, seed=0):
    rng = np.random.default_rng(seed)
    tensors = {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f16": rng.standard_normal(5).astype(np.float16),
        "bf16": rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16),
        "i64": np.array([-(2**40), 0, 7], np.int64),
        "scalar": np.array(7, np.int64),
        "empty": np.zeros((0, 4), np.float32),
    }
    save_file(tensors, str(path), metadata={"format": "pt", "note": "seeded"})
    return tensors


@pytest.mark.parametrize("name", ["f32", "f16", "bf16", "i64", "scalar", "empty"])
def test_reader_reads_library_files(tmp_path, name):
    tensors = _library_file(tmp_path / "x.safetensors")
    got = TC.read_safetensors(tmp_path / "x.safetensors")
    assert set(got) == set(tensors)  # __metadata__ is skipped
    want = tensors[name]
    t = got[name]
    assert tuple(t.shape) == want.shape
    assert t.dtype == {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16,
                       "i64": torch.int64, "scalar": torch.int64, "empty": torch.float32}[name]
    if name == "bf16":
        np.testing.assert_array_equal(t.float().numpy(), want.astype(np.float32))
    else:
        np.testing.assert_array_equal(t.numpy(), want)


def test_library_reads_port_writer(tmp_path):
    rng = np.random.default_rng(1)
    tensors = {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
               "h": torch.from_numpy(rng.standard_normal(6).astype(np.float16)),
               "b": torch.from_numpy(rng.standard_normal((2, 2)).astype(np.float32)).bfloat16(),
               "n": torch.tensor(0, dtype=torch.int64),
               "t": torch.arange(12, dtype=torch.float32).reshape(3, 4).t()}  # not contiguous
    TC.write_safetensors(tensors, tmp_path / "y.safetensors", metadata={"format": "pt"})
    back = load_file(str(tmp_path / "y.safetensors"))
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        np.testing.assert_array_equal(back[k].astype(np.float32), v.float().numpy(), err_msg=k)
    assert back["b"].dtype == ml_dtypes.bfloat16 and back["n"].dtype == np.int64
    raw = (tmp_path / "y.safetensors").read_bytes()
    assert (8 + int.from_bytes(raw[:8], "little")) % 8 == 0  # header padded to 8 bytes


@pytest.mark.parametrize("fault", ["gap", "overlap", "trailing", "dtype"])
def test_reader_refuses_malformed_offsets(tmp_path, fault):
    """Byte ranges must tile the data from 0 to the end, as the library's
    reader demands."""
    header = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
              "b": {"dtype": "F32", "shape": [1], "data_offsets": [8, 12]}}
    body = bytes(12)
    if fault == "gap":
        header["b"]["data_offsets"] = [12, 16]
        body = bytes(16)
    elif fault == "overlap":
        header["b"]["data_offsets"] = [4, 8]
    elif fault == "trailing":
        body = bytes(16)
    else:
        header["b"]["dtype"] = "U8"
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    path = tmp_path / "bad.safetensors"
    path.write_bytes(len(text).to_bytes(8, "little") + text + body)
    with pytest.raises(ValueError):
        TC.read_safetensors(path)


@pytest.mark.parametrize("suffix", [".safetensors", ".bin", ".pt"])
def test_load_torch_checkpoint_matches_jax(tmp_path, tiny, suffix):
    jc, tc, jv, _ = tiny
    path = tmp_path / f"model{suffix}"
    if suffix == ".safetensors":
        JI.save_torch_checkpoint(path, jax.tree.map(np.asarray, jv), jc, prefix="tone.")
    else:
        sd = JI.to_torch_state_dict(jax.tree.map(np.asarray, jv), jc)
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    assert_trees_equal(TC.load_torch_checkpoint(path, tc), JC.load_torch_checkpoint(path, jc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_native_directory_round_trip(tmp_path, dtype):
    """save_checkpoint writes config.json (as JAX writes it) and
    variables.safetensors; load_checkpoint gives the model back to the bit,
    including a serving model's bf16 matrices and merged ``lin12``."""
    jc, tc = tiny_configs(dtype, ARTIFACT_ENCODER)
    _, tv = tiny_variables(jc, tc, seed=4)
    model = StreamingCTCModel(tv, tc, device="cpu")
    TC.save_checkpoint(tmp_path / "model", model.variables, tc)
    assert sorted(p.name for p in (tmp_path / "model").iterdir()) == [
        "config.json", "variables.safetensors"]
    variables, stored = TC.load_checkpoint(tmp_path / "model")
    assert stored == tc
    assert_trees_equal(StreamingCTCModel(variables, stored, device="cpu").variables,
                       model.variables)
    assert ((tmp_path / "model" / "config.json").read_text()
            == json.dumps(jc.to_dict(), indent=2))


def test_jax_orbax_directory_raises(tmp_path, tiny):
    """A JAX checkpoint directory (orbax) is refused with the way across."""
    jc, tc, jv, tv = tiny
    JC.save_checkpoint(tmp_path / "jax_model", jv, jc)
    with pytest.raises(ValueError, match="tone_tpu.interop.save_torch_checkpoint"):
        TC.load_checkpoint(tmp_path / "jax_model")
    TC.save_checkpoint(tmp_path / "port_model", tv, tc)
    assert ((tmp_path / "port_model" / "config.json").read_text()
            == (tmp_path / "jax_model" / "config.json").read_text())
    with pytest.raises(FileNotFoundError):
        TC.load_checkpoint(tmp_path)
