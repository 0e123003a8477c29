"""The port's ONNX importer (tone_tpu_torch/onnx_import.py) against the JAX
package's (tone_tpu/onnx_import.py) on ``ModelProto`` bytes written here by
a small protobuf writer: the weights of the tiny model laid out as a torch
export lays them out (direct-named initializers, ``onnx::MatMul_N``
transposes consumed by scoped MatMul nodes, Identity/Cast chains, Gemm with
and without ``transB``, convolutions whose BatchNorm was folded away), in
raw float32, float16 and bfloat16, packed ``float_data`` and int64 varints.
(tests/test_onnx_import.py needs the reference's exported model.)"""

import struct

import jax
import ml_dtypes
import numpy as np
import pytest

import tone_tpu.interop as JI
import tone_tpu.onnx_import as JO
import tone_tpu_torch.onnx_import as TO
from test_torch_common import ARTIFACT_ENCODER, assert_trees_equal, tiny_configs, tiny_variables

# ---------------------------------------------------------------------------
# A protobuf writer for the three ONNX messages the importer reads.
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _bytes_field(number: int, payload: bytes) -> bytes:
    return _field(number, 2) + _varint(len(payload)) + payload


def _int_field(number: int, value: int) -> bytes:
    return _field(number, 0) + _varint(value)


ONNX_FLOAT, ONNX_INT64, ONNX_FLOAT16, ONNX_BFLOAT16 = 1, 7, 10, 16


def tensor_proto(name: str, arr: np.ndarray, encoding: str, packed_dims: bool = True) -> bytes:
    """A TensorProto of ``arr`` as ``encoding``: raw_f32, raw_f16, raw_bf16,
    float_data (packed) or int64 (packed varints)."""
    if packed_dims:
        out = _bytes_field(1, b"".join(_varint(d) for d in arr.shape))
    else:
        out = b"".join(_int_field(1, d) for d in arr.shape)
    if encoding == "int64":
        out += _int_field(2, ONNX_INT64)
        out += _bytes_field(7, b"".join(_varint(int(v)) for v in arr.reshape(-1)))
    elif encoding == "float_data":
        out += _int_field(2, ONNX_FLOAT)
        out += _bytes_field(4, arr.astype("<f4").tobytes())
    else:
        code, dtype = {"raw_f32": (ONNX_FLOAT, "<f4"), "raw_f16": (ONNX_FLOAT16, "<f2"),
                       "raw_bf16": (ONNX_BFLOAT16, ml_dtypes.bfloat16)}[encoding]
        out += _int_field(2, code)
        out += _bytes_field(9, np.ascontiguousarray(arr.astype(dtype)).tobytes())
    return out + _bytes_field(8, name.encode())


def node_proto(inputs, outputs, name: str, op: str, ints: dict | None = None,
               floats: dict | None = None) -> bytes:
    out = b"".join(_bytes_field(1, i.encode()) for i in inputs)
    out += b"".join(_bytes_field(2, o.encode()) for o in outputs)
    out += _bytes_field(3, name.encode()) + _bytes_field(4, op.encode())
    for key, value in (ints or {}).items():
        out += _bytes_field(5, _bytes_field(1, key.encode()) + _int_field(3, value))
    for key, value in (floats or {}).items():
        out += _bytes_field(5, _bytes_field(1, key.encode()) + _field(2, 5)
                            + struct.pack("<f", value))
    return out


def model_proto(nodes: list[bytes], initializers: list[bytes]) -> bytes:
    graph = b"".join(_bytes_field(1, n) for n in nodes)
    graph += b"".join(_bytes_field(5, t) for t in initializers)
    # ir_version and a producer name before the graph, as exporters write them
    return _int_field(1, 8) + _bytes_field(2, b"pytorch") + _bytes_field(7, graph)


LINEAR_SUFFIXES = ("linear1", "linearv", "linear2", "linear_q", "linear_k", "linear_v",
                   "linear_out", "pre_encode.out")
ENCODINGS = ("raw_f32", "raw_f32", "float_data", "raw_f16", "raw_f32", "raw_bf16")


def onnx_from_state_dict(sd: dict[str, np.ndarray]) -> bytes:
    """The tiny model's state_dict as a torch export lays it out, with the
    BatchNorms folded away (the importer synthesizes identities)."""
    nodes, inits = [], []
    counter = iter(range(1000, 10**6))
    modules = sorted({k.rsplit(".", 1)[0] for k in sd})
    for i, mod in enumerate(modules):
        enc = ENCODINGS[i % len(ENCODINGS)]
        weight, bias = sd.get(f"{mod}.weight"), sd.get(f"{mod}.bias")
        scope = "/_model/" + mod.replace(".", "/")
        if ".layers." in mod:  # torch scopes list items as "layers.N"
            head, tail = mod.split(".layers.", 1)
            n, rest = tail.split(".", 1)
            scope = "/_model/" + head.replace(".", "/") + f"/layers.{n}/" + rest.replace(".", "/")
        if mod.endswith("batch_norm") or mod.endswith("conv.0.1") or mod.endswith("conv.1.1"):
            continue  # folded into the convolution before it
        if mod.startswith("encoder.pre_encode.conv."):
            # nested containers scope overlappingly: /pre_encode/conv.0/conv.0.0/Conv
            k = mod.split(".")[3]
            scope = f"/_model/encoder/pre_encode/conv.{k}/conv.{k}.0"
        if mod.endswith(LINEAR_SUFFIXES):
            w_name = f"onnx::MatMul_{next(counter)}"
            if i % 6 == 1 and bias is not None:  # Gemm, transB=1: torch's (out, in) layout
                b_name = f"onnx::Gemm_{next(counter)}"
                inits += [tensor_proto(w_name, weight, enc), tensor_proto(b_name, bias, "raw_f32")]
                nodes.append(node_proto([f"{scope}/x_output_0", w_name, b_name], [f"{scope}/y"],
                                        f"{scope}/Gemm", "Gemm", ints={"transB": 1},
                                        floats={"alpha": 1.0}))
                continue
            if i % 6 == 4 and bias is not None:  # Gemm without transB: the weight as (in, out)
                b_name = f"onnx::Gemm_{next(counter)}"
                inits += [tensor_proto(w_name, weight.T, enc),
                          tensor_proto(b_name, bias, "float_data")]
                nodes.append(node_proto([f"{scope}/x_output_0", w_name, b_name], [f"{scope}/y"],
                                        f"{scope}/Gemm", "Gemm"))
                continue
            inits.append(tensor_proto(w_name, np.ascontiguousarray(weight.T), enc,
                                      packed_dims=i % 2 == 0))
            edge = w_name
            if i % 4 == 3:  # through Identity and Cast nodes
                nodes.append(node_proto([w_name], [f"{scope}/Cast_output_0"], f"{scope}/Cast",
                                        "Cast", ints={"to": 1}))
                nodes.append(node_proto([f"{scope}/Cast_output_0"], [f"{scope}/Identity_output_0"],
                                        f"{scope}/Identity", "Identity"))
                edge = f"{scope}/Identity_output_0"
            nodes.append(node_proto([f"{scope}/x_output_0", edge], [f"{scope}/MatMul_output_0"],
                                    f"{scope}/MatMul", "MatMul"))
            if bias is not None:
                inits.append(tensor_proto(f"_model.{mod}.bias", bias, "raw_f32"))
        elif weight is not None and weight.ndim >= 3:  # convolutions
            w_name, b_name = f"onnx::Conv_{next(counter)}", f"onnx::Conv_{next(counter)}"
            inits.append(tensor_proto(w_name, weight, enc))
            ins = [f"{scope}/x_output_0", w_name]
            if bias is not None:
                inits.append(tensor_proto(b_name, bias, "raw_f32"))
                ins.append(b_name)
            nodes.append(node_proto(ins, [f"{scope}/Conv_output_0"], f"{scope}/Conv", "Conv"))
        elif mod == "encoder.pre_encode.out_norm":
            # a parameter routed through an Identity whose edge keeps its name
            src = f"onnx::Identity_{next(counter)}"
            inits.append(tensor_proto(src, weight, enc))
            edge = f"_model.{mod}.weight"
            nodes.append(node_proto([src], [edge], f"{scope}/Identity", "Identity"))
            nodes.append(node_proto([f"{scope}/x_output_0", edge], [f"{scope}/Mul_output_0"],
                                    f"{scope}/Mul", "Mul"))
        else:  # norms keep their parameter names
            for key in ("weight", "bias"):
                if f"{mod}.{key}" in sd:
                    inits.append(tensor_proto(f"_model.{mod}.{key}", sd[f"{mod}.{key}"], enc))
    inits.append(tensor_proto("onnx::Reshape_7", np.array([-1, 4, 2**40], np.int64), "int64"))
    return model_proto(nodes, inits)


@pytest.fixture(scope="module")
def onnx_file(tmp_path_factory):
    jc, tc = tiny_configs("float32", ARTIFACT_ENCODER)
    jv, _ = tiny_variables(jc, tc, seed=6)
    sd = JI.to_torch_state_dict(jax.tree.map(np.asarray, jv), jc)
    path = tmp_path_factory.mktemp("onnx") / "model.onnx"
    path.write_bytes(onnx_from_state_dict(sd))
    return path, jc, tc, sd


def test_parse_graph_matches_jax(onnx_file):
    path = onnx_file[0]
    j_inits, j_nodes = JO.parse_onnx_graph(path)
    t_inits, t_nodes = TO.parse_onnx_graph(path)
    assert t_nodes == j_nodes
    assert list(t_inits) == list(j_inits)
    for k in j_inits:
        assert t_inits[k].dtype == j_inits[k].dtype, k
        np.testing.assert_array_equal(t_inits[k], j_inits[k], err_msg=k)
    np.testing.assert_array_equal(t_inits["onnx::Reshape_7"], [-1, 4, 2**40])
    assert {n["op"] for n in t_nodes} >= {"MatMul", "Gemm", "Conv", "Identity", "Cast", "Mul"}
    gemm = next(n for n in t_nodes if n["op"] == "Gemm" and n["attrs"])
    assert gemm["attrs"] == {"transB": 1, "alpha": 1.0}


def test_state_dict_matches_jax(onnx_file):
    path, _, _, sd = onnx_file
    j_sd = JO.load_onnx_state_dict(path)
    t_sd = TO.load_onnx_state_dict(path)
    assert sorted(t_sd) == sorted(j_sd)
    for k in j_sd:
        np.testing.assert_array_equal(t_sd[k], j_sd[k], err_msg=k)
    # every non-BatchNorm parameter is recovered
    wanted = {k for k in sd if "batch_norm" not in k and ".conv.0.1." not in k
              and ".conv.1.1." not in k}
    assert wanted <= set(t_sd)


def test_checkpoint_matches_jax(onnx_file):
    """The port's variables equal JAX's leaf for leaf, bit-exact; the
    float32-encoded weights equal the originals."""
    path, jc, tc, sd = onnx_file
    port = TO.load_onnx_checkpoint(path, tc)
    assert_trees_equal(port, JO.load_onnx_checkpoint(path, jc))
    bn = port["batch_stats"]["layers"][0]["conv_bn"]
    np.testing.assert_array_equal(bn["var"].numpy(), np.full(64, 1 - 1e-5, np.float32))


def test_external_data_raises(tmp_path):
    tensor = tensor_proto("w", np.zeros(2, np.float32), "raw_f32")
    tensor += _bytes_field(13, _bytes_field(1, b"location") + _bytes_field(2, b"w.bin"))
    path = tmp_path / "ext.onnx"
    path.write_bytes(model_proto([], [tensor]))
    for module in (JO, TO):
        with pytest.raises(ValueError, match="external data"):
            module.parse_onnx_graph(path)
