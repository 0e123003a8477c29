"""ONNX acoustic-artifact importer (a copy of ``tone_tpu/onnx_import.py``,
converting into the port's variables).

The reference's published model artifact is ``model.onnx``
(reference tone/onnx_wrapper.py:60-77): a torch.onnx export of the ``Tone``
module (tone/scripts/export.py:460-525).  This module extracts the weight
initializers out of that protobuf and reassembles the torch ``state_dict``
naming so :func:`tone_tpu_torch.checkpoint.convert_torch_state_dict` can map
it onto the port's variables tree — i.e. the deployed reference artifact loads
directly into this framework, no torch checkpoint needed.

No ``onnx`` package is required: ONNX files are protobuf, and the three
message types we need (ModelProto -> GraphProto -> TensorProto/NodeProto)
are parsed with a ~80-line wire-format reader.

Two classes of initializer names occur in torch exports:

* Parameters referenced directly keep their module path
  (``_model.encoder.layers.0.norm_ff1.weight``) — mapped by stripping the
  export-wrapper prefix.
* Constant-folded parameters are renamed (``onnx::MatMul_2561``) — typically
  every ``nn.Linear`` weight, folded into its transpose.  These are
  recovered from the *scoped node names* torch emits
  (``/_model/encoder/layers.0/self_attn/linear_q/MatMul``): the consuming
  node's module path plus its op type identify the parameter and its layout.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Iterator

import numpy as np

__all__ = ["load_onnx_state_dict", "load_onnx_checkpoint", "parse_onnx_graph"]


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format reader.
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) for one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
_BFLOAT16 = 16


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    """TensorProto -> (name, ndarray)."""
    name = ""
    dims: list[int] = []
    dtype = 1
    raw = b""
    f32 = b""
    i32 = b""
    i64 = b""
    f64 = b""
    u64 = b""
    for field, wire, val in _fields(buf):
        if field == 1:  # dims (repeated int64; varint or packed)
            if wire == 0:
                dims.append(val)
            else:
                pos = 0
                while pos < len(val):
                    d, pos = _read_varint(val, pos)
                    dims.append(d)
        elif field == 2:
            dtype = val
        elif field == 4:
            f32 += val if wire == 2 else struct.pack("<f", struct.unpack("<f", val)[0])
        elif field == 5:
            i32 += val
        elif field == 7:
            i64 += val
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
        elif field == 10:
            f64 += val
        elif field == 11:
            u64 += val
        elif field == 13:
            raise ValueError(
                f"initializer {name or '?'} uses external data; "
                "re-export with all tensors embedded")
    shape = tuple(dims)
    if raw:
        if dtype == _BFLOAT16:
            arr = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = arr.view(np.float32).astype(np.float32)
        else:
            np_dtype = _DTYPES.get(dtype)
            if np_dtype is None:
                raise ValueError(f"unsupported tensor dtype {dtype} for {name}")
            arr = np.frombuffer(raw, np_dtype)
    elif f32:
        arr = np.frombuffer(f32, np.float32)
    elif i64:  # varint-packed int64
        out: list[int] = []
        pos = 0
        while pos < len(i64):
            v, pos = _read_varint(i64, pos)
            out.append(v - (1 << 64) if v >= (1 << 63) else v)
        arr = np.asarray(out, np.int64)
    elif i32:
        out = []
        pos = 0
        while pos < len(i32):
            v, pos = _read_varint(i32, pos)
            out.append(v)
        arr = np.asarray(out, np.uint64).astype(np.int64).astype(
            _DTYPES.get(dtype, np.int32))
    elif f64:
        arr = np.frombuffer(f64, np.float64)
    elif u64:
        out = []
        pos = 0
        while pos < len(u64):
            v, pos = _read_varint(u64, pos)
            out.append(v)
        arr = np.asarray(out, np.uint64)
    else:
        arr = np.zeros(0, np.float32)
    return name, arr.reshape(shape)


def _parse_node(buf: bytes) -> dict[str, Any]:
    node = {"inputs": [], "outputs": [], "name": "", "op": "", "attrs": {}}
    for field, _wire, val in _fields(buf):
        if field == 1:
            node["inputs"].append(val.decode("utf-8"))
        elif field == 2:
            node["outputs"].append(val.decode("utf-8"))
        elif field == 3:
            node["name"] = val.decode("utf-8")
        elif field == 4:
            node["op"] = val.decode("utf-8")
        elif field == 5:  # AttributeProto: keep ints/floats only
            aname, aval = "", None
            ints: list[int] = []
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    aname = v2.decode("utf-8")
                elif f2 == 2:
                    aval = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    aval = v2 - (1 << 64) if v2 >= (1 << 63) else v2
                elif f2 == 8:
                    if w2 == 0:
                        ints.append(v2)
                    else:
                        pos = 0
                        while pos < len(v2):
                            d, pos = _read_varint(v2, pos)
                            ints.append(d)
            node["attrs"][aname] = ints if ints else aval
    return node


def parse_onnx_graph(path: str | Path) -> tuple[dict[str, np.ndarray], list[dict]]:
    """Parse a .onnx file into (initializers, nodes)."""
    data = Path(path).read_bytes()
    graph = None
    for field, _wire, val in _fields(data):  # ModelProto
        if field == 7:
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")
    initializers: dict[str, np.ndarray] = {}
    nodes: list[dict] = []
    for field, _wire, val in _fields(graph):  # GraphProto
        if field == 5:
            name, arr = _parse_tensor(val)
            initializers[name] = arr
        elif field == 1:
            nodes.append(_parse_node(val))
    return initializers, nodes


# ---------------------------------------------------------------------------
# state_dict reconstruction.
# ---------------------------------------------------------------------------

_WRAPPER_PREFIXES = ("_model.", "model.", "tone.", "")


def _module_path(node_name: str) -> str:
    """'/_model/encoder/layers.0/self_attn/linear_q/MatMul' ->
    'encoder.layers.0.self_attn.linear_q'.

    Nested containers scope overlappingly ('/pre_encode/conv.0/conv.0.0/Conv'
    — the child component extends the parent); the parent is dropped so the
    path matches the state_dict naming ('pre_encode.conv.0.0')."""
    parts = [p for p in node_name.split("/") if p]
    if len(parts) < 2:
        return ""
    collapsed: list[str] = []
    for p in parts[:-1]:
        if collapsed and p.startswith(collapsed[-1] + "."):
            collapsed.pop()
        collapsed.append(p)
    path = ".".join(collapsed)
    for prefix in _WRAPPER_PREFIXES:
        if prefix and path.startswith(prefix):
            return path[len(prefix):]
    return path


def _strip_prefix(name: str) -> str:
    for prefix in _WRAPPER_PREFIXES:
        if prefix and name.startswith(prefix):
            return name[len(prefix):]
    return name


_PASSTHROUGH_OPS = ("Identity", "Cast", "CastLike")


def load_onnx_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """Extract a torch-style ``state_dict`` from an exported ONNX graph."""
    initializers, nodes = parse_onnx_graph(path)
    sd: dict[str, np.ndarray] = {}
    producer = {o: n for n in nodes for o in n["outputs"]}

    def resolve(edge: str, depth: int = 8) -> np.ndarray | None:
        """Follow Identity/Cast chains back to an initializer value."""
        for _ in range(depth):
            if edge in initializers:
                return initializers[edge]
            node = producer.get(edge)
            if node is None or node["op"] not in _PASSTHROUGH_OPS or not node["inputs"]:
                return None
            edge = node["inputs"][0]
        return None

    # Pass 1: initializers that kept their parameter names.
    for name, arr in initializers.items():
        if "::" in name or "." not in name:
            continue
        sd[_strip_prefix(name)] = arr

    # Pass 1.5: torch's exporter routes deduplicated parameters through
    # Identity nodes whose *edge name* is the parameter name; recover those.
    for node in nodes:
        for edge in node["inputs"]:
            if "::" in edge or "." not in edge or edge in initializers:
                continue
            if edge.endswith("_output_0") or "/" in edge:
                continue
            val = resolve(edge)
            if val is not None:
                sd.setdefault(_strip_prefix(edge), val)

    # Pass 2: recover constant-folded initializers from consuming nodes.
    for node in nodes:
        mod = _module_path(node["name"])
        if not mod:
            continue
        op = node["op"]
        ins = [resolve(i) for i in node["inputs"]]
        if op == "MatMul" and len(ins) == 2 and ins[1] is not None:
            # Folded nn.Linear: initializer is weight.T (in, out); store the
            # torch layout (out, in) so the standard converter applies.
            sd.setdefault(f"{mod}.weight", np.ascontiguousarray(ins[1].T))
        elif op == "Gemm" and len(ins) >= 2 and ins[1] is not None:
            w = ins[1]
            if not node["attrs"].get("transB", 0):
                w = np.ascontiguousarray(w.T)
            sd.setdefault(f"{mod}.weight", w)
            if len(ins) >= 3 and ins[2] is not None:
                sd.setdefault(f"{mod}.bias", ins[2])
        elif op == "Add" and len(ins) == 2:
            other = ins[1] if ins[1] is not None else ins[0]
            if other is not None and other.ndim <= 1:
                sd.setdefault(f"{mod}.bias", other.reshape(-1))
        elif op == "Conv" and len(ins) >= 2 and ins[1] is not None:
            sd.setdefault(f"{mod}.weight", ins[1])
            if len(ins) >= 3 and ins[2] is not None:
                sd.setdefault(f"{mod}.bias", ins[2])
        elif op == "BatchNormalization" and len(ins) >= 5:
            for key, arr in zip(("weight", "bias", "running_mean", "running_var"),
                                ins[1:5]):
                if arr is not None:
                    sd.setdefault(f"{mod}.{key}", arr)
        elif op == "LayerNormalization" and len(ins) >= 2:
            if ins[1] is not None:
                sd.setdefault(f"{mod}.weight", ins[1].reshape(-1))
            if len(ins) >= 3 and ins[2] is not None:
                sd.setdefault(f"{mod}.bias", ins[2].reshape(-1))
        elif op == "Mul" and len(ins) == 2:
            other = ins[1] if ins[1] is not None else ins[0]
            if other is not None and other.ndim >= 1 and other.size > 1:
                sd.setdefault(f"{mod}.weight", other.reshape(-1))

    return sd


_BN_EPS = 1e-5


def _synthesize_identity_bns(sd: dict[str, np.ndarray], config) -> None:
    """torch.onnx.export folds eval-mode BatchNorms into the preceding conv
    (the exported graph has no BatchNormalization nodes) — the imported conv
    weights are the *fused* ones, so the missing BN entries are synthesized
    as exact identities (var = 1 - eps cancels the eps in the BN formula)."""
    enc = config.encoder
    bn_channels = {
        "encoder.pre_encode.conv.0.1": enc.subsampling_conv_channels[0],
        "encoder.pre_encode.conv.1.1": enc.subsampling_conv_channels[1],
        **{f"encoder.layers.{i}.conv.batch_norm": enc.d_model
           for i in range(enc.n_layers)},
    }
    for name, c in bn_channels.items():
        if f"{name}.weight" in sd:
            continue
        sd[f"{name}.weight"] = np.ones(c, np.float32)
        sd[f"{name}.bias"] = np.zeros(c, np.float32)
        sd[f"{name}.running_mean"] = np.zeros(c, np.float32)
        sd[f"{name}.running_var"] = np.full(c, 1.0 - _BN_EPS, np.float32)


def load_onnx_checkpoint(path: str | Path, config=None):
    """Load the reference's exported ``model.onnx`` into the port's variables
    (``{"params", "batch_stats"}`` of float32 CPU tensors).  Counterpart of
    :func:`tone_tpu_torch.checkpoint.load_torch_checkpoint` for the deployed
    artifact (reference tone/onnx_wrapper.py:60-77)."""
    from tone_tpu_torch.checkpoint import convert_torch_state_dict
    from tone_tpu_torch.config import ToneConfig

    if config is None:
        config = ToneConfig()
    sd = load_onnx_state_dict(path)
    _synthesize_identity_bns(sd, config)
    try:
        return convert_torch_state_dict(sd, config)
    except KeyError as e:
        raise ValueError(
            f"{path}: could not reconstruct parameter {e} from the ONNX "
            "graph — the export may use an unsupported optimizer pass; "
            f"recovered {len(sd)} parameters") from e
