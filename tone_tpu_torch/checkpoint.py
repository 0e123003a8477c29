"""Checkpoint I/O (port of ``tone_tpu/checkpoint.py``): the reference's torch
checkpoints converted to the port's variables, and the port's own
checkpoint directory.

The converter maps the reference checkpoint naming (``Tone`` module tree,
tone/nn/model.py; HF ``ToneForCTC`` adds a ``tone.`` prefix,
tone/training/model_wrapper.py:134) onto the variables tree the port shares
with the JAX package.

Weight-layout conventions (see core/layers.py):
  * torch ``nn.Linear``  (out, in)         -> ours (in, out)       [transpose]
  * torch 1x1 ``Conv1d`` (out, in, 1)      -> ours (in, out)       [squeeze+T]
  * torch depthwise conv (out, in/g, k)    -> ours identical        [copy]
  * torch ``Conv2d``     (O, I, H, W)      -> ours identical        [copy]
  * LayerNorm weight/bias                  -> scale/bias
  * BatchNorm weight/bias                  -> params scale/bias;
    running_mean/var                       -> batch_stats mean/var

``.safetensors`` files are read and written by this module itself
(``read_safetensors``, ``write_safetensors``), so the port needs no
``safetensors`` package.  The port's checkpoint directory holds
``config.json`` (``ToneConfig.to_dict``, as the JAX package writes it) and
``variables.safetensors`` in the reference naming; the JAX package's orbax
directories are not read here (ROADMAP §C).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from tone_tpu_torch.bridge import tree_map
from tone_tpu_torch.config import ToneConfig

Params = dict[str, Any]

VARIABLES_FILE = "variables.safetensors"


# ---------------------------------------------------------------------------
# The safetensors format: an 8-byte little-endian header length, a JSON
# header {name: {"dtype", "shape", "data_offsets": [begin, end]}} (plus an
# optional "__metadata__" of strings) padded with spaces to 8 bytes, then
# the tensors' bytes back to back.
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}
_NP_VIEW = {torch.float32: np.float32, torch.float16: np.float16,
            torch.bfloat16: np.uint16, torch.int64: np.int64}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU.  The tensors'
    byte ranges must follow one another from offset 0 to the end of the file
    with no gap or overlap, as the format's own reader demands."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    n = int.from_bytes(data[:8], "little")
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes runs past the end of the file")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    entries = sorted(((k, v) for k, v in header.items() if k != "__metadata__"),
                     key=lambda kv: tuple(kv[1]["data_offsets"]))
    out: dict[str, torch.Tensor] = {}
    end = 0
    for name, info in entries:
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        begin, stop = info["data_offsets"]
        shape = [int(s) for s in info["shape"]]
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        if begin != end or stop - begin != nbytes:
            raise ValueError(f"{path}: tensor {name} at bytes [{begin}, {stop}) does not "
                             f"follow byte {end} with its {nbytes} bytes")
        end = stop
        arr = np.frombuffer(body[begin:stop], dtype=_NP_VIEW[dtype]).copy()
        out[name] = torch.from_numpy(arr).view(dtype).reshape(shape)
    if end != len(body):
        raise ValueError(f"{path}: {len(body) - end} bytes after the last tensor")
    return out


def write_safetensors(tensors: Mapping[str, Any], path: str | Path,
                      metadata: Mapping[str, str] | None = None) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays of float32, float16,
    bfloat16 or int64) as a ``.safetensors`` file, in name order."""
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        t = torch.as_tensor(t) if not isinstance(t, torch.Tensor) else t
        t = t.detach().cpu().contiguous()
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name}: dtype {t.dtype} is not written")
        blob = t.view(_view_dtype(t.dtype)).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def _view_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int16 if dtype == torch.bfloat16 else dtype


# ---------------------------------------------------------------------------
# torch state_dict -> the port's variables.
# ---------------------------------------------------------------------------


def _t(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.T)


def _lin(sd: Mapping[str, np.ndarray], name: str, bias: bool = True) -> Params:
    p = {"w": _t(sd[f"{name}.weight"])}
    if bias and f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _pw_conv1d(sd: Mapping[str, np.ndarray], name: str) -> Params:
    """1x1 conv1d as a linear: (out, in, 1) -> (in, out)."""
    p = {"w": _t(sd[f"{name}.weight"][:, :, 0])}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _conv(sd: Mapping[str, np.ndarray], name: str) -> Params:
    p = {"w": sd[f"{name}.weight"]}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _ln(sd: Mapping[str, np.ndarray], name: str) -> Params:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _rms(sd: Mapping[str, np.ndarray], name: str) -> Params:
    return {"weight": sd[f"{name}.weight"]}


def _bn(sd: Mapping[str, np.ndarray], name: str) -> tuple[Params, Params]:
    params = {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}
    stats = {"mean": sd[f"{name}.running_mean"], "var": sd[f"{name}.running_var"]}
    return params, stats


def _float32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


def convert_torch_state_dict(state_dict: Mapping[str, Any],
                             config: ToneConfig | None = None) -> dict[str, Params]:
    """Convert a reference torch ``state_dict`` to the port's variables.

    Accepts either a bare ``Tone`` state_dict or an HF ``ToneForCTC`` one
    (keys prefixed with ``tone.``).  Values may be torch tensors (any float
    dtype) or numpy arrays.  A layer's q/k projections and norms are read
    only where ``config.encoder.should_recompute_att_scores`` says the layer
    computes its scores.

    Returns:
        ``{"params": ..., "batch_stats": ...}`` of float32 CPU tensors.
    """
    if config is None:
        config = ToneConfig()
    sd: dict[str, np.ndarray] = {}
    for k, v in state_dict.items():
        if k.startswith("tone."):
            k = k[len("tone."):]
        sd[k] = _float32(v)

    bn1_p, bn1_s = _bn(sd, "encoder.pre_encode.conv.0.1")
    bn2_p, bn2_s = _bn(sd, "encoder.pre_encode.conv.1.1")
    pre_encode = {
        "pre_norm": _rms(sd, "encoder.pre_encode.pre_norm"),
        "conv1": _conv(sd, "encoder.pre_encode.conv.0.0"),
        "bn1": bn1_p,
        "conv2": _conv(sd, "encoder.pre_encode.conv.1.0"),
        "bn2": bn2_p,
        "out": _lin(sd, "encoder.pre_encode.out"),
        "out_norm": _rms(sd, "encoder.pre_encode.out_norm"),
    }

    layers = []
    layer_stats = []
    for i in range(config.encoder.n_layers):
        pfx = f"encoder.layers.{i}"
        att = {
            "linear_v": _lin(sd, f"{pfx}.self_attn.linear_v"),
            "linear_out": _lin(sd, f"{pfx}.self_attn.linear_out"),
        }
        if config.encoder.should_recompute_att_scores[i]:
            att["linear_q"] = _lin(sd, f"{pfx}.self_attn.linear_q")
            att["linear_k"] = _lin(sd, f"{pfx}.self_attn.linear_k")
            att["q_ln"] = _ln(sd, f"{pfx}.self_attn.q_ln")
            att["k_ln"] = _ln(sd, f"{pfx}.self_attn.k_ln")
        cbn_p, cbn_s = _bn(sd, f"{pfx}.conv.batch_norm")
        layers.append({
            "norm_ff1": _rms(sd, f"{pfx}.norm_feed_forward1"),
            "ff1": {
                "lin1": _lin(sd, f"{pfx}.feed_forward1.linear1"),
                "linv": _lin(sd, f"{pfx}.feed_forward1.linearv"),
                "lin2": _lin(sd, f"{pfx}.feed_forward1.linear2"),
            },
            "norm_att": _rms(sd, f"{pfx}.norm_self_att"),
            "att": att,
            "norm_conv": _rms(sd, f"{pfx}.norm_conv"),
            "conv": {
                "pw1": _pw_conv1d(sd, f"{pfx}.conv.pointwise_conv1"),
                "dw": _conv(sd, f"{pfx}.conv.depthwise_conv.conv"),
                "bn": cbn_p,
                "pw2": _pw_conv1d(sd, f"{pfx}.conv.pointwise_conv2"),
            },
            "norm_ff2": _rms(sd, f"{pfx}.norm_feed_forward2"),
            "ff2": {
                "lin1": _lin(sd, f"{pfx}.feed_forward2.linear1"),
                "linv": _lin(sd, f"{pfx}.feed_forward2.linearv"),
                "lin2": _lin(sd, f"{pfx}.feed_forward2.linear2"),
            },
            "norm_out": _rms(sd, f"{pfx}.norm_out"),
        })
        layer_stats.append({"conv_bn": cbn_s})

    reduction = {
        # the reference's own spelling of the module name
        "dw": _conv(sd, "encoder.temportal_reduction.conv"),
        "pw": _pw_conv1d(sd, "encoder.temportal_reduction.conv_pw"),
    }
    head = _pw_conv1d(sd, "decoder.decoder_layers.0")

    variables = {
        "params": {
            "encoder": {
                "pre_encode": pre_encode,
                "layers": tuple(layers),
                "reduction": reduction,
            },
            "head": head,
        },
        "batch_stats": {
            "pre_encode": {"bn1": bn1_s, "bn2": bn2_s},
            "layers": tuple(layer_stats),
        },
    }
    return tree_map(lambda a: torch.from_numpy(np.require(a, requirements=["C", "W"])),
                    variables)


def load_torch_checkpoint(path: str | Path, config: ToneConfig | None = None) -> dict[str, Params]:
    """Load a reference checkpoint file (.safetensors, .bin/.pt) and convert."""
    path = Path(path)
    if path.suffix == ".safetensors":
        sd = read_safetensors(path)
    else:
        sd = torch.load(str(path), map_location="cpu", weights_only=True)
    return convert_torch_state_dict(sd, config)


# ---------------------------------------------------------------------------
# The port's checkpoint directory: config.json + variables.safetensors.
# ---------------------------------------------------------------------------


def save_checkpoint(path: str | Path, variables: dict[str, Params],
                    config: ToneConfig | None = None) -> None:
    """Save variables (in the reference naming) and the config to a directory."""
    from tone_tpu_torch.interop import save_torch_checkpoint

    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    save_torch_checkpoint(path / VARIABLES_FILE, variables, config)
    if config is not None:
        (path / "config.json").write_text(json.dumps(config.to_dict(), indent=2))


def load_checkpoint(path: str | Path, config: ToneConfig | None = None,
                    ) -> tuple[dict[str, Params], ToneConfig | None]:
    """Load a directory saved by :func:`save_checkpoint`: (variables, the
    stored config or None).  ``config`` gives the layout to read with where
    the directory stores none (default ``ToneConfig()``).

    A JAX checkpoint directory (orbax's ``variables/``) raises ValueError:
    write it once with ``tone_tpu.interop.save_torch_checkpoint``, or load
    it with the JAX package and pass it through ``bridge.from_jax_variables``.
    """
    path = Path(path).absolute()
    weights = path / VARIABLES_FILE
    if not weights.exists():
        if (path / "variables").is_dir():
            raise ValueError(
                f"{path} is a JAX (orbax) checkpoint, which the port cannot read: "
                "convert it with tone_tpu.interop.save_torch_checkpoint(path / "
                "'model.safetensors', variables, config) and load that file")
        raise FileNotFoundError(f"no {VARIABLES_FILE} in {path}")
    stored = None
    cfg_file = path / "config.json"
    if cfg_file.exists():
        stored = ToneConfig.from_dict(json.loads(cfg_file.read_text()))
    return load_torch_checkpoint(weights, stored or config), stored
