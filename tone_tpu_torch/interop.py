"""Interoperability with the reference torch ecosystem (port of
``tone_tpu/interop.py``).

The reverse of ``checkpoint.convert_torch_state_dict``: the port's variables
as a torch state_dict in the reference's module naming (``Tone``; prefixed
``tone.`` for HF ``ToneForCTC``), written as ``.safetensors``; the
reference's HF config dict; and the ``.nemo`` archive the reference's
export script writes.  A model fine-tuned on the card loads in the reference
code, in the JAX package and back in the port.

Round-trip is exact: convert_torch_state_dict(to_torch_state_dict(v)) == v.

The archive's ``model_config.yaml`` is written and read here without a YAML
package: ``dump_yaml`` emits what ``yaml.safe_dump(cfg, sort_keys=False)``
emits for such a config, and ``load_yaml`` reads the block-style subset
that emitter produces (nested mappings and sequences, plain, single- and
double-quoted scalars, ints, floats, booleans and null).
"""

from __future__ import annotations

import dataclasses
import io
import math
import re
import tarfile
import time
from pathlib import Path
from typing import Any, Mapping

import torch

from tone_tpu_torch.config import (
    EncoderConfig,
    FastConformerConfig,
    FrontendConfig,
    ModelConfig,
    ToneConfig,
)


def _cpu(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().cpu()


def _t(x) -> torch.Tensor:
    return _cpu(x).t().contiguous()


def _put_lin(out: dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _t(p["w"])
    if "b" in p:
        out[f"{name}.bias"] = _cpu(p["b"])


def _put_pw_conv1d(out: dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _t(p["w"])[:, :, None].contiguous()
    if "b" in p:
        out[f"{name}.bias"] = _cpu(p["b"])


def _put_conv(out: dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _cpu(p["w"])
    if "b" in p:
        out[f"{name}.bias"] = _cpu(p["b"])


def _put_ln(out: dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _cpu(p["scale"])
    out[f"{name}.bias"] = _cpu(p["bias"])


def _put_rms(out: dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _cpu(p["weight"])


def _put_bn(out: dict, name: str, p: Mapping, stats: Mapping) -> None:
    out[f"{name}.weight"] = _cpu(p["scale"])
    out[f"{name}.bias"] = _cpu(p["bias"])
    out[f"{name}.running_mean"] = _cpu(stats["mean"])
    out[f"{name}.running_var"] = _cpu(stats["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _split_ff(ff: Mapping) -> Mapping:
    """Undo the serving-time GLU merge (acoustic.cast_params_for_inference):
    lin12 (D, 2F) -> lin1/linv in float32, so serving variables also export."""
    if "lin12" not in ff:
        return ff
    w = _cpu(ff["lin12"]["w"]).float()
    b = _cpu(ff["lin12"]["b"]).float()
    f = w.shape[1] // 2
    return {
        "lin1": {"w": w[:, :f], "b": b[:f]},
        "linv": {"w": w[:, f:], "b": b[f:]},
        "lin2": ff["lin2"],
    }


def to_fastconformer_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A FastConformer's variables (``core.fastconformer``) as NeMo's
    ``EncDecCTCModelBPE`` state_dict of contiguous CPU tensors (dtypes
    kept), ``EncDecRNNTBPEModel``'s where they hold a transducer or
    ``EncDecMultiTaskModel``'s where they hold an AED decoder: the inverse
    of ``checkpoint.convert_fastconformer_state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    pre = params["encoder"]["pre_encode"]
    out: dict[str, torch.Tensor] = {}
    _put_conv(out, "encoder.pre_encode.conv.0", pre["conv0"])
    for i, stage in enumerate(pre["stages"]):
        _put_conv(out, f"encoder.pre_encode.conv.{2 + 3 * i}", stage["dw"])
        _put_conv(out, f"encoder.pre_encode.conv.{3 + 3 * i}", stage["pw"])
    _put_lin(out, "encoder.pre_encode.out", pre["out"])
    for i, (layer, lstats) in enumerate(zip(params["encoder"]["layers"], stats["layers"])):
        pfx = f"encoder.layers.{i}"
        for n in ("1", "2"):
            _put_ln(out, f"{pfx}.norm_feed_forward{n}", layer[f"norm_ff{n}"])
            _put_lin(out, f"{pfx}.feed_forward{n}.linear1", layer[f"ff{n}"]["linear1"])
            _put_lin(out, f"{pfx}.feed_forward{n}.linear2", layer[f"ff{n}"]["linear2"])
        att = layer["att"]
        _put_ln(out, f"{pfx}.norm_self_att", layer["norm_att"])
        for n in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            _put_lin(out, f"{pfx}.self_attn.{n}", att[n])
        out[f"{pfx}.self_attn.pos_bias_u"] = _cpu(att["pos_bias_u"])
        out[f"{pfx}.self_attn.pos_bias_v"] = _cpu(att["pos_bias_v"])
        _put_ln(out, f"{pfx}.norm_conv", layer["norm_conv"])
        _put_pw_conv1d(out, f"{pfx}.conv.pointwise_conv1", layer["conv"]["pw1"])
        _put_conv(out, f"{pfx}.conv.depthwise_conv", layer["conv"]["dw"])
        _put_bn(out, f"{pfx}.conv.batch_norm", layer["conv"]["bn"], lstats["conv_bn"])
        _put_pw_conv1d(out, f"{pfx}.conv.pointwise_conv2", layer["conv"]["pw2"])
        _put_ln(out, f"{pfx}.norm_out", layer["norm_out"])
    if "head" in params:
        _put_pw_conv1d(out, "decoder.decoder_layers.0", params["head"])
        return out
    if "aed" in params:
        _put_aed(out, params["aed"])
        return out
    out["decoder.prediction.embed.weight"] = _cpu(params["decoder"]["embed"])
    for i, layer in enumerate(params["decoder"]["lstm"]):
        for part in ("ih", "hh"):
            out[f"decoder.prediction.dec_rnn.lstm.weight_{part}_l{i}"] = _t(layer[part]["w"])
            out[f"decoder.prediction.dec_rnn.lstm.bias_{part}_l{i}"] = _cpu(layer[part]["b"])
    joint = params["joint"]
    for name, key in (("joint.enc", "enc"), ("joint.pred", "pred"),
                      ("joint.joint_net.2", "out")):
        _put_lin(out, name, joint[key])
    return out


def _put_aed(out: dict, aed: Mapping) -> None:
    """An AED's decoder and head under NeMo's ``EncDecMultiTaskModel``
    names: the inverse of ``checkpoint.convert_fastconformer_state_dict``'s."""
    out["transf_decoder._embedding.token_embedding.weight"] = _cpu(aed["embed"])
    _put_ln(out, "transf_decoder._embedding.layer_norm", aed["embed_norm"])
    names = {"linear_q": "query_net", "linear_k": "key_net", "linear_v": "value_net",
             "linear_out": "out_projection"}
    for i, layer in enumerate(aed["layers"]):
        pfx = f"transf_decoder._decoder.layers.{i}"
        for n, (norm, att) in enumerate((("norm_self_att", "self_att"),
                                         ("norm_cross_att", "cross_att")), start=1):
            _put_ln(out, f"{pfx}.layer_norm_{n}", layer[norm])
            sub = "first_sub_layer" if n == 1 else "second_sub_layer"
            for key, name in names.items():
                _put_lin(out, f"{pfx}.{sub}.{name}", layer[att][key])
        _put_ln(out, f"{pfx}.layer_norm_3", layer["norm_ff"])
        _put_lin(out, f"{pfx}.third_sub_layer.dense_in", layer["ff"]["linear1"])
        _put_lin(out, f"{pfx}.third_sub_layer.dense_out", layer["ff"]["linear2"])
    _put_ln(out, "transf_decoder._decoder.final_layer_norm", aed["final_norm"])
    _put_lin(out, "log_softmax.mlp.layer0", aed["head"])


def to_torch_state_dict(variables: Mapping[str, Any], config: ModelConfig | None = None,
                        prefix: str = "") -> dict[str, torch.Tensor]:
    """The variables as a reference-named state_dict of contiguous CPU
    tensors (dtypes kept; a merged ``lin12`` is split in float32); NeMo's
    names for a ``FastConformerConfig``.

    Args:
        prefix: "" for a bare ``Tone`` state_dict, "tone." for ``ToneForCTC``.
    """
    if isinstance(config, FastConformerConfig):
        out = to_fastconformer_state_dict(variables)
        return {prefix + k: v for k, v in out.items()}
    # otherwise the layout follows the variables, as in the JAX package
    params = variables["params"]
    stats = variables["batch_stats"]
    enc = params["encoder"]
    out: dict[str, torch.Tensor] = {}

    pre = enc["pre_encode"]
    _put_rms(out, "encoder.pre_encode.pre_norm", pre["pre_norm"])
    _put_conv(out, "encoder.pre_encode.conv.0.0", pre["conv1"])
    _put_bn(out, "encoder.pre_encode.conv.0.1", pre["bn1"], stats["pre_encode"]["bn1"])
    _put_conv(out, "encoder.pre_encode.conv.1.0", pre["conv2"])
    _put_bn(out, "encoder.pre_encode.conv.1.1", pre["bn2"], stats["pre_encode"]["bn2"])
    _put_lin(out, "encoder.pre_encode.out", pre["out"])
    _put_rms(out, "encoder.pre_encode.out_norm", pre["out_norm"])

    for i, (layer, lstats) in enumerate(zip(enc["layers"], stats["layers"])):
        pfx = f"encoder.layers.{i}"
        _put_rms(out, f"{pfx}.norm_feed_forward1", layer["norm_ff1"])
        ff1 = _split_ff(layer["ff1"])
        _put_lin(out, f"{pfx}.feed_forward1.linear1", ff1["lin1"])
        _put_lin(out, f"{pfx}.feed_forward1.linearv", ff1["linv"])
        _put_lin(out, f"{pfx}.feed_forward1.linear2", ff1["lin2"])
        _put_rms(out, f"{pfx}.norm_self_att", layer["norm_att"])
        att = layer["att"]
        _put_lin(out, f"{pfx}.self_attn.linear_v", att["linear_v"])
        _put_lin(out, f"{pfx}.self_attn.linear_out", att["linear_out"])
        if "linear_q" in att:
            _put_lin(out, f"{pfx}.self_attn.linear_q", att["linear_q"])
            _put_lin(out, f"{pfx}.self_attn.linear_k", att["linear_k"])
            _put_ln(out, f"{pfx}.self_attn.q_ln", att["q_ln"])
            _put_ln(out, f"{pfx}.self_attn.k_ln", att["k_ln"])
        _put_rms(out, f"{pfx}.norm_conv", layer["norm_conv"])
        _put_pw_conv1d(out, f"{pfx}.conv.pointwise_conv1", layer["conv"]["pw1"])
        _put_conv(out, f"{pfx}.conv.depthwise_conv.conv", layer["conv"]["dw"])
        _put_bn(out, f"{pfx}.conv.batch_norm", layer["conv"]["bn"], lstats["conv_bn"])
        _put_pw_conv1d(out, f"{pfx}.conv.pointwise_conv2", layer["conv"]["pw2"])
        _put_rms(out, f"{pfx}.norm_feed_forward2", layer["norm_ff2"])
        ff2 = _split_ff(layer["ff2"])
        _put_lin(out, f"{pfx}.feed_forward2.linear1", ff2["lin1"])
        _put_lin(out, f"{pfx}.feed_forward2.linearv", ff2["linv"])
        _put_lin(out, f"{pfx}.feed_forward2.linear2", ff2["lin2"])
        _put_rms(out, f"{pfx}.norm_out", layer["norm_out"])

    _put_conv(out, "encoder.temportal_reduction.conv", enc["reduction"]["dw"])
    _put_pw_conv1d(out, "encoder.temportal_reduction.conv_pw", enc["reduction"]["pw"])
    _put_pw_conv1d(out, "decoder.decoder_layers.0", params["head"])

    if prefix:
        out = {prefix + k: v for k, v in out.items()}
    return out


def save_torch_checkpoint(path, variables, config: ModelConfig | None = None,
                          prefix: str = "") -> None:
    """Write the state_dict as .safetensors (readable by the reference with
    ``load_file`` + ``load_state_dict``, and by both packages' loaders)."""
    from tone_tpu_torch.checkpoint import write_safetensors

    write_safetensors(to_torch_state_dict(variables, config, prefix), path,
                      metadata={"format": "pt"})


# ---------------------------------------------------------------------------
# Reference-config and .nemo archive interop.
# ---------------------------------------------------------------------------


def to_reference_config(config: ToneConfig | None = None) -> dict:
    """Our typed config as the reference's HF ``ToneConfig`` dict
    (tone/training/model_wrapper.py:27-121) — the shape stored in
    ``config.json`` / ``model_config.yaml`` artifacts."""
    config = config or ToneConfig()
    fe, enc = config.frontend, config.encoder
    return {
        "feature_extraction_params": {
            "sample_rate": fe.sample_rate,
            "window_size": fe.window_size,
            "window_stride": fe.window_stride,
            "n_fft": fe.n_fft,
            "n_mels": fe.n_mels,
            "preemphasis_coefficient": fe.preemphasis_coefficient,
        },
        "encoder_params": {
            "feat_in": enc.feat_in,
            "n_layers": enc.n_layers,
            "subsampling_conv_channels": list(enc.subsampling_conv_channels),
            "subsampling_kernel_size": [list(k) for k in enc.subsampling_kernel_size],
            "subsampling_strides": [list(s) for s in enc.subsampling_strides],
            "ff_expansion_factor": enc.ff_expansion_factor,
            "n_heads": enc.n_heads,
            "conv_kernel_size": enc.conv_kernel_size,
            "dropout": enc.dropout,
            "dropout_att": enc.dropout_att,
            "mhsa_stateless_layers": enc.mhsa_stateless_layers,
            "rope_dim": enc.rope_dim,
            "should_recompute_att_scores": list(enc.should_recompute_att_scores),
            "mhsa_state_size": enc.mhsa_state_size,
            "chunk_size": enc.chunk_size,
            "d_model": enc.d_model,
            "reduction_factor": enc.reduction_factor,
            "reduction_kernel_size": enc.reduction_kernel_size,
            "reduction_position": enc.reduction_position,
            "upsample_position": enc.upsample_position,
        },
        "decoder_params": {
            "feat_in": enc.d_model,
            "vocabulary": list(config.labels),
        },
        "pad_token_id": len(config.labels),
        "ctc_loss_reduction": "mean",
        "ctc_zero_infinity": True,
    }


def from_reference_config(ref: Mapping[str, Any]) -> ToneConfig:
    """Inverse of :func:`to_reference_config`."""
    fe = dict(ref.get("feature_extraction_params") or {})
    enc = dict(ref.get("encoder_params") or {})
    fe.pop("log_zero_guard_value", None)
    frontend = FrontendConfig(**{k: v for k, v in fe.items()
                                 if k in {f.name for f in dataclasses.fields(FrontendConfig)}})
    enc_fields = {f.name for f in dataclasses.fields(EncoderConfig)}
    enc = {k: v for k, v in enc.items() if k in enc_fields}
    for key in ("subsampling_conv_channels", "should_recompute_att_scores"):
        if key in enc:
            enc[key] = tuple(enc[key])
    for key in ("subsampling_kernel_size", "subsampling_strides"):
        if key in enc:
            enc[key] = tuple(tuple(x) for x in enc[key])
    labels = "".join((ref.get("decoder_params") or {}).get("vocabulary") or []) or None
    kwargs = {"frontend": frontend, "encoder": EncoderConfig(**enc)}
    if labels:
        kwargs["labels"] = labels
    return ToneConfig(**kwargs)


_NEMO_PREFIX = "tone_for_ctc.tone."


def save_nemo_archive(path, variables, config: ToneConfig | None = None) -> None:
    """Write a ``.nemo`` archive (reference tone/scripts/export.py:528-549,
    tone/nemo_wrapper.py:15): a gzipped tar with ``./model_config.yaml``
    (the ``ToneCTCNemoModel`` cfg) and ``./model_weights.ckpt`` (torch-saved
    float32 state_dict under the ``tone_for_ctc.tone.`` prefix) — restorable
    by NeMo's ``ModelPT.restore_from`` with the reference's wrapper class."""
    config = config or ToneConfig()
    cfg = {
        "tone_config": to_reference_config(config),
        "decoding": {"strategy": "greedy"},
        "target": "tone.nemo_wrapper.ToneCTCNemoModel",
    }
    config_bytes = dump_yaml(cfg).encode()

    # float32, as the reference's checkpoints
    sd = to_torch_state_dict(variables, config, prefix=_NEMO_PREFIX)
    weights = io.BytesIO()
    torch.save({k: v.float() if v.is_floating_point() else v for k, v in sd.items()}, weights)

    def add(tar, name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        info.mtime = int(time.time())
        tar.addfile(info, io.BytesIO(data))

    # gzip level 1, not tarfile's 9: weights that hold bf16 values (a
    # serving model's, even widened to float32) compress at level 9 about
    # 40 times slower than at level 1 (minutes for the full model), for an
    # archive 15 % smaller; every gzip reader takes either.
    with tarfile.open(str(path), "w:gz", compresslevel=1) as tar:
        add(tar, "./model_config.yaml", config_bytes)
        add(tar, "./model_weights.ckpt", weights.getvalue())


def load_nemo_archive(path) -> tuple[dict, ToneConfig]:
    """Load a ``.nemo`` archive into (variables, ToneConfig)."""
    from tone_tpu_torch.checkpoint import convert_torch_state_dict

    with tarfile.open(str(path), "r:*") as tar:
        members = {m.name.lstrip("./"): m for m in tar.getmembers()}
        cfg_name = next(n for n in members if n.endswith("model_config.yaml"))
        wts_name = next(n for n in members if n.endswith("model_weights.ckpt"))
        cfg = load_yaml(tar.extractfile(members[cfg_name]).read().decode("utf-8"))
        raw = tar.extractfile(members[wts_name]).read()
    sd = torch.load(io.BytesIO(raw), map_location="cpu", weights_only=True)
    sd = {(k[len(_NEMO_PREFIX):] if k.startswith(_NEMO_PREFIX) else k): v
          for k, v in sd.items()}
    config = from_reference_config(cfg.get("tone_config") or {})
    return convert_torch_state_dict(sd, config), config


# ---------------------------------------------------------------------------
# YAML: the block style of yaml.safe_dump(..., sort_keys=False), both ways.
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (YAML 1.1): a plain scalar that matches one of
# these is read as that type, so a string that matches is written quoted.
_BOOL_WORDS = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
               "TRUE": True, "on": True, "On": True, "ON": True, "no": False,
               "No": False, "NO": False, "false": False, "False": False,
               "FALSE": False, "off": False, "Off": False, "OFF": False}
_NULL_WORDS = {"~", "null", "Null", "NULL", ""}
_INT_RE = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_OCT_RE = re.compile(r"[-+]?0[0-7_]+$")
_HEX_RE = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_BIN_RE = re.compile(r"[-+]?0b[0-1_]+$")
_FLOAT_RE = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL_RE = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_TIMESTAMP_RE = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0a": "n",
            "\x0b": "v", "\x0c": "f", "\x0d": "r", "\x1b": "e", '"': '"', "\\": "\\",
            "\x85": "N", "\xa0": "_", "\u2028": "L", "\u2029": "P"}
_UNESCAPES = {v: k for k, v in _ESCAPES.items()} | {"/": "/", " ": " ", "\t": "\t"}


def _implicitly_typed(s: str) -> bool:
    return (s in _BOOL_WORDS or s in _NULL_WORDS or s in ("=", "<<")
            or any(r.match(s) for r in (_INT_RE, _OCT_RE, _HEX_RE, _BIN_RE, _FLOAT_RE,
                                        _SEXAGESIMAL_RE, _TIMESTAMP_RE)))


def _dump_str(s: str) -> str:
    """A string as PyYAML's emitter writes it in block context: plain where
    it reads back as the same string, else single-quoted; double-quoted with
    escapes where it holds a character outside printable ASCII."""
    if any(not (" " <= c <= "~") for c in s):
        out = []
        for c in s:
            if c in _ESCAPES:
                out.append("\\" + _ESCAPES[c])
            elif " " <= c <= "~":
                out.append(c)
            elif c <= "\xff":
                out.append(f"\\x{ord(c):02X}")
            elif c <= "\uffff":
                out.append(f"\\u{ord(c):04X}")
            else:
                out.append(f"\\U{ord(c):08X}")
        return '"' + "".join(out) + '"'
    plain = (bool(s) and not _implicitly_typed(s) and s[0] != " " and s[-1] != " "
             and s[0] not in "#,[]{}&*!|>'\"%@`"
             and not (s[0] in "?:-" and (len(s) == 1 or s[1] == " "))
             and not s.startswith(("---", "..."))
             and ": " not in s and not s.endswith(":") and " #" not in s)
    return s if plain else "'" + s.replace("'", "''") + "'"


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return _dump_str(v)
    raise TypeError(f"cannot write a {type(v).__name__} as YAML")


def _dump_node(v, indent: int, lines: list[str], prefix: str) -> None:
    """Write ``v`` after ``prefix`` (a key, dashes, or nothing at a block start)."""
    pad = " " * indent
    if isinstance(v, Mapping) and v:
        first = True
        for k, item in v.items():
            head = (prefix if first else pad) + _dump_str(str(k)) + ":"
            first = False
            if isinstance(item, Mapping) and item:
                lines.append(head)
                _dump_node(item, indent + 2, lines, " " * (indent + 2))
            elif isinstance(item, (list, tuple)) and item:
                lines.append(head)
                _dump_node(item, indent, lines, pad)  # safe_dump: no indent under a key
            else:
                lines.append(head + " " + _dump_flow_or_scalar(item))
    elif isinstance(v, (list, tuple)) and v:
        first = True
        for item in v:
            head = (prefix if first else pad) + "- "
            first = False
            if (isinstance(item, (Mapping, list, tuple))) and item:
                _dump_node(item, indent + 2, lines, head)
            else:
                lines.append(head + _dump_flow_or_scalar(item))
    else:
        lines.append(prefix + _dump_flow_or_scalar(v))


def _dump_flow_or_scalar(v) -> str:
    if isinstance(v, Mapping):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _dump_scalar(v)


def dump_yaml(data: Mapping[str, Any]) -> str:
    """``yaml.safe_dump(data, sort_keys=False)`` for a mapping of mappings,
    sequences and scalars whose lines fit the emitter's width of 80."""
    lines: list[str] = []
    _dump_node(data, 0, lines, "")
    return "\n".join(lines) + "\n"


def _parse_scalar(text: str):
    text = text.strip()
    if text.startswith('"'):
        if not text.endswith('"') or len(text) < 2:
            raise ValueError(f"unterminated double-quoted scalar: {text}")
        out, i, body = [], 0, text[1:-1]
        while i < len(body):
            c = body[i]
            if c != "\\":
                out.append(c)
                i += 1
                continue
            e = body[i + 1]
            width = {"x": 2, "u": 4, "U": 8}.get(e)
            if width:
                out.append(chr(int(body[i + 2:i + 2 + width], 16)))
                i += 2 + width
            else:
                out.append(_UNESCAPES[e])
                i += 2
        return "".join(out)
    if text.startswith("'"):
        if not text.endswith("'") or len(text) < 2:
            raise ValueError(f"unterminated single-quoted scalar: {text}")
        return text[1:-1].replace("''", "'")
    if text == "[]":
        return []
    if text == "{}":
        return {}
    if text in _NULL_WORDS:
        return None
    if text in _BOOL_WORDS:
        return _BOOL_WORDS[text]
    if _INT_RE.match(text):
        return int(text.replace("_", ""))
    if _FLOAT_RE.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t.startswith("-") else math.inf
        if t.endswith(".nan"):
            return math.nan
        return float(t)
    if _HEX_RE.match(text):
        return int(text.replace("_", ""), 16)
    if _BIN_RE.match(text):
        return int(text.replace("_", ""), 2)
    if _OCT_RE.match(text):
        return int(text.replace("_", ""), 8)
    return text


def _split_key(text: str) -> tuple[Any, str] | None:
    """(key, rest) of a mapping line ``key: rest`` or ``key:``, else None."""
    if text[:1] in "'\"":
        q, i = text[0], 1
        while i < len(text) and text[i] != q:
            i += 2 if text[i] == "\\" and q == '"' else 1
            if q == "'" and text[i:i + 2] == "''":
                i += 2
        rest = text[i + 1:]
        if rest == ":" or rest.startswith(": "):
            return _parse_scalar(text[:i + 1]), rest[1:]
        return None
    m = re.match(r"(.*?):(?: |$)", text)
    return (m.group(1), text[m.end():]) if m else None


def load_yaml(text: str):
    """Read the block-style YAML that :func:`dump_yaml` and
    ``yaml.safe_dump`` emit (no anchors, tags, flow collections beyond
    ``[]``/``{}``, or scalars over several lines)."""
    # Tokens (column, text, is_dash): "- rest" becomes a dash at its column
    # and ``rest`` at the column where it starts, so nested sequences and
    # mappings inside a sequence item are blocks like any other.
    toks: list[tuple[int, str, bool]] = []
    for raw in text.splitlines():
        body = raw.strip()
        if not body or body.startswith("#") or body == "---":
            continue
        col = len(raw) - len(raw.lstrip(" "))
        while body == "-" or body.startswith("- "):
            toks.append((col, "-", True))
            rest = body[1:]
            col += 1 + len(rest) - len(rest.lstrip(" "))
            body = rest.strip()
        if body:
            toks.append((col, body, False))
    pos = 0

    def node():
        nonlocal pos
        col, body, dash = toks[pos]
        if dash:
            return seq(col)
        if _split_key(body) is not None:
            return mapping(col)
        pos += 1
        return _parse_scalar(body)

    def nested(col: int, indentless: bool):
        """The block under a ``key:`` or ``-`` at column ``col``, or None."""
        if pos < len(toks) and (toks[pos][0] > col
                                or (indentless and toks[pos][0] == col and toks[pos][2])):
            return node()
        return None

    def seq(col: int):
        nonlocal pos
        out = []
        while pos < len(toks) and toks[pos][0] == col and toks[pos][2]:
            pos += 1
            out.append(nested(col, indentless=False))
        return out

    def mapping(col: int):
        nonlocal pos
        out = {}
        while pos < len(toks) and toks[pos][0] == col and not toks[pos][2]:
            kv = _split_key(toks[pos][1])
            if kv is None:
                raise ValueError(f"expected 'key: value', got {toks[pos][1]!r}")
            pos += 1
            key, rest = kv
            out[key] = _parse_scalar(rest) if rest.strip() else nested(col, indentless=True)
        return out

    if not toks:
        return None
    result = node()
    if pos != len(toks):
        raise ValueError(f"unexpected YAML line {toks[pos][1]!r}")
    return result
