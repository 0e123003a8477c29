"""Shared fixtures of the PyTorch-port tests (tests/test_torch_*.py), and
tests that the port's copy of the configuration is the JAX package's.

A tiny encoder that keeps every streaming feature of the full model: score
reuse (layer 1 reuses layer 0's scores), the temporal reduction (after
layer 1) and upsample (after layer 3), a reduced stateful window (layer 3,
15 frames) and a full stateful window (layer 4, 30 frames).  The same
numpy-made weights and audio go through the JAX package and the port.
"""

from __future__ import annotations

import socket

import jax
import numpy as np
import pytest
import torch

import tone_tpu.config as jcfg
import tone_tpu_torch.config as tcfg
from tone_tpu.core.model import init_model_params as jax_init_model_params
from tone_tpu_torch.bridge import from_jax_variables

# Six xdist workers share the cores: keep each test process's torch small.
torch.set_num_threads(2)

TINY_ENCODER = dict(
    n_layers=5, d_model=64, n_heads=4, rope_dim=8, ff_expansion_factor=2,
    conv_kernel_size=7, subsampling_conv_channels=(4, 8), mhsa_stateless_layers=3,
    reduction_position=1, upsample_position=3,
    should_recompute_att_scores=(True, False, True, True, True),
)


# The model artifacts' tests (checkpoints, interop, ONNX, export): four
# layers, the recompute flags mixed (layer 1 reuses layer 0's scores), the
# reduction after layer 1 and the upsample after layer 2 (a reduced stateful
# window in layer 2, a full one in layer 3).
ARTIFACT_ENCODER = dict(
    n_layers=4, d_model=64, n_heads=4, rope_dim=8, ff_expansion_factor=2,
    conv_kernel_size=7, subsampling_conv_channels=(4, 8), mhsa_stateless_layers=2,
    reduction_position=1, upsample_position=2,
    should_recompute_att_scores=(True, False, True, True),
)


def tiny_configs(compute_dtype: str = "float32", encoder: dict = TINY_ENCODER):
    """(JAX ToneConfig, port ToneConfig) of the tiny model."""
    return (jcfg.ToneConfig(encoder=jcfg.EncoderConfig(**encoder),
                            compute_dtype=compute_dtype),
            tcfg.ToneConfig(encoder=tcfg.EncoderConfig(**encoder),
                            compute_dtype=compute_dtype))


def leaves_with_paths(tree, path: str = "") -> list[tuple[str, object]]:
    """(path, leaf) of every leaf of a tree of dicts, lists and tuples, in
    order (dict keys sorted), for comparing two packages' trees."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_with_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_with_paths(v, f"{path}/{i}")]
    return [(path, tree)]


def as_float32(x) -> np.ndarray:
    """A JAX array, numpy array or torch tensor (bf16 too) as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(np.asarray(x).astype(np.float32))


def assert_trees_equal(a, b) -> None:
    """Same leaf paths and bit-equal float32 values."""
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = as_float32(x), as_float32(y)
        assert x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


def tiny_variables(jax_config, torch_config, seed: int = 0):
    """(JAX variables, port variables on the CPU) with the same values."""
    jv = jax_init_model_params(jax.random.PRNGKey(seed), jax_config)
    tv = from_jax_variables(jax.tree.map(np.asarray, jv), torch_config, "cpu")
    return jv, tv


def tiny_variables_with_stats(jax_config, torch_config, seed: int = 0):
    """``tiny_variables`` with random BatchNorm running statistics (a fresh
    model's are the identity), so that a forward that ignored them would
    differ."""
    jv, _ = tiny_variables(jax_config, torch_config, seed)
    rng = np.random.default_rng(seed)

    def stats(tree):
        if isinstance(tree, dict) and set(tree) == {"mean", "var"}:
            return {"mean": 0.1 * rng.standard_normal(tree["mean"].shape).astype(np.float32),
                    "var": (0.5 + rng.random(tree["var"].shape)).astype(np.float32)}
        if isinstance(tree, dict):
            return {k: stats(v) for k, v in tree.items()}
        return type(tree)(stats(v) for v in tree)

    jv = {"params": jax.tree.map(np.asarray, jv["params"]),
          "batch_stats": stats(jax.tree.map(np.asarray, jv["batch_stats"]))}
    return jv, from_jax_variables(jv, torch_config, "cpu")


def audio(n_samples: int, batch: int | None = None, seed: int = 0) -> np.ndarray:
    shape = (n_samples,) if batch is None else (batch, n_samples)
    return np.random.default_rng(seed).integers(-20000, 20000, shape).astype(np.int32)


def dead_endpoint() -> str:
    """A loopback URL where nothing listens (connections are refused)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


DERIVED = ("resolved_state_dtype", "vocab_size", "vocab_size_with_blank", "blank_id",
           "feat_frames_per_chunk", "flat_state_size")


@pytest.mark.parametrize("case", ["default", "tiny_bf16", "chunk_600ms"])
def test_config_copy_matches_jax(case):
    if case == "default":
        jc, tc = jcfg.ToneConfig(), tcfg.ToneConfig()
    elif case == "tiny_bf16":
        jc, tc = tiny_configs("bfloat16")
    else:
        jc, tc = (jcfg.ToneConfig().with_chunk_duration_ms(600),
                  tcfg.ToneConfig().with_chunk_duration_ms(600))
    assert tc.to_dict() == jc.to_dict()
    assert tcfg.ToneConfig.from_dict(jc.to_dict()) == tc
    for name in DERIVED:
        assert getattr(tc, name) == getattr(jc, name), name
    assert tcfg.LABELS == jcfg.LABELS
