"""The port's fused GLU feed-forward (tone_tpu_torch/ops/glu_ff.py).

On the CPU the wrapper runs ``glu_ff2_plain``; it is held against the JAX
Pallas kernel (``glu_ff2(..., interpret=True)``, the same numerics) to one
bf16 ulp of each output, and against the plain-XLA ``glu_ff2_reference``
(whose gate is all-bf16) at the JAX oracle's 2e-2.  The kernel itself runs
only on a GPU: tests/test_torch_gpu.py holds it against this plain version.
"""

import test_torch_common  # noqa: F401  (keeps torch's thread count small)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tone_tpu.ops.glu_ff import glu_ff2 as jax_glu_ff2
from tone_tpu.ops.glu_ff import glu_ff2_reference
from tone_tpu_torch.ops.glu_ff import glu_ff2, glu_ff2_plain

F, D = 256, 128


def _inputs(m, seed=0):
    """bf16-exact numpy values: av (4, m // 4 or m, 2F), w (F, D), b (D,)."""
    rng = np.random.default_rng(seed)

    def bf16(x):
        return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)

    lead = (4, m // 4) if m % 4 == 0 else (m,)
    av = bf16(rng.standard_normal((*lead, 2 * F)))
    w = bf16(rng.standard_normal((F, D)) * 0.05)
    b = (rng.standard_normal(D) * 0.01).astype(np.float32)
    return av, w, b


def _jax(av, w, b):
    return (jnp.asarray(av, jnp.bfloat16),
            {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b)})


def _torch(av, w, b):
    return (torch.from_numpy(av).to(torch.bfloat16),
            {"w": torch.from_numpy(w).to(torch.bfloat16), "b": torch.from_numpy(b)})


@pytest.mark.parametrize("m", [10, 160, 1280])
def test_plain_matches_jax_kernel(m):
    av, w, b = _inputs(m)
    ref = np.asarray(jax_glu_ff2(*_jax(av, w, b), interpret=True), np.float32)
    got = glu_ff2_plain(*_torch(av, w, b))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    # One bf16 ulp of the output: the two differ only in summation order
    # and in how fp32 sigmoid is evaluated before the gate's bf16 rounding.
    ulp = np.abs(ref) * 2.0 ** -7 + 2.0 ** -20
    assert (np.abs(got.float().numpy() - ref) <= ulp).all()


@pytest.mark.parametrize("m", [10, 160, 1280])
def test_plain_matches_xla_reference(m):
    av, w, b = _inputs(m, seed=1)
    ref = np.asarray(glu_ff2_reference(*_jax(av, w, b)), np.float32)
    got = glu_ff2_plain(*_torch(av, w, b)).float().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)


def test_cpu_tensor_takes_plain_version_without_counting():
    av, w, b = _inputs(160)
    tav, tp = _torch(av, w, b)
    before = glu_ff2.launches
    out = glu_ff2(tav, tp)
    assert glu_ff2.launches == before
    assert torch.equal(out, glu_ff2_plain(tav, tp))


def test_rejects_mismatched_widths():
    av, w, b = _inputs(10)
    tav, tp = _torch(av, w, b)
    with pytest.raises(ValueError):
        glu_ff2(tav[..., :-2], tp)
