"""Backwards-compatible location (as in the JAX package): the KenLM binary
reader/writer lives in :mod:`tone_tpu_torch.decoding.kenlm_binary` (it is
pure Python, not native; the native C++ twin is in ``src/tone_decode.cpp``'s
``KenLMProbing``)."""

from tone_tpu_torch.decoding.kenlm_binary import (  # noqa: F401
    KenLMBinary,
    read_kenlm_binary,
    write_kenlm_binary,
)
