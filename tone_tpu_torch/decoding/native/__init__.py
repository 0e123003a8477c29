"""Native (C++) decoding backend of the port: the CTC prefix beam search with
n-gram LM shallow fusion and hotwords (``src/tone_decode.cpp``, the port's
copy of the JAX package's source), built at first use by ``build_native()``.
The estimator's C++ twin (``tone_tpu/decoding/native/estimate.py``) waits
for the ``lm`` subcommand (ROADMAP A14)."""

from tone_tpu_torch.decoding.native.beamsearch import (  # noqa: F401
    NativeLM,
    build_native,
    ctc_beam_search_native,
    native_available,
)
