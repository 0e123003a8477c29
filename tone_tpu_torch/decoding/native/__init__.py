"""Native (C++) decoding backend of the port: the CTC prefix beam search with
n-gram LM shallow fusion and hotwords (``src/tone_decode.cpp``, the port's
copy of the JAX package's source), built at first use by ``build_native()``;
the LM estimator's C++ twin (``estimate.py``, ``src/tone_estimate.cpp``)."""

from tone_tpu_torch.decoding.native.beamsearch import (  # noqa: F401
    NativeLM,
    build_native,
    ctc_beam_search_native,
    native_available,
)
