"""CTC decoding backends of the port: n-gram LMs (ARPA and KenLM binaries),
the modified-Kneser-Ney estimator, n-best rescoring and the hotword
automaton (copies of the JAX-free modules of ``tone_tpu/decoding``).

The host prefix beam search (``tone_tpu/decoding/beam.py``) and its C++
decoder wait for their slice (ROADMAP A11).
"""

from tone_tpu_torch.decoding.lm import ArpaLM, LanguageModel, load_lm

__all__ = ["ArpaLM", "LanguageModel", "load_lm"]
