"""Layer offline batching: the share of the samples the FastConformer's
forward computed that are the calls' own audio, the rest being the
bucketed batch's padding (its rows carry no edge padding) (%)."""

from harness.program_spans import useful_share


def read(r):
    return useful_share(r, "offline.audio_samples", "offline.padded_samples")
