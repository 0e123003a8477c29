"""Layer offline batching: the share of the samples the forward computed
that are the calls' own audio, the rest being the config's padding, the
bucketed batch's padding and empty rows (%)."""

from harness.program_spans import useful_share


def read(r):
    return useful_share(r, "offline.audio_samples", "offline.padded_samples")
