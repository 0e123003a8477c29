"""Layer training batches: the share of the samples of the traced steps'
batches that are the utterances' own audio, the rest padding to each
batch's longest (%)."""

from harness.program_spans import useful_share


def read(r):
    return useful_share(r, "train.audio_samples", "train.padded_samples")
