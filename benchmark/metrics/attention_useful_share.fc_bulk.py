"""Layer FastConformer attention (core/layers.py rel_mhsa_blocked): the
share of the query-key pairs the blocked attention computed that are the
calls' own, the sum over rows and layers of each row's valid frames
squared over rows times the longest row's frames squared (%)."""

from harness.program_spans import useful_share


def read(r):
    return useful_share(r, "fastconformer.attention_pairs",
                        "fastconformer.attention_pairs_computed")
