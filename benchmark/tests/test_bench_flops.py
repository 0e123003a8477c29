"""The yardstick's arithmetic against hand counts: the model operations of
one stream-chunk at 300 and 400 ms from the published shapes, and kernel
B1's least time against the bound column of PERF.md's kernel table."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH)]

from harness.flops import PEAKS, b1_bound_s, b1_bytes, chunk_flops  # noqa: E402
from reference.model import sizes  # noqa: E402


def model(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]


# One stream-chunk, by hand: D = 384, F = 1,536, 35 classes, conv kernel 31;
# 30 (40) feature frames, 10 (13) model frames, 5 (6) in the reduced layers;
# layer 14 attends over a window of 15 reduced frames, layer 15 of 30 full
# ones; scores are computed at layers 0, 7, 14 and 15.
HAND_300 = [
    2 * 30 * 160 * 162 + 2 * 30 * 81 * 64,            # STFT and mel products
    2 * 30 * 44 * 32 * (11 * 21),                      # conv1: 30 x 44 out, 32 channels
    2 * 10 * 34 * 64 * (32 * 11 * 11),                 # conv2: 10 x 34 out, 64 channels
    2 * 10 * 2176 * 384,                               # subsampling's out projection
    7 * 85_839_360 + 5_975_040,                        # layers 0-6 at 10 frames (+ q, k, scores at 0)
    7 * 42_900_480 + 2_968_320,                        # layers 7-13 at 5 frames (+ at 7)
    54_831_360,                                        # layer 14: 5 frames over 20 keys
    109_969_920,                                       # layer 15: 10 frames over 40 keys
    2 * 5 * 1536 * 3 + 2 * 5 * 1536 * 384,            # the reduction's depthwise and pointwise
    2 * 10 * 384 * 35,                                 # the head
]
HAND_400 = [
    2 * 40 * 160 * 162 + 2 * 40 * 81 * 64,
    2 * 40 * 44 * 32 * (11 * 21),
    2 * 13 * 34 * 64 * (32 * 11 * 11),
    2 * 13 * 2176 * 384,
    7 * 111_621_120 + 7_797_504,
    7 * 51_485_184 + 3_566_592,
    64_037_376,                                        # 6 frames over 21 keys
    137_712_384,                                       # 13 frames over 43 keys
    2 * 6 * 1536 * 3 + 2 * 6 * 1536 * 384,
    2 * 13 * 384 * 35,
]


def full_layer(t, tkv, recompute, d=384, f=1536, k=31):
    ff = 2 * (2 * t * d * 2 * f + 2 * t * f * d)
    att = 2 * tkv * d * d + 2 * t * tkv * d + 2 * t * d * d
    if recompute:
        att += 2 * t * d * d + 2 * tkv * d * d + 2 * t * tkv * d
    conv = 2 * t * d * 2 * d + 2 * t * d * k + 2 * t * d * d
    return ff + att + conv


def test_layer_terms():
    assert full_layer(10, 10, False) == 85_839_360
    assert full_layer(10, 10, True) - full_layer(10, 10, False) == 5_975_040
    assert full_layer(5, 5, False) == 42_900_480
    assert full_layer(5, 20, True) == 54_831_360
    assert full_layer(10, 40, True) == 109_969_920
    assert full_layer(13, 13, False) == 111_621_120
    assert full_layer(6, 21, True) == 64_037_376
    assert full_layer(13, 43, True) == 137_712_384


@pytest.mark.parametrize("name, hand", [("t-one-300ms", HAND_300), ("t-one-400ms", HAND_400)])
def test_chunk_flops(name, hand):
    assert chunk_flops(sizes(model(name))) == sum(hand)


def test_b1_bound_matches_the_kernel_table():
    h100 = PEAKS["NVIDIA H100 80GB HBM3"]
    # PERF.md's bound column: 0.00167 ms at M = 640, 0.06902 ms at M = 33,280
    # (bytes bound: av, W2, the bias and y once at 3.35 TB/s).
    assert b1_bound_s(640, 1536, 384, h100) * 1e3 == pytest.approx(0.00167, abs=5e-6)
    assert b1_bound_s(33280, 1536, 384, h100) * 1e3 == pytest.approx(0.06902, abs=5e-6)
    assert b1_bytes(640, 1536, 384) == 640 * 3072 * 2 + 1536 * 384 * 2 + 384 * 4 + 640 * 384 * 2
    # where operations bind: a very tall launch is still bytes-bound at F = 1,536
    m = 1 << 20
    assert b1_bound_s(m, 1536, 384, h100) == pytest.approx(b1_bytes(m, 1536, 384) / 3.35e12)
