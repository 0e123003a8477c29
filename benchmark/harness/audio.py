"""Speech-like audio made from a seed (numpy only: the load clients import
it too).

A pool of 8 kHz mono int16 audio: phrases of voiced sound (a glottal
pitch track with vibrato; its harmonics shaped by three drifting formants;
a 3-5 Hz syllabic envelope; a little noise) separated by pauses of
0.2-1.2 s, so that the model's splitter closes phrases as it does on
telephone speech, over a line's noise floor.  Recordings and turns are cut from the pool at offsets
and gains drawn from the run's seed.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 8000
PEAK = 16000.0   # the pool's largest magnitude before a gain
NOISE = 30.0     # the noise floor's standard deviation


def _phrase(rng: np.random.Generator, seconds: float) -> np.ndarray:
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(95, 220) * (1 + 0.03 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)) \
        * np.linspace(1.0, rng.uniform(0.85, 1.15), n)
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    formants = [(np.linspace(c, c * rng.uniform(0.85, 1.15), n), rng.uniform(60, 160))
                for c in (rng.uniform(300, 900), rng.uniform(900, 1800), rng.uniform(1800, 3200))]
    out = np.zeros(n)
    for k in range(1, int(3800 // f0.max()) + 1):
        amp = sum(np.exp(-0.5 * ((k * f0 - c) / bw) ** 2) for c, bw in formants) / k ** 0.5
        out += amp * np.sin(k * phase)
    out += 0.02 * rng.standard_normal(n)
    syllables = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 5) * t + rng.uniform(0, 2 * np.pi))
    edge = np.minimum(1.0, np.minimum(t, seconds - t) / 0.08)
    out *= syllables * edge
    return out / (np.abs(out).max() or 1.0)


def pool(seed: int, seconds: float, n_phrases: int = 48) -> np.ndarray:
    """``seconds`` of speech-like int16 audio from ``seed``: ``n_phrases``
    distinct phrases of 1-4 s, repeated in a seeded order at seeded levels
    with pauses between them."""
    rng = np.random.default_rng([int(seed), 7])
    phrases = [_phrase(rng, rng.uniform(1.0, 4.0)) for _ in range(n_phrases)]
    parts, total = [], 0
    while total < seconds * SAMPLE_RATE:
        p = phrases[rng.integers(n_phrases)] * rng.uniform(0.4, 1.0)
        pause = np.zeros(int(rng.uniform(0.2, 1.2) * SAMPLE_RATE))
        parts += [p, pause]
        total += len(p) + len(pause)
    out = np.concatenate(parts)[: int(seconds * SAMPLE_RATE)] * PEAK
    # a line's noise floor: no two stretches of the pool are alike, pauses too
    out += rng.normal(0.0, NOISE, len(out))
    return np.clip(out, -32768, 32767).astype(np.int16)


def cut(audio_pool: np.ndarray, offset: int, n: int, gain: float) -> np.ndarray:
    """``n`` samples of the pool from ``offset`` (wrapping round), scaled."""
    idx = (offset + np.arange(n)) % len(audio_pool)
    return np.clip(audio_pool[idx].astype(np.float32) * gain, -32768, 32767).astype(np.int16)
