"""Bundled example audio, synthesized deterministically.

The reference ships two recorded FLACs in-package
(reference tone/demo/read_audio.py:17-22: audio_short.flac ~6.4 s,
audio_long.flac ~2 min of telephony speech).  This package instead *bakes*
its examples on first use: deterministic speech-shaped audio (glottal-pulse
excitation through moving formant resonators, phrase-length pauses) written
as real FLAC files via the first-party encoder — so demos, the web client,
and the test-suite run with zero external assets and the whole
decode→frontend→splitter path is exercised end-to-end.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["example_path", "synthesize_speech_like"]

EXAMPLES_DIR = Path(__file__).parent / "examples"
_SR = 8000

# (name, seed, phrase lengths in seconds)
_SPECS = {
    "audio_short.flac": (0, (2.1, 2.6)),
    "audio_long.flac": (1, (3.0, 2.2, 4.1, 2.7, 3.4, 2.0, 3.8, 2.9,
                            3.1, 2.4, 3.6, 2.2, 4.0, 2.6, 3.2, 2.8)),
}


def _phrase(rng: np.random.Generator, duration: float) -> np.ndarray:
    """Speech-shaped audio: pulse-train excitation filtered through a few
    slowly-moving resonators, with syllabic amplitude modulation."""
    n = int(duration * _SR)
    t = np.arange(n) / _SR
    # glottal-ish excitation: pulse train with vibrato + noise floor
    f0 = rng.uniform(95, 220)
    vibrato = 1 + 0.03 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
    phase = np.cumsum(f0 * vibrato) / _SR
    excitation = (np.mod(phase, 1.0) < 0.1).astype(np.float64)
    excitation += 0.05 * rng.standard_normal(n)
    # two-pole resonators at moving formant frequencies
    out = np.zeros(n)
    for lo, hi in ((300, 900), (900, 1800), (1800, 3200)):
        freq = rng.uniform(lo, hi)
        drift = np.linspace(0, rng.uniform(-0.15, 0.15) * freq, n)
        w = 2 * np.pi * (freq + drift) / _SR
        r = 0.985
        y = np.zeros(n + 2)
        a1, a2 = 2 * r * np.cos(w), -(r * r)
        for i in range(n):  # short sequences; clarity over vectorization
            y[i + 2] = excitation[i] + a1[i] * y[i + 1] + a2 * y[i]
        out += y[2:] / (3.0 / (1 - r))
    # syllabic envelope (3-5 Hz) with soft phrase onset/offset
    syll = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 5) * t
                                + rng.uniform(0, 2 * np.pi))
    edge = np.minimum(1.0, np.minimum(t, duration - t) / 0.08)
    out = out * syll * edge
    peak = np.abs(out).max() or 1.0
    return out / peak * rng.uniform(0.35, 0.6)


def synthesize_speech_like(seed: int, phrase_durations: tuple[float, ...],
                           gap: float = 0.8) -> np.ndarray:
    """Deterministic multi-phrase speech-shaped int16 audio @ 8 kHz.

    Gaps exceed the splitter's 600 ms silence threshold so phrase
    segmentation fires on this audio just as on real speech."""
    rng = np.random.default_rng(seed)
    silence = np.zeros(int(gap * _SR))
    parts = [silence[: _SR // 2]]
    for d in phrase_durations:
        parts.append(_phrase(rng, d))
        parts.append(silence)
    audio = np.concatenate(parts)
    return np.round(audio * 32767).astype(np.int16)


def _writable_examples_dir() -> Path:
    """The package dir when writable (dev checkout), else a user cache dir
    (installed wheel in read-only site-packages)."""
    try:
        EXAMPLES_DIR.mkdir(parents=True, exist_ok=True)
        probe = EXAMPLES_DIR / ".write-probe"
        probe.touch()
        probe.unlink()
        return EXAMPLES_DIR
    except OSError:
        import os

        cache_root = Path(os.environ.get("XDG_CACHE_HOME",
                                         Path.home() / ".cache"))
        fallback = cache_root / "tone_tpu_torch" / "examples"
        fallback.mkdir(parents=True, exist_ok=True)
        return fallback


def example_path(name: str) -> Path:
    """Path to a bundled example FLAC, baking it on first use."""
    if name not in _SPECS:
        raise KeyError(f"unknown example {name!r}; have {sorted(_SPECS)}")
    path = EXAMPLES_DIR / name
    if not path.exists():
        from tone_tpu_torch.audio.flac_write import encode_flac

        directory = _writable_examples_dir()
        path = directory / name
        if not path.exists():
            seed, durations = _SPECS[name]
            tmp = path.with_suffix(".tmp")
            encode_flac(tmp, synthesize_speech_like(seed, durations), _SR)
            tmp.replace(path)  # atomic under concurrent first use
    return path
