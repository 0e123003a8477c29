"""Audio I/O for the streaming ASR pipeline.

API parity with the reference (tone/demo/read_audio.py): ``read_audio``,
``read_example_audio``, ``read_stream_audio``, ``read_stream_example_audio``.
The reference defines ``read_stream_audio`` twice, silently dropping the
``chunk_size`` parameter (read_audio.py:56 vs :78) — a live bug; here a
single definition keeps the optional ``chunk_size``.

Decoding: built-in FLAC (tone_tpu_torch.audio.flac) and WAV (stdlib) decoders, an
optional ``miniaudio`` fallback for other containers when installed, and
polyphase resampling to mono 16-bit @ 8 kHz.
"""

from __future__ import annotations

import wave
from math import gcd
from pathlib import Path
from typing import TYPE_CHECKING, Iterator

import numpy as np

if TYPE_CHECKING:
    import numpy.typing as npt



def _resample_to(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample float array along axis 0."""
    if sr_in == sr_out:
        return x
    try:
        from scipy.signal import resample_poly

        g = gcd(sr_in, sr_out)
        return resample_poly(x, sr_out // g, sr_in // g, axis=0)
    except ImportError:
        # Linear-interpolation fallback (no scipy).
        n_out = int(round(len(x) * sr_out / sr_in))
        t = np.linspace(0.0, len(x) - 1, n_out)
        return np.interp(t, np.arange(len(x)), x)


def _decode_any(path: Path) -> tuple[np.ndarray, int]:
    """Decode to (float samples (n, ch) in int16 scale, sample_rate)."""
    suffix = path.suffix.lower()
    if suffix == ".flac":
        from tone_tpu_torch.audio.flac import decode_flac

        samples, sr = decode_flac(path)
        return samples.astype(np.float64), sr
    if suffix in (".wav", ".wave"):
        with wave.open(str(path), "rb") as w:
            sr = w.getframerate()
            n_ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
        if width == 2:
            samples = np.frombuffer(raw, np.int16).astype(np.float64)
        elif width == 1:
            samples = (np.frombuffer(raw, np.uint8).astype(np.float64) - 128.0) * 256.0
        elif width == 4:
            samples = np.frombuffer(raw, np.int32).astype(np.float64) / 65536.0
        else:
            raise ValueError(f"unsupported WAV sample width {width}")
        return samples.reshape(-1, n_ch), sr
    try:
        import miniaudio

        audio = miniaudio.decode_file(str(path), nchannels=1, sample_rate=8000)
        return np.asarray(audio.samples, np.float64).reshape(-1, 1), audio.sample_rate
    except ImportError as e:
        raise ValueError(
            f"Unsupported audio container {suffix!r}: built-in decoders cover "
            ".flac and .wav; install 'miniaudio' for other formats.") from e


def read_audio(path_to_file: Path | str, sample_rate: int = 8000) -> "npt.NDArray[np.int32]":
    """Load an audio file as mono 16-bit @ ``sample_rate`` (int32 array).

    Mirrors reference ``read_audio`` (tone/demo/read_audio.py:25-53): decode,
    mix down to mono, resample to 8 kHz, clip to int16 range, return int32.
    """
    path = Path(path_to_file)
    samples, sr = _decode_any(path)
    mono = samples.mean(axis=1) if samples.ndim == 2 else samples
    mono = _resample_to(mono, sr, sample_rate)
    mono = np.clip(np.round(mono), -32768, 32767)
    return mono.astype(np.int16).astype(np.int32)


def read_example_audio(*, long_audio: bool = False) -> "npt.NDArray[np.int32]":
    """Get one of the two bundled example audio files (synthesized
    deterministically on first use — self-contained, no external assets)."""
    from tone_tpu_torch.audio.examples import example_path

    name = "audio_long.flac" if long_audio else "audio_short.flac"
    return read_audio(example_path(name))


def _stream_chunks(audio: np.ndarray, chunk_size: int, padding: int) -> Iterator[np.ndarray]:
    audio = np.pad(audio, (padding, padding))
    for i in range(0, len(audio), chunk_size):
        chunk = audio[i:i + chunk_size]
        yield np.pad(chunk, (0, -len(chunk) % chunk_size))


def read_stream_audio(path_to_file: Path | str, chunk_size: int | None = None) -> Iterator["npt.NDArray[np.int32]"]:
    """Stream a file as fixed-size padded chunks for the pipeline."""
    from tone_tpu_torch.pipeline import StreamingCTCPipeline

    if chunk_size is None:
        chunk_size = StreamingCTCPipeline.CHUNK_SIZE
    audio = read_audio(path_to_file)
    yield from _stream_chunks(audio, chunk_size, StreamingCTCPipeline.PADDING)


def read_stream_example_audio(*, long_audio: bool = False, chunk_size: int | None = None) -> Iterator["npt.NDArray[np.int32]"]:
    """Stream one of the bundled example audio files as padded chunks."""
    from tone_tpu_torch.pipeline import StreamingCTCPipeline

    if chunk_size is None:
        chunk_size = StreamingCTCPipeline.CHUNK_SIZE
    audio = read_example_audio(long_audio=long_audio)
    yield from _stream_chunks(audio, chunk_size, StreamingCTCPipeline.PADDING)
