"""Minimal FLAC encoder (RFC 9639 subset): 16-bit PCM, verbatim subframes.

First-party counterpart of :mod:`tone_tpu_torch.audio.flac` (the decoder): enough
of the format to produce valid, decoder-verified .flac files for bundled
fixtures and round-trip tests — compression is not the goal (verbatim
subframes store raw samples), correctness of headers/CRCs/MD5 is.
"""

from __future__ import annotations

import hashlib
import struct
from pathlib import Path

import numpy as np

__all__ = ["encode_flac"]

_BLOCKSIZE = 4096


class _BitWriter:
    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write_uint(self, value: int, nbits: int) -> None:
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def align_byte(self) -> None:
        if self._nbits:
            self.write_uint(0, 8 - self._nbits)

    def bytes(self) -> bytes:
        assert self._nbits == 0
        return bytes(self._buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07 if crc & 0x80 else crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005 if crc & 0x8000 else crc << 1) & 0xFFFF
    return crc


def _utf8_coded(value: int) -> bytes:
    """FLAC's UTF-8-style frame-number coding."""
    if value < 0x80:
        return bytes([value])
    out = []
    nbytes = 2
    while value >= (1 << (nbytes * 5 + 1)) and nbytes < 7:
        nbytes += 1
    lead = (0xFF << (8 - nbytes)) & 0xFF
    shift = 6 * (nbytes - 1)
    out.append(lead | (value >> shift))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((value >> shift) & 0x3F))
    return bytes(out)


def encode_flac(path: str | Path, samples: np.ndarray, sample_rate: int = 8000) -> None:
    """Write mono/stereo 16-bit PCM as a FLAC file (verbatim subframes)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape
    if not 1 <= channels <= 2:
        raise ValueError(f"1 or 2 channels supported, got {channels}")
    pcm = np.clip(samples, -32768, 32767).astype("<i2")

    md5 = hashlib.md5(pcm.tobytes()).digest()
    frames = []
    for frame_no, start in enumerate(range(0, n, _BLOCKSIZE)):
        block = pcm[start:start + _BLOCKSIZE]
        bs = len(block)
        header = bytearray()
        header += b"\xff\xf8"  # sync + fixed blocking
        # blocksize code 7 (16-bit at end), sample-rate code 0 (STREAMINFO)
        header.append((0b0111 << 4) | 0b0000)
        # channel assignment (channels-1), sample size 16-bit (0b100)
        header.append(((channels - 1) << 4) | (0b100 << 1))
        header += _utf8_coded(frame_no)
        header += struct.pack(">H", bs - 1)
        header.append(_crc8(bytes(header)))

        bw = _BitWriter()
        for ch in range(channels):
            bw.write_uint(0b00000010, 8)  # 0 | type=000001 verbatim | wasted=0
            col = block[:, ch].astype(np.int64)
            for s in col:
                bw.write_uint(int(s) & 0xFFFF, 16)
        bw.align_byte()
        body = bytes(header) + bw.bytes()
        frames.append(body + struct.pack(">H", _crc16(body)))

    frame_sizes = [len(f) for f in frames] or [0]
    streaminfo = _BitWriter()
    streaminfo.write_uint(_BLOCKSIZE, 16)          # min blocksize
    streaminfo.write_uint(_BLOCKSIZE, 16)          # max blocksize
    streaminfo.write_uint(min(frame_sizes), 24)
    streaminfo.write_uint(max(frame_sizes), 24)
    streaminfo.write_uint(sample_rate, 20)
    streaminfo.write_uint(channels - 1, 3)
    streaminfo.write_uint(16 - 1, 5)
    streaminfo.write_uint(n, 36)
    info = streaminfo.bytes() + md5

    out = bytearray(b"fLaC")
    out.append(0x80)  # last metadata block, type 0 (STREAMINFO)
    out += struct.pack(">I", len(info))[1:]
    out += info
    for f in frames:
        out += f
    Path(path).write_bytes(bytes(out))
