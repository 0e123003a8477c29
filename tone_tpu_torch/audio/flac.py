"""A self-contained FLAC decoder (pure Python, stdlib only).

The reference delegates audio decoding to the C ``miniaudio`` library
(tone/demo/read_audio.py:41-53); that library is not a dependency of this
package, and the bundled example fixtures are FLAC, so we implement the
format directly from the FLAC specification (RFC 9639).

Supports the full fixed-blocksize and variable-blocksize streams produced by
libFLAC: constant / verbatim / fixed (orders 0-4) / LPC subframes, Rice
partitions (method 0 and 1), wasted bits, and all stereo decorrelation modes
(independent, left-side, right-side, mid-side).  Sufficient for arbitrary
FLAC files, not just the fixtures.

Decoding is host-side I/O — not performance-critical (the device never sees
encoded audio) — so clarity wins over speed here.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["FlacInfo", "decode_flac", "read_flac_info"]


@dataclass
class FlacInfo:
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int


class _BitReader:
    __slots__ = ("data", "pos", "bitpos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos  # byte position
        self.bitpos = 0  # bit within byte (0 = MSB)

    def read_uint(self, nbits: int) -> int:
        result = 0
        data, pos, bitpos = self.data, self.pos, self.bitpos
        while nbits > 0:
            avail = 8 - bitpos
            take = min(avail, nbits)
            byte = data[pos]
            shift = avail - take
            bits = (byte >> shift) & ((1 << take) - 1)
            result = (result << take) | bits
            bitpos += take
            if bitpos == 8:
                bitpos = 0
                pos += 1
            nbits -= take
        self.pos, self.bitpos = pos, bitpos
        return result

    def read_sint(self, nbits: int) -> int:
        v = self.read_uint(nbits)
        if v >= (1 << (nbits - 1)):
            v -= 1 << nbits
        return v

    def read_unary(self) -> int:
        """Count zero bits until the terminating 1 bit."""
        count = 0
        data, pos, bitpos = self.data, self.pos, self.bitpos
        while True:
            byte = data[pos]
            rest = byte & ((1 << (8 - bitpos)) - 1)
            if rest == 0:
                count += 8 - bitpos
                pos += 1
                bitpos = 0
                continue
            # Position of highest set bit within remaining bits.
            hi = rest.bit_length() - 1  # bit index from LSB
            zeros = (8 - bitpos) - 1 - hi
            count += zeros
            bitpos += zeros + 1
            if bitpos == 8:
                bitpos = 0
                pos += 1
            self.pos, self.bitpos = pos, bitpos
            return count

    def align_byte(self) -> None:
        if self.bitpos:
            self.bitpos = 0
            self.pos += 1


def _read_utf8_coded_number(br: _BitReader) -> int:
    b0 = br.read_uint(8)
    if b0 < 0x80:
        return b0
    n_extra = 0
    mask = 0x40
    while b0 & mask:
        n_extra += 1
        mask >>= 1
    value = b0 & (mask - 1) if mask > 1 else 0
    for _ in range(n_extra):
        value = (value << 6) | (br.read_uint(8) & 0x3F)
    return value


_BLOCKSIZE_TABLE = [0, 192, 576, 1152, 2304, 4608, -1, -2,
                    256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
_SAMPLE_RATE_TABLE = [0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
                      32000, 44100, 48000, 96000, -1, -2, -3, -4]
_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def read_flac_info(path: str | Path) -> FlacInfo:
    data = Path(path).read_bytes()
    info, _ = _parse_header(data)
    return info


def _parse_header(data: bytes) -> tuple[FlacInfo, int]:
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream (missing fLaC marker)")
    pos = 4
    info = None
    while True:
        header = data[pos:pos + 4]
        last = bool(header[0] & 0x80)
        btype = header[0] & 0x7F
        length = int.from_bytes(header[1:4], "big")
        body = data[pos + 4: pos + 4 + length]
        if btype == 0:  # STREAMINFO
            packed = int.from_bytes(body[10:18], "big")
            info = FlacInfo(
                sample_rate=(packed >> 44) & 0xFFFFF,
                channels=((packed >> 41) & 0x7) + 1,
                bits_per_sample=((packed >> 36) & 0x1F) + 1,
                total_samples=packed & ((1 << 36) - 1),
            )
        pos += 4 + length
        if last:
            break
    if info is None:
        raise ValueError("FLAC stream has no STREAMINFO block")
    return info, pos


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read_uint(1) != 0:
        raise ValueError("invalid subframe sync bit")
    sf_type = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = br.read_unary() + 1
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        value = br.read_sint(bps)
        out = np.full(blocksize, value, dtype=np.int64)
    elif sf_type == 1:  # VERBATIM
        out = np.array([br.read_sint(bps) for _ in range(blocksize)], dtype=np.int64)
    elif 8 <= sf_type <= 12:  # FIXED, order 0-4
        order = sf_type - 8
        warmup = [br.read_sint(bps) for _ in range(order)]
        resid = _decode_residual(br, blocksize, order)
        out = _restore_lpc(warmup, resid, _FIXED_COEFFS[order], 0)
    elif sf_type >= 32:  # LPC
        order = (sf_type & 0x1F) + 1
        warmup = [br.read_sint(bps) for _ in range(order)]
        precision = br.read_uint(4) + 1
        shift = br.read_sint(5)
        coeffs = [br.read_sint(precision) for _ in range(order)]
        resid = _decode_residual(br, blocksize, order)
        out = _restore_lpc(warmup, resid, coeffs, shift)
    else:
        raise ValueError(f"reserved subframe type {sf_type}")

    if wasted:
        out = out << wasted
    return out


def _decode_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read_uint(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    partition_order = br.read_uint(4)
    n_partitions = 1 << partition_order
    part_len = blocksize >> partition_order
    out = np.empty(blocksize - order, dtype=np.int64)
    idx = 0
    for p in range(n_partitions):
        count = part_len - (order if p == 0 else 0)
        param = br.read_uint(param_bits)
        if param == escape:
            raw_bits = br.read_uint(5)
            for i in range(count):
                out[idx + i] = br.read_sint(raw_bits) if raw_bits else 0
        else:
            for i in range(count):
                q = br.read_unary()
                r = br.read_uint(param) if param else 0
                v = (q << param) | r
                out[idx + i] = (v >> 1) ^ -(v & 1)  # zigzag
        idx += count
    return out


def _restore_lpc(warmup: list[int], resid: np.ndarray, coeffs: list[int], shift: int) -> np.ndarray:
    order = len(warmup)
    n = order + len(resid)
    out = np.empty(n, dtype=np.int64)
    out[:order] = warmup
    if order == 0:
        out[:] = resid
        return out
    c = coeffs
    for i in range(order, n):
        acc = 0
        for j in range(order):
            acc += c[j] * out[i - 1 - j]
        out[i] = resid[i - order] + (acc >> shift)
    return out


def _crc16(data: bytes) -> int:
    """CRC-16 with polynomial 0x8005 (x^16 + x^15 + x^2 + 1), init 0."""
    crc = 0
    table = _CRC16_TABLE
    for byte in data:
        crc = ((crc << 8) & 0xFFFF) ^ table[((crc >> 8) ^ byte) & 0xFF]
    return crc


def _make_crc16_table() -> list[int]:
    table = []
    for i in range(256):
        crc = i << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005 if crc & 0x8000 else crc << 1) & 0xFFFF
        table.append(crc)
    return table


_CRC16_TABLE = _make_crc16_table()


def decode_flac(path: str | Path, verify_crc: bool = True) -> tuple[np.ndarray, int]:
    """Decode a FLAC file.

    Every frame's CRC-16 is verified by default — a decode that returns is a
    decode whose bitstream parsing was bit-exact.

    Returns:
        (samples (n, channels) int32 at native bit depth, sample_rate).
    """
    data = Path(path).read_bytes()
    info, pos = _parse_header(data)
    channels_out: list[np.ndarray] = []
    blocks: list[np.ndarray] = []

    while pos < len(data):
        # Skip any trailing junk (ID3, padding) that isn't a frame sync.
        if pos + 2 > len(data):
            break
        sync = (data[pos] << 8) | data[pos + 1]
        if (sync >> 2) != 0x3FFE:
            break

        br = _BitReader(data, pos)
        br.read_uint(14)  # sync
        br.read_uint(1)  # reserved
        br.read_uint(1)  # blocking strategy
        bs_code = br.read_uint(4)
        sr_code = br.read_uint(4)
        ch_code = br.read_uint(4)
        bps_code = br.read_uint(3)
        br.read_uint(1)  # reserved
        _read_utf8_coded_number(br)  # frame/sample number

        blocksize = _BLOCKSIZE_TABLE[bs_code]
        if blocksize == -1:
            blocksize = br.read_uint(8) + 1
        elif blocksize == -2:
            blocksize = br.read_uint(16) + 1
        elif blocksize == 0:
            raise ValueError("reserved blocksize code")

        sr = _SAMPLE_RATE_TABLE[sr_code]
        if sr == -1:
            br.read_uint(8)
        elif sr == -2:
            br.read_uint(16)
        elif sr == -3:
            br.read_uint(16)

        bps = {0: info.bits_per_sample, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}[bps_code]
        br.read_uint(8)  # CRC-8 (not verified)

        if ch_code < 8:
            n_ch = ch_code + 1
            subs = [_decode_subframe(br, blocksize, bps) for _ in range(n_ch)]
        elif ch_code == 8:  # left-side
            left = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            subs = [left, left - side]
        elif ch_code == 9:  # right-side
            side = _decode_subframe(br, blocksize, bps + 1)
            right = _decode_subframe(br, blocksize, bps)
            subs = [right + side, right]
        elif ch_code == 10:  # mid-side
            mid = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            left = (((mid << 1) | (side & 1)) + side) >> 1
            right = (((mid << 1) | (side & 1)) - side) >> 1
            subs = [left, right]
        else:
            raise ValueError(f"reserved channel assignment {ch_code}")

        br.align_byte()
        expected_crc = br.read_uint(16)
        if verify_crc and _crc16(data[pos:br.pos - 2]) != expected_crc:
            raise ValueError(f"FLAC frame CRC-16 mismatch at byte {pos}")
        pos = br.pos

        blocks.append(np.stack(subs, axis=1))

    if not blocks:
        raise ValueError("no FLAC frames decoded")
    samples = np.concatenate(blocks, axis=0)
    if info.total_samples:
        samples = samples[: info.total_samples]
    return samples.astype(np.int32), info.sample_rate
