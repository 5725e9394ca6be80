"""Bit-level writers.

Two implementations of the reference `bs_t` bit writer
(reference: common/bitstream.h):

* `BitWriter` — simple scalar writer for headers (SPS/PPS/slice headers),
  where throughput doesn't matter.
* `pack_codes` — vectorized packer: given parallel numpy arrays of
  (code, length) syntax elements in stream order, concatenates them into a
  byte buffer in O(total_bits) numpy work. This is how the TPU build writes
  MB-layer CAVLC: the device produces per-block syntax elements as tensors,
  the host packs them without a per-element Python loop.

All codes are MSB-first as H.264 requires.

The port's own copy of `x264_tpu/entropy/bits.py` (host code,
no JAX), kept line for line so that the port imports nothing of
`x264_tpu`.
"""

from __future__ import annotations

import numpy as np


def ue_len(v: np.ndarray) -> np.ndarray:
    """Bit length of unsigned Exp-Golomb code for v >= 0 (vectorized)."""
    v = np.asarray(v, dtype=np.int64)
    nbits = np.int64(64) - _clz64(v + 1)
    return (2 * nbits - 1).astype(np.int32)


def _clz64(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of positive int64 (vectorized)."""
    x = np.asarray(x, dtype=np.uint64)
    # bit_length via float log2 is unsafe near powers of two; do it exactly.
    n = np.zeros(x.shape, dtype=np.int64)
    v = x.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        has = v >= (np.uint64(1) << np.uint64(shift))
        n = np.where(has, n + shift, n)
        v = np.where(has, v >> np.uint64(shift), v)
    return 64 - (n + 1)  # leading zeros of x (x>0)


def ue_code(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unsigned Exp-Golomb (code_value, bit_length), vectorized.

    code = v+1 written with 2*ceil(log2(v+2))-1 ... spec: (len(v+1)-1) zeros
    then v+1 in binary.
    """
    v = np.asarray(v, dtype=np.int64)
    code = (v + 1).astype(np.uint64)
    return code, ue_len(v)


def se_code(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Signed Exp-Golomb: maps v -> 2|v|-1 for v>0, -2v for v<=0."""
    v = np.asarray(v, dtype=np.int64)
    m = np.where(v <= 0, -2 * v, 2 * v - 1)
    return ue_code(m)


class BitWriter:
    """Scalar MSB-first bit writer (reference bs_t, common/bitstream.h:59)."""

    def __init__(self) -> None:
        self._acc = 0          # pending bits, MSB side
        self._nbits = 0
        self._bytes = bytearray()

    def write(self, nbits: int, value: int) -> None:
        assert 0 <= nbits <= 56 and 0 <= value < (1 << max(nbits, 1)), \
            (nbits, value)
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write1(self, bit: int) -> None:
        self.write(1, bit)

    def write_ue(self, v: int) -> None:
        code, length = ue_code(np.int64(v))
        self.write(int(length), int(code))

    def write_se(self, v: int) -> None:
        code, length = se_code(np.int64(v))
        self.write(int(length), int(code))

    def write_te(self, x: int, v: int) -> None:
        """Truncated Exp-Golomb (for ref_idx with 2 options)."""
        if x == 1:
            self.write1(1 - v)
        elif x > 1:
            self.write_ue(v)

    def rbsp_trailing(self) -> None:
        """rbsp_stop_one_bit + alignment zeros."""
        self.write1(1)
        if self._nbits:
            self.write(8 - self._nbits, 0)

    def align_10(self) -> None:
        self.rbsp_trailing()

    def byte_align_zero(self) -> None:
        if self._nbits:
            self.write(8 - self._nbits, 0)

    def byte_align_one(self) -> None:
        """cabac_alignment_one_bit padding (spec 7.3.4)."""
        while self._nbits:
            self.write1(1)

    @property
    def bit_pos(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "bitstream not byte-aligned"
        return bytes(self._bytes)

    def extend_bytes(self, data: bytes) -> None:
        assert self._nbits == 0, "must be byte-aligned to append bytes"
        self._bytes.extend(data)

    def append_packed(self, codes: np.ndarray, lengths: np.ndarray) -> None:
        """Append a vectorized run of syntax elements (must currently be
        byte-aligned is NOT required: handles bit offset)."""
        payload_bits, total = pack_codes_to_bits(codes, lengths)
        # feed bits through the accumulator in 32-bit chunks
        # simple approach: prepend pending bits then pack all
        if self._nbits:
            pend = np.array(
                [(self._acc >> (self._nbits - 1 - i)) & 1
                 for i in range(self._nbits)], dtype=np.uint8)
            payload_bits = np.concatenate([pend, payload_bits])
            total += self._nbits
            self._acc = 0
            self._nbits = 0
        nbytes, rem = divmod(total, 8)
        if rem:
            tailbits = payload_bits[total - rem:total]
            tail = 0
            for b_ in tailbits:
                tail = (tail << 1) | int(b_)
            self._acc, self._nbits = tail, rem
        head = payload_bits[:nbytes * 8]
        self._bytes.extend(np.packbits(head).tobytes())


def append_bitstring(bw: "BitWriter", data: bytes, nbits: int) -> None:
    """Append `nbits` bits (MSB-first packed in `data`) to a BitWriter at an
    arbitrary bit offset. Vectorized byte-shift merge."""
    if nbits == 0:
        return
    a = np.frombuffer(data, dtype=np.uint8)[: (nbits + 7) // 8]
    s = bw._nbits
    if s == 0:
        full, rem = divmod(nbits, 8)
        bw._bytes.extend(a[:full].tobytes())
        if rem:
            bw._acc = int(a[full]) >> (8 - rem)
            bw._nbits = rem
        return
    # shift the payload right by s bits and merge with pending acc
    hi = (a >> s).astype(np.uint8)
    lo = ((a.astype(np.uint16) << (8 - s)) & 0xFF).astype(np.uint8)
    merged = hi.copy()
    merged[0] |= (bw._acc << (8 - s)) & 0xFF
    merged[1:] |= lo[:-1]
    total = s + nbits
    full, rem = divmod(total, 8)
    bw._acc = 0
    bw._nbits = 0
    if full:
        bw._bytes.extend(merged[:full].tobytes())
    if rem:
        # remaining bits: bits [full*8, total) of the merged stream
        if full < len(merged):
            tailbyte = int(merged[full])
        else:
            tailbyte = int(lo[-1])
        bw._acc = tailbyte >> (8 - rem)
        bw._nbits = rem


def pack_codes_to_bits(codes: np.ndarray,
                       lengths: np.ndarray) -> tuple[np.ndarray, int]:
    """Expand (code, length) pairs into a flat bit array (uint8 0/1).

    codes: uint64 array; lengths: int array (0 entries are skipped).
    Returns (bits, total_bits).
    """
    codes = np.asarray(codes, dtype=np.uint64).ravel()
    lengths = np.asarray(lengths, dtype=np.int64).ravel()
    keep = lengths > 0
    codes, lengths = codes[keep], lengths[keep]
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8), 0
    # For element i with length L, bit j (0-based from MSB of the code):
    #   bit = (code >> (L-1-j)) & 1
    # Build flat j indices: concat(arange(L_i)) via cumsum trick.
    ends = np.cumsum(lengths)
    starts = ends - lengths
    flat = np.arange(total, dtype=np.int64)
    j = flat - np.repeat(starts, lengths)
    code_rep = np.repeat(codes, lengths)
    len_rep = np.repeat(lengths, lengths)
    shift = (len_rep - 1 - j).astype(np.uint64)
    bits = ((code_rep >> shift) & np.uint64(1)).astype(np.uint8)
    return bits, total


def pack_codes(codes: np.ndarray, lengths: np.ndarray) -> tuple[bytes, int]:
    """Pack (code,length) pairs to bytes; returns (bytes, total_bits).
    Pads the final partial byte with zeros."""
    bits, total = pack_codes_to_bits(codes, lengths)
    return np.packbits(bits).tobytes(), total
