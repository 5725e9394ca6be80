"""NAL unit encapsulation: emulation-prevention escaping + Annex-B framing.

Reference: common/bitstream.c:55 `x264_nal_encode` (escape is an asm slot in
`x264_bitstream_function_t`). Here the escape scan is vectorized with numpy —
the host-side analogue of that SIMD slot.

The port's own copy of `x264_tpu/entropy/nal.py` (host code,
no JAX), kept line for line so that the port imports nothing of
`x264_tpu`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# nal_unit_type (H.264 7.4.1)
NAL_UNKNOWN = 0
NAL_SLICE = 1
NAL_SLICE_DPA = 2
NAL_SLICE_DPB = 3
NAL_SLICE_DPC = 4
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9
NAL_FILLER = 12

# nal_ref_idc
NAL_PRIORITY_DISPOSABLE = 0
NAL_PRIORITY_LOW = 1
NAL_PRIORITY_HIGH = 2
NAL_PRIORITY_HIGHEST = 3


@dataclass
class NAL:
    type: int
    ref_idc: int
    payload: bytes          # escaped payload incl. header byte (no startcode)
    b_long_startcode: bool = True


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte before any 00 00 0x(0..3).

    Vectorized: find positions where two zero bytes are followed by a byte
    <= 3 and splice in 0x03. (reference: nal_escape_c, bitstream.c:35)
    """
    buf = np.frombuffer(rbsp, dtype=np.uint8)
    n = buf.size
    if n < 3:
        return rbsp
    # We must scan left-to-right because an inserted 0x03 breaks the zero run.
    # Equivalent rule without sequential state: position i needs escaping iff
    # buf[i] <= 3 and buf[i-1] == 0 and buf[i-2] == 0 and the number of
    # consecutive zeros ending at i-1 is exactly 2 or the run is longer —
    # for longer zero runs (000000...) escapes go after every 2 zeros.
    # Simplest correct vectorized form: iterate over match positions, which
    # are rare in real streams, fixing up run interactions.
    out = bytearray()
    i = 0
    data = rbsp
    while True:
        # find next candidate with numpy from current offset
        sub = buf[i:]
        if sub.size < 3:
            break
        cand = np.flatnonzero(
            (sub[:-2] == 0) & (sub[1:-1] == 0) & (sub[2:] <= 3))
        if cand.size == 0:
            break
        k = i + int(cand[0])  # escape needed before byte k+2
        out += data[i:k + 2]
        out.append(3)
        i = k + 2
    out += data[i:]
    return bytes(out)


def nal_encode(nal_type: int, ref_idc: int, rbsp: bytes,
               long_startcode: bool = True) -> NAL:
    header = bytes([(ref_idc << 5) | nal_type])
    return NAL(nal_type, ref_idc, header + escape_rbsp(rbsp),
               long_startcode)


def annexb_bytes(nals: list[NAL]) -> bytes:
    out = bytearray()
    for nal in nals:
        out += b"\x00\x00\x00\x01" if nal.b_long_startcode else b"\x00\x00\x01"
        out += nal.payload
    return bytes(out)


def unescape_rbsp(data: bytes) -> bytes:
    """Remove emulation prevention bytes (for the reference decoder)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size < 3:
        return data
    drop = np.zeros(buf.size, dtype=bool)
    esc = np.flatnonzero((buf[:-2] == 0) & (buf[1:-1] == 0) & (buf[2:] == 3))
    # only drop a 0x03 if it is genuinely an escape (followed by <= 3) —
    # per spec an encoder only inserts before 00-03; any 000003 in the
    # stream IS an escape.
    prev_end = -10
    for k in esc:
        k = int(k)
        if k >= prev_end:   # don't double-count overlapping 0 runs
            drop[k + 2] = True
            prev_end = k + 3
    return buf[~drop].tobytes()


def split_annexb(data: bytes) -> list[bytes]:
    """Split an Annex-B stream into raw NAL payloads (escaped, w/ header)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    # find 00 00 01 start codes
    idx = np.flatnonzero((arr[:-2] == 0) & (arr[1:-1] == 0) & (arr[2:] == 1))
    # remove overlapping matches (00 00 00 01 yields match at both i and i+1)
    starts = []
    last = -3
    for i in idx:
        i = int(i)
        if i >= last + 3 or (starts and i == last + 1):
            pass
        starts.append(i)
        last = i
    # filter: a start code match inside a previous startcode region
    clean = []
    prev = -5
    for s in starts:
        if s <= prev + 2:
            continue
        clean.append(s)
        prev = s
    nals = []
    for n, s in enumerate(clean):
        payload_start = s + 3
        end = clean[n + 1] if n + 1 < len(clean) else len(data)
        # strip the extra 00 of a 4-byte startcode from the previous NAL end
        seg = data[payload_start:end]
        # trailing zeros before the next startcode belong to the startcode
        while seg and seg[-1] == 0 and n + 1 < len(clean):
            seg = seg[:-1]
        if seg:
            nals.append(seg)
    return nals
