"""Container muxers: MP4 (ISO BMFF), Matroska (EBML), FLV.

Reference: output/mp4.c:348 (via l-smash), output/matroska.c:221 +
output/matroska_ebml.c:513, output/flv.c:358 + flv_bytestream.c:153, all
behind the cli_output_t vtable (output/output.h:37-44). Re-implemented
here natively from the container specs (ISO 14496-12/-15, the Matroska
EBML spec, and the Adobe FLV spec) — byte-level host work, no device
involvement.

All three store AVC samples in "AVCC" form: each NAL length-prefixed
(lengthSizeMinusOne=3), SPS/PPS out-of-band in an
AVCDecoderConfigurationRecord. NAL payloads keep their emulation
prevention bytes (ISO 14496-15 stores EBSP).
"""

from __future__ import annotations

import struct

from ..entropy import nal as nal_mod
from ..entropy.nal import NAL


# --------------------------------------------------------------------- avcC
def build_avcc(sps_payload: bytes, pps_payload: bytes) -> bytes:
    """AVCDecoderConfigurationRecord (ISO 14496-15 5.2.4.1).

    sps/pps payloads include the NAL header byte."""
    profile, compat, level = sps_payload[1], sps_payload[2], sps_payload[3]
    out = bytes([1, profile, compat, level, 0xFC | 3, 0xE0 | 1])
    out += struct.pack(">H", len(sps_payload)) + sps_payload
    out += bytes([1]) + struct.pack(">H", len(pps_payload)) + pps_payload
    return out


def split_headers(nals: list[NAL]):
    """Pick SPS/PPS out of a header NAL list; returns (sps, pps, others)."""
    sps = pps = None
    rest = []
    for n in nals:
        if n.type == nal_mod.NAL_SPS and sps is None:
            sps = n.payload
        elif n.type == nal_mod.NAL_PPS and pps is None:
            pps = n.payload
        else:
            rest.append(n)
    return sps, pps, rest


def sample_bytes(nals: list[NAL]) -> bytes:
    """One access unit in AVCC form (4-byte length prefixes)."""
    out = bytearray()
    for n in nals:
        out += struct.pack(">I", len(n.payload)) + n.payload
    return bytes(out)


def is_keyframe(nals: list[NAL]) -> bool:
    return any(n.type == nal_mod.NAL_SLICE_IDR for n in nals)


# ---------------------------------------------------------------------- MP4
def _box(tag: bytes, *payloads: bytes) -> bytes:
    body = b"".join(payloads)
    return struct.pack(">I", 8 + len(body)) + tag + body


def _full(tag: bytes, version: int, flags: int, *payloads: bytes) -> bytes:
    return _box(tag, struct.pack(">I", (version << 24) | flags),
                *payloads)


class MP4Output:
    """Progressive (non-fragmented) MP4 writer: ftyp + mdat, then moov with
    the full sample tables at close (reference output/mp4.c behavior).

    dts-compress is unnecessary here: ctts carries pts-dts offsets and an
    edit list shifts the presentation when B-frame delay appears."""

    def __init__(self, path) -> None:
        self._f = open(path, "wb") if not hasattr(path, "write") else path
        self._own = not hasattr(path, "write")
        self.bytes_written = 0
        self._sizes: list[int] = []      # per-sample byte sizes
        self._offsets: list[int] = []    # absolute file offsets
        self._dts: list[int] = []
        self._pts: list[int] = []
        self._sync: list[int] = []       # 1-based sync sample numbers
        self._dts_off = None             # shifts first dts to 0
        self._sps = self._pps = None
        self._w = self._h = 0
        self._timescale = 30
        self._delta = 1
        f = self._f
        f.write(_box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                     b"isomiso2avc1mp41"))
        self._mdat_pos = f.tell()
        f.write(struct.pack(">I", 0) + b"mdat")   # size patched at close

    def set_param(self, p) -> None:
        self._w, self._h = p.width, p.height
        # VFR (x264.h i_timebase_num/den): seconds = pts * num/den, so
        # the media timescale is tb_den and one pts unit is tb_num ticks.
        # CFR default (timebase 0/0) degenerates to fps_den/fps_num with
        # frame-index pts — the same math.
        if getattr(p, "timebase_den", 0):
            self._timescale, self._delta = p.timebase_den, p.timebase_num
        else:
            self._timescale, self._delta = p.fps_num, p.fps_den

    def write_headers(self, nals: list[NAL]) -> int:
        self._sps, self._pps, _ = split_headers(nals)
        return 0

    def write_frame(self, nals: list[NAL], pts=None, dts=None) -> int:
        data = sample_bytes(nals)
        idx = len(self._sizes)
        self._offsets.append(self._f.tell())
        self._sizes.append(len(data))
        # B-frame delay makes the encoder's first dts negative; shift the
        # whole dts timeline to start at 0 (the reference muxers'
        # dts-compress / edit-list handling), ctts keeps pts-dts offsets
        dts = idx if dts is None else dts
        if self._dts_off is None:
            self._dts_off = -dts
        self._dts.append(dts + self._dts_off)
        self._pts.append(idx if pts is None else pts)
        if is_keyframe(nals):
            self._sync.append(idx + 1)
        self._f.write(data)
        self.bytes_written += len(data)
        return len(data)

    # ---- sample tables ----
    def _stbl(self) -> bytes:
        n = len(self._sizes)
        avcc = build_avcc(self._sps, self._pps)
        avc1 = _box(
            b"avc1",
            b"\x00" * 6 + struct.pack(">H", 1),           # dref index
            b"\x00" * 16,
            struct.pack(">HH", self._w, self._h),
            struct.pack(">II", 0x480000, 0x480000),       # 72 dpi
            b"\x00" * 4,
            struct.pack(">H", 1),                          # frame count
            b"\x00" * 32,                                  # compressor
            struct.pack(">Hh", 0x18, -1),                  # depth, ctab
            _box(b"avcC", avcc))
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), avc1)
        # stts: run-length encode dts deltas; the last sample's duration
        # repeats the previous delta (the reference derives it from
        # largest/second-largest pts, output/mp4.c close)
        deltas = [(self._dts[i + 1] - self._dts[i]) * self._delta
                  for i in range(n - 1)]
        deltas.append(deltas[-1] if deltas else self._delta)
        runs = []
        for d in deltas:
            if runs and runs[-1][1] == d:
                runs[-1][0] += 1
            else:
                runs.append([1, d])
        stts = _full(b"stts", 0, 0, struct.pack(">I", len(runs)),
                     b"".join(struct.pack(">II", c, d) for c, d in runs))
        boxes = [stsd, stts]
        # ctts if any pts != dts (B-frames)
        offs = [(self._pts[i] - self._dts[i]) * self._delta
                for i in range(n)]
        if any(offs):
            shift = -min(offs) if min(offs) < 0 else 0
            cruns = []
            for o in offs:
                o += shift
                if cruns and cruns[-1][1] == o:
                    cruns[-1][0] += 1
                else:
                    cruns.append([1, o])
            boxes.append(_full(
                b"ctts", 0, 0, struct.pack(">I", len(cruns)),
                b"".join(struct.pack(">II", c, o) for c, o in cruns)))
        if self._sync and len(self._sync) < n:
            boxes.append(_full(
                b"stss", 0, 0, struct.pack(">I", len(self._sync)),
                b"".join(struct.pack(">I", s) for s in self._sync)))
        boxes.append(_full(b"stsc", 0, 0, struct.pack(">I", 1),
                           struct.pack(">III", 1, 1, 1)))
        boxes.append(_full(b"stsz", 0, 0, struct.pack(">II", 0, n),
                           b"".join(struct.pack(">I", s)
                                    for s in self._sizes)))
        boxes.append(_full(b"stco", 0, 0, struct.pack(">I", n),
                           b"".join(struct.pack(">I", o)
                                    for o in self._offsets)))
        return _box(b"stbl", *boxes)

    def close(self, largest_pts=None, second_largest_pts=None) -> None:
        f = self._f
        n = len(self._sizes)
        end = f.tell()
        f.seek(self._mdat_pos)
        f.write(struct.pack(">I", end - self._mdat_pos))
        f.seek(end)
        dur = (self._dts[-1] + 1) * self._delta if n else 0
        ts = self._timescale
        mvhd = _full(b"mvhd", 0, 0,
                     struct.pack(">IIII", 0, 0, 1000,
                                 dur * 1000 // max(ts, 1)),
                     struct.pack(">I", 0x00010000),       # rate
                     struct.pack(">H", 0x0100) + b"\x00" * 10,
                     struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                                 0x40000000),
                     b"\x00" * 24,
                     struct.pack(">I", 2))                # next track id
        # after duration: reserved u32[2], layer i16, alternate_group i16,
        # volume i16 (0 for video), reserved u16 — 16 bytes before the
        # matrix (ISO 14496-12 8.3.2)
        tkhd = _full(b"tkhd", 0, 3,
                     struct.pack(">IIIII", 0, 0, 1, 0,
                                 dur * 1000 // max(ts, 1)),
                     b"\x00" * 16,
                     struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                                 0x40000000),
                     struct.pack(">II", self._w << 16, self._h << 16))
        mdhd = _full(b"mdhd", 0, 0,
                     struct.pack(">IIII", 0, 0, ts, dur),
                     struct.pack(">HH", 0x55C4, 0))       # und language
        hdlr = _full(b"hdlr", 0, 0, b"\x00" * 4 + b"vide" + b"\x00" * 12
                     + b"x264-tpu\x00")
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full(b"url ", 0, 1)))
        vmhd = _full(b"vmhd", 0, 1, b"\x00" * 8)
        minf = _box(b"minf", vmhd, dinf, self._stbl())
        mdia = _box(b"mdia", mdhd, hdlr, minf)
        trak = _box(b"trak", tkhd, mdia)
        f.write(_box(b"moov", mvhd, trak))
        if self._own:
            f.close()


# ----------------------------------------------------------------- Matroska
def _ebml_id(i: int) -> bytes:
    return i.to_bytes((i.bit_length() + 7) // 8, "big")


def _ebml_size(n: int) -> bytes:
    """EBML variable-length size (marker bit in the top byte)."""
    for length in range(1, 9):
        if n < (1 << (7 * length)) - 1:
            return ((1 << (7 * length)) | n).to_bytes(length, "big")
    raise ValueError("size too large")


def _el(eid: int, body: bytes) -> bytes:
    return _ebml_id(eid) + _ebml_size(len(body)) + body


def _el_uint(eid: int, v: int) -> bytes:
    return _el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def _el_float(eid: int, v: float) -> bytes:
    return _el(eid, struct.pack(">d", v))


def _el_str(eid: int, s: str) -> bytes:
    return _el(eid, s.encode())


class MKVOutput:
    """Matroska writer: streaming unknown-size Segment, one Cluster per
    frame (reference output/matroska_ebml.c)."""

    UNKNOWN = b"\x01\xff\xff\xff\xff\xff\xff\xff"

    def __init__(self, path) -> None:
        self._f = open(path, "wb") if not hasattr(path, "write") else path
        self._own = not hasattr(path, "write")
        self.bytes_written = 0
        self._sps = self._pps = None
        self._w = self._h = 0
        self._fps = (25, 1)
        self._tb = (1, 25)
        self._wrote_tracks = False
        self._nframes = 0
        self._last_ms = 0
        self._dur_pos = None
        f = self._f
        f.write(_el(0x1A45DFA3,                     # EBML header
                    _el_uint(0x4286, 1) + _el_uint(0x42F7, 1)
                    + _el_uint(0x42F2, 4) + _el_uint(0x42F3, 8)
                    + _el_str(0x4282, "matroska")
                    + _el_uint(0x4287, 2) + _el_uint(0x4285, 2)))
        f.write(_ebml_id(0x18538067) + self.UNKNOWN)    # Segment

    def set_param(self, p) -> None:
        self._w, self._h = p.width, p.height
        self._fps = (p.fps_num, p.fps_den)
        # pts->seconds factor: timebase when VFR, else frame/fps
        if getattr(p, "timebase_den", 0):
            self._tb = (p.timebase_num, p.timebase_den)
        else:
            self._tb = (p.fps_den, p.fps_num)

    def write_headers(self, nals: list[NAL]) -> int:
        self._sps, self._pps, _ = split_headers(nals)
        f = self._f
        info = (_el_uint(0x2AD7B1, 1000000)              # 1 ms timescale
                + _el_str(0x4D80, "x264-tpu") + _el_str(0x5741, "x264-tpu")
                + _el_float(0x4489, 0.0))                # Duration (patched)
        f.write(_el(0x1549A966, info))
        self._dur_pos = f.tell() - 8                     # float64 position
        default_dur = int(1e9 * self._fps[1] / self._fps[0])
        track = (_el_uint(0xD7, 1) + _el_uint(0x73C5, 1)
                 + _el_uint(0x83, 1)                     # video track
                 + _el_uint(0x9C, 0)                     # no lacing
                 + _el_str(0x86, "V_MPEG4/ISO/AVC")
                 + _el(0x63A2, build_avcc(self._sps, self._pps))
                 + _el_uint(0x23E383, default_dur)
                 + _el(0xE0, _el_uint(0xB0, self._w)
                       + _el_uint(0xBA, self._h)))
        f.write(_el(0x1654AE6B, _el(0xAE, track)))
        self._wrote_tracks = True
        return 0

    def write_frame(self, nals: list[NAL], pts=None, dts=None) -> int:
        if pts is None:
            pts = self._nframes
        ms = pts * 1000 * self._tb[0] // self._tb[1]
        self._last_ms = max(self._last_ms, ms)
        data = sample_bytes(nals)
        flags = 0x80 if is_keyframe(nals) else 0x00
        block = b"\x81" + struct.pack(">h", 0) + bytes([flags]) + data
        cluster = _el_uint(0xE7, ms) + _el(0xA3, block)
        out = _el(0x1F43B675, cluster)
        self._f.write(out)
        self.bytes_written += len(out)
        self._nframes += 1
        return len(data)

    def close(self, largest_pts=None, second_largest_pts=None) -> None:
        if self._dur_pos is not None and self._nframes:
            dur_ms = self._last_ms + 1000.0 * self._fps[1] / self._fps[0]
            end = self._f.tell()
            self._f.seek(self._dur_pos)
            self._f.write(struct.pack(">d", dur_ms))
            self._f.seek(end)
        if self._own:
            self._f.close()


# ---------------------------------------------------------------------- FLV
class FLVOutput:
    """FLV writer (reference output/flv.c): onMetaData + AVC sequence
    header + one video tag per frame with composition-time offsets."""

    def __init__(self, path) -> None:
        self._f = open(path, "wb") if not hasattr(path, "write") else path
        self._own = not hasattr(path, "write")
        self.bytes_written = 0
        self._sps = self._pps = None
        self._w = self._h = 0
        self._fps = (25, 1)
        self._tb = (1, 25)
        self._nframes = 0
        self._dts_off = None             # shifts first dts to 0
        self._f.write(b"FLV\x01\x01\x00\x00\x00\x09" + b"\x00" * 4)

    def set_param(self, p) -> None:
        self._w, self._h = p.width, p.height
        self._fps = (p.fps_num, p.fps_den)
        if getattr(p, "timebase_den", 0):
            self._tb = (p.timebase_num, p.timebase_den)
        else:
            self._tb = (p.fps_den, p.fps_num)

    def _tag(self, ttype: int, ts_ms: int, body: bytes) -> None:
        hdr = (bytes([ttype]) + len(body).to_bytes(3, "big")
               + (ts_ms & 0xFFFFFF).to_bytes(3, "big")
               + bytes([(ts_ms >> 24) & 0xFF]) + b"\x00\x00\x00")
        data = hdr + body
        self._f.write(data + struct.pack(">I", len(data)))
        self.bytes_written += len(data) + 4

    @staticmethod
    def _amf_str(s: str) -> bytes:
        b = s.encode()
        return struct.pack(">H", len(b)) + b

    def write_headers(self, nals: list[NAL]) -> int:
        self._sps, self._pps, _ = split_headers(nals)
        # onMetaData script tag (AMF0)
        props = [("width", float(self._w)), ("height", float(self._h)),
                 ("framerate", self._fps[0] / self._fps[1]),
                 ("videocodecid", 7.0)]
        amf = (b"\x02" + self._amf_str("onMetaData")
               + b"\x08" + struct.pack(">I", len(props)))
        for k, v in props:
            amf += self._amf_str(k) + b"\x00" + struct.pack(">d", v)
        amf += b"\x00\x00\x09"
        self._tag(18, 0, amf)
        # AVC sequence header
        body = (b"\x17\x00\x00\x00\x00"
                + build_avcc(self._sps, self._pps))
        self._tag(9, 0, body)
        return 0

    def write_frame(self, nals: list[NAL], pts=None, dts=None) -> int:
        if dts is None:
            dts = self._nframes
        if pts is None:
            pts = dts
        # shift the dts timeline to start at 0: FLV tag timestamps are
        # unsigned, a negative first dts (B-frame delay) must not wrap
        if self._dts_off is None:
            self._dts_off = -dts
        dts += self._dts_off
        tn, td = self._tb
        dts_ms = dts * 1000 * tn // td
        cts_ms = (pts - dts) * 1000 * tn // td
        key = is_keyframe(nals)
        data = sample_bytes(nals)
        body = (bytes([(1 if key else 2) << 4 | 7, 1])
                + (cts_ms & 0xFFFFFF).to_bytes(3, "big") + data)
        self._tag(9, dts_ms, body)
        self._nframes += 1
        return len(data)

    def close(self, largest_pts=None, second_largest_pts=None) -> None:
        if self._own:
            self._f.close()
