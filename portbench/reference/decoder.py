"""refdec — independent reference H.264 decoder (conformance oracle).

Replicates the role of the JM reference decoder in the reference's regression
test (doc/regression_test.txt): decode the encoder's bitstream with SEPARATE
code and compare against the encoder's reconstruction, byte-exact.

Written directly from ITU-T H.264 spec sections 7/8/9 in plain numpy. It
deliberately shares no transform/prediction/entropy code with the encoder
package (it re-implements everything scalar-style; only normative constant
tables are shared) so shared-bug blind spots are minimized. Coverage grows
with the encoder: I slices (I16x16 / I_PCM), P slices (P_Skip /
P_L0_16x16 / I16-in-P), B slices (B_L0/L1/BI_16x16 with implicit
weighted bipred), in both CAVLC and CABAC (spec 9.3.3.2 arithmetic
decoder), with spec 8.7 deblocking including B mixed-prediction
strengths.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import vlc_tables as V  # spec tables 9-5..9-9 (own copy)


# ---------------------------------------------------------------- bitreader
class BitReader:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | int(self.bits[self.pos])
            self.pos += 1
        return v

    def u1(self) -> int:
        v = int(self.bits[self.pos])
        self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.bits[self.pos] == 0:
            zeros += 1
            self.pos += 1
            if zeros > 40:
                raise ValueError("bad ue")
        self.pos += 1
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7

    def more_rbsp(self) -> bool:
        # ignoring trailing stop bit handling for brevity
        return self.pos < len(self.bits) - 8


def unescape(data: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in data:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def split_nals(stream: bytes):
    i = 0
    nals = []
    n = len(stream)
    while i < n:
        # find start code
        j = stream.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        j += 3
        k = stream.find(b"\x00\x00\x01", j)
        end = k if k >= 0 else n
        # strip trailing zeros belonging to next start code
        seg = stream[j:end]
        while seg and seg[-1] == 0 and k >= 0:
            seg = seg[:-1]
        nals.append(seg)
        i = end
    return nals


# --------------------------------------------------------------- param sets
@dataclass
class DecSPS:
    profile: int = 0
    chroma_format_idc: int = 1
    bitdepth: int = 8
    log2_max_frame_num: int = 4
    poc_type: int = 0
    log2_max_poc_lsb: int = 4
    num_ref_frames: int = 1
    mb_w: int = 0
    mb_h: int = 0
    frame_mbs_only: bool = True
    direct8x8: bool = True
    crop: tuple = (0, 0, 0, 0)


@dataclass
class DecPPS:
    cabac: bool = False
    num_ref_idx_l0: int = 1
    num_ref_idx_l1: int = 1
    weighted_pred: bool = False
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_control: bool = True
    constrained_intra: bool = False
    transform_8x8: bool = False
    second_chroma_qp_offset: int = 0


def parse_sps(r: BitReader) -> DecSPS:
    s = DecSPS()
    s.profile = r.u(8)
    r.u(8)  # constraints+reserved
    r.u(8)  # level
    r.ue()  # sps id
    if s.profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        s.chroma_format_idc = r.ue()
        if s.chroma_format_idc == 3:
            r.u1()
        s.bitdepth = r.ue() + 8
        r.ue()  # chroma bitdepth
        r.u1()  # transform bypass
        if r.u1():  # scaling matrices
            raise NotImplementedError("scaling lists")
    s.log2_max_frame_num = r.ue() + 4
    s.poc_type = r.ue()
    if s.poc_type == 0:
        s.log2_max_poc_lsb = r.ue() + 4
    elif s.poc_type == 1:
        raise NotImplementedError("poc type 1")
    s.num_ref_frames = r.ue()
    r.u1()  # gaps allowed
    s.mb_w = r.ue() + 1
    s.mb_h = r.ue() + 1
    s.frame_mbs_only = bool(r.u1())
    if not s.frame_mbs_only:
        r.u1()
    s.direct8x8 = bool(r.u1())
    if r.u1():  # crop
        s.crop = (r.ue(), r.ue(), r.ue(), r.ue())
    # ignore VUI
    return s


def parse_pps(r: BitReader) -> DecPPS:
    p = DecPPS()
    r.ue()  # pps id
    r.ue()  # sps id
    p.cabac = bool(r.u1())
    if r.u1():
        raise NotImplementedError("pic_order_present")
    if r.ue() != 0:
        raise NotImplementedError("slice groups")
    p.num_ref_idx_l0 = r.ue() + 1
    p.num_ref_idx_l1 = r.ue() + 1
    p.weighted_pred = bool(r.u1())
    p.weighted_bipred_idc = r.u(2)
    p.pic_init_qp = r.se() + 26
    r.se()  # init qs
    p.chroma_qp_index_offset = r.se()
    p.deblocking_control = bool(r.u1())
    p.constrained_intra = bool(r.u1())
    r.u1()  # redundant pic cnt
    if r.more_rbsp():
        p.transform_8x8 = bool(r.u1())
        if r.u1():
            raise NotImplementedError("pps scaling lists")
        p.second_chroma_qp_offset = r.se()
    return p


# -------------------------------------------------------------- cavlc block
NC_CLASS = lambda nc: 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3

# decode-side VLC: build prefix->value maps once
def _build_vlc_dec(codes, lens):
    """dict (len, code) -> index tuple."""
    table = {}
    it = np.ndindex(codes.shape)
    for idx in it:
        ln = int(lens[idx])
        if ln > 0:
            table[(ln, int(codes[idx]))] = idx
    return table

_DEC_COEFF = [_build_vlc_dec(V.COEFF_TOKEN_CODE[i], V.COEFF_TOKEN_LEN[i])
              for i in range(6)]
# per-row tables: VLC codes are only prefix-free within a row
_DEC_TZ_ROW = [_build_vlc_dec(V.TOTAL_ZEROS_CODE[i], V.TOTAL_ZEROS_LEN[i])
               for i in range(15)]
_DEC_TZ22_ROW = [_build_vlc_dec(V.TOTAL_ZEROS_2x2_CODE[i],
                                V.TOTAL_ZEROS_2x2_LEN[i]) for i in range(3)]
_DEC_RUN_ROW = [_build_vlc_dec(V.RUN_BEFORE_CODE[i], V.RUN_BEFORE_LEN[i])
                for i in range(7)]


def _read_vlc(r: BitReader, table, maxlen=24):
    ln = 0
    code = 0
    while ln < maxlen:
        code = (code << 1) | r.u1()
        ln += 1
        if (ln, code) in table:
            return table[(ln, code)]
    raise ValueError(f"vlc desync at bit {r.pos}")


def read_coeff_token(r: BitReader, nc: int):
    """Returns (total_coeff, trailing_ones)."""
    cls = 4 if nc == -1 else NC_CLASS(nc)
    # coeff0 is part of the same prefix code space; try unified read
    # build per-class full tables lazily
    tab = dict(_DEC_COEFF[cls]) if cls < 6 else None
    full = {}
    full.update({k: (v[0] + 1, v[1]) for k, v in _DEC_COEFF[cls].items()})
    full[(int(V.COEFF0_TOKEN_LEN[cls]), int(V.COEFF0_TOKEN_CODE[cls]))] = \
        (0, 0)
    ln = 0
    code = 0
    while ln < 20:
        code = (code << 1) | r.u1()
        ln += 1
        if (ln, code) in full:
            return full[(ln, code)]
    raise ValueError(f"coeff_token desync at bit {r.pos}")


def residual_block(r: BitReader, nc: int, max_coeff: int):
    """Decode one CAVLC residual block -> (coeffs[max_coeff], total)."""
    total, t1 = read_coeff_token(r, nc)
    coeffs = np.zeros(max_coeff, np.int32)
    if total == 0:
        return coeffs, 0
    levels = []
    for _ in range(t1):
        levels.append(-1 if r.u1() else 1)
    sl = 1 if (total > 10 and t1 < 3) else 0
    for i in range(t1, total):
        # level_prefix
        prefix = 0
        while r.u1() == 0:
            prefix += 1
            if prefix > 32:
                raise ValueError("level_prefix desync")
        if prefix == 14 and sl == 0:
            suffix_size = 4
        elif prefix >= 15:
            suffix_size = prefix - 3 if prefix > 15 else 12 if sl == 0 \
                else max(sl, 12 if prefix == 15 else sl)
            if prefix == 15:
                suffix_size = 12 if sl == 0 else 12
            # per spec: prefix==15 -> 12 bits (any sl); prefix>15: prefix-3
        else:
            suffix_size = sl
        if prefix >= 16:
            suffix_size = prefix - 3
        suffix = r.u(suffix_size) if suffix_size else 0
        level_code = (min(15, prefix) << sl) + suffix
        if prefix >= 15 and sl == 0:
            level_code += 15
        if prefix >= 16:
            level_code += (1 << (prefix - 3)) - 4096
        if i == t1 and t1 < 3:
            level_code += 2
        lv = (level_code + 2) >> 1 if level_code % 2 == 0 \
            else -((level_code + 1) >> 1)
        levels.append(lv)
        if sl == 0:
            sl = 1
        if abs(lv) > (3 << (sl - 1)) and sl < 6:
            sl += 1
    # total_zeros
    if total < max_coeff:
        tab = _DEC_TZ22_ROW[total - 1] if max_coeff == 4 \
            else _DEC_TZ_ROW[total - 1]
        (tz,) = _read_vlc(r, tab, maxlen=10)
    else:
        tz = 0
    # runs
    runs = []
    zleft = tz
    for i in range(total - 1):
        if zleft > 0:
            (run,) = _read_vlc(r, _DEC_RUN_ROW[min(zleft - 1, 6)], maxlen=12)
        else:
            run = 0
        runs.append(run)
        zleft -= run
    runs.append(zleft)
    # place coefficients: reverse order, starting at highest freq
    pos = total - 1 + tz  # scan index of highest-frequency coeff
    k = pos
    for i, lv in enumerate(levels):
        coeffs[k] = lv
        if i < total - 1:
            k -= 1 + runs[i]
    return coeffs, total


# ------------------------------------------------------------- scans/tables
ZIG4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])
# codeNum -> coded_block_pattern, inter (spec table 9-4)
_CBP_FROM_GOLOMB_INTER = np.argsort(V.CBP_TO_GOLOMB_INTER)
_CBP_FROM_GOLOMB_INTRA = np.argsort(V.CBP_TO_GOLOMB_INTRA)
CHROMA_QP = np.array(list(range(30)) +
                     [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37,
                      37, 38, 38, 38, 39, 39, 39, 39])
ZBLK_X = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
ZBLK_Y = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])


_V4 = np.array([[10, 13, 16], [11, 14, 18], [13, 16, 20],
                [14, 18, 23], [16, 20, 25], [18, 23, 29]])
_CLS4 = np.array([(r & 1) + (c & 1) for r in range(4) for c in range(4)]
                 ).reshape(4, 4)
_MF16 = _V4[:, _CLS4] * 16          # [qp % 6, 4, 4]


def dequant4(c_scan, qp):
    blk = np.zeros((4, 4), np.int64)
    blk.flat[ZIG4] = c_scan
    mf16 = _MF16[qp % 6]
    sh = qp // 6 - 4
    if sh >= 0:
        return (blk * mf16) << sh
    return (blk * mf16 + (1 << (-sh - 1))) >> (-sh)


# Rounding of the inverse transform's last shift (spec 8.5.12.2). The
# benchmark's control (portbench/control.py) sets it to 0, truncating: a
# reconstruction one bit coarser than the standard's, which a conforming
# encoder's reconstruction has to fail.
IDCT_ROUND = 32


def idct4(d):
    d = d.astype(np.int64)
    def stage(a):
        o = np.empty_like(a)
        e0 = a[0] + a[2]; e1 = a[0] - a[2]
        e2 = (a[1] >> 1) - a[3]; e3 = a[1] + (a[3] >> 1)
        o[0] = e0 + e3; o[1] = e1 + e2; o[2] = e1 - e2; o[3] = e0 - e3
        return o
    h = stage(d)
    v = stage(h.T).T
    return (v + IDCT_ROUND) >> 6


def ihadamard4(x):
    H = np.array([[1, 1, 1, 1], [1, 1, -1, -1],
                  [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)
    return H @ x.astype(np.int64) @ H


# ------------------------------------------------------------------ decoder
class Decoder:
    """Stateful decoder for one elementary stream."""

    def __init__(self):
        self.sps = None
        self.pps = None
        self.frames = []          # decoded (display-cropped) frames
        self.full_frames = []     # the same, uncropped (int64 planes)
        self.slice_qps = []       # each picture's slice QP
        self._refs = []           # DPB: [{poc, planes:(y,u,v)}] decode order
        self._prev_poc_lsb = 0    # POC derivation state (spec 8.2.1.1)
        self._prev_poc_msb = 0

    # -- intra prediction (spec 8.3), scalar per MB --
    def pred16(self, mode, plane, mx, my):
        p = plane
        x0, y0 = mx * 16, my * 16
        if mode == 0:    # V
            return np.tile(p[y0 - 1, x0:x0 + 16], (16, 1))
        if mode == 1:    # H
            return np.tile(p[y0:y0 + 16, x0 - 1][:, None], (1, 16))
        if mode == 2:    # DC
            at, al = my > 0, mx > 0
            if at and al:
                s = int(p[y0 - 1, x0:x0 + 16].sum()) + \
                    int(p[y0:y0 + 16, x0 - 1].sum())
                return np.full((16, 16), (s + 16) >> 5)
            if at:
                return np.full((16, 16),
                               (int(p[y0 - 1, x0:x0 + 16].sum()) + 8) >> 4)
            if al:
                return np.full((16, 16),
                               (int(p[y0:y0 + 16, x0 - 1].sum()) + 8) >> 4)
            return np.full((16, 16), 128)
        # plane
        t = p[y0 - 1, x0:x0 + 16].astype(np.int64)
        l = p[y0:y0 + 16, x0 - 1].astype(np.int64)  # noqa: E741
        z = int(p[y0 - 1, x0 - 1])
        tp = np.concatenate([[z], t])
        lp = np.concatenate([[z], l])
        hh = sum((x + 1) * (tp[9 + x] - tp[7 - x]) for x in range(8))
        vv = sum((y + 1) * (lp[9 + y] - lp[7 - y]) for y in range(8))
        a = 16 * (l[15] + t[15])
        b = (5 * hh + 32) >> 6
        c = (5 * vv + 32) >> 6
        xs = np.arange(16) - 7
        return np.clip((a + b * xs[None, :] + c * xs[:, None] + 16) >> 5,
                       0, 255)

    def predc(self, mode, plane, mx, my):
        p = plane
        x0, y0 = mx * 8, my * 8
        at, al = my > 0, mx > 0
        if mode == 0:   # DC per quadrant
            out = np.zeros((8, 8), np.int64)
            for qy in range(2):
                for qx in range(2):
                    st = int(p[y0 - 1, x0 + qx * 4:x0 + qx * 4 + 4].sum()) \
                        if at else 0
                    sl = int(p[y0 + qy * 4:y0 + qy * 4 + 4, x0 - 1].sum()) \
                        if al else 0
                    if qx == qy:
                        if at and al:
                            d = (st + sl + 4) >> 3
                        elif at:
                            d = (st + 2) >> 2
                        elif al:
                            d = (sl + 2) >> 2
                        else:
                            d = 128
                    elif qx == 1 and qy == 0:
                        d = (st + 2) >> 2 if at else \
                            ((sl + 2) >> 2 if al else 128)
                    else:
                        d = (sl + 2) >> 2 if al else \
                            ((st + 2) >> 2 if at else 128)
                    out[qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = d
            return out
        if mode == 1:   # H
            return np.tile(p[y0:y0 + 8, x0 - 1][:, None], (1, 8))
        if mode == 2:   # V
            return np.tile(p[y0 - 1, x0:x0 + 8], (8, 1))
        t = p[y0 - 1, x0:x0 + 8].astype(np.int64)
        l = p[y0:y0 + 8, x0 - 1].astype(np.int64)  # noqa: E741
        z = int(p[y0 - 1, x0 - 1])
        tp = np.concatenate([[z], t])
        lp = np.concatenate([[z], l])
        hh = sum((x + 1) * (tp[5 + x] - tp[3 - x]) for x in range(4))
        vv = sum((y + 1) * (lp[5 + y] - lp[3 - y]) for y in range(4))
        a = 16 * (l[7] + t[7])
        b = (17 * hh + 16) >> 5
        c = (17 * vv + 16) >> 5
        xs = np.arange(8) - 3
        return np.clip((a + b * xs[None, :] + c * xs[:, None] + 16) >> 5,
                       0, 255)

    # -- inter prediction helpers (spec 8.4.2.2, written from the formulas
    #    with coordinate clamping; independent of the encoder's plane picks)
    @staticmethod
    def _interp_planes(y):
        """Return (full, b, h, j) int planes + the unrounded intermediates,
        computed on a clamp-extended grid."""
        f = y.astype(np.int64)
        H, W = f.shape

        def at(r, c):
            return f[np.clip(r, 0, H - 1)][:, np.clip(c, 0, W - 1)] \
                if False else None

        # pad by 3 on each side via edge clamp for the 6-tap windows
        fp = np.pad(f, 3, mode="edge")
        cols = np.arange(W + 6)

        def tap6_h(a):
            return (a[:, 0:-5] - 5 * a[:, 1:-4] + 20 * a[:, 2:-3]
                    + 20 * a[:, 3:-2] - 5 * a[:, 4:-1] + a[:, 5:])

        def tap6_v(a):
            return (a[0:-5] - 5 * a[1:-4] + 20 * a[2:-3]
                    + 20 * a[3:-2] - 5 * a[4:-1] + a[5:])

        b1 = tap6_h(fp)[3:-3]                # [H, W+1ish] -> align
        # b1 full width: for x in -? ; simpler: recompute aligned:
        b1 = tap6_h(np.pad(f, ((0, 0), (2, 3)), mode="edge"))
        b = np.clip((b1 + 16) >> 5, 0, 255)
        h1 = tap6_v(np.pad(f, ((2, 3), (0, 0)), mode="edge"))
        hh = np.clip((h1 + 16) >> 5, 0, 255)
        j1 = tap6_v(np.pad(b1, ((2, 3), (0, 0)), mode="edge"))
        j = np.clip((j1 + 512) >> 10, 0, 255)
        return f, b, hh, j

    def _luma_mc(self, planes, x0, y0, mvx, mvy, bs=16):
        """Quarter-pel luma block fetch per spec table 8-12.
        bs: int (square) or (h, w) for rectangular partitions."""
        f, b, hh, j = planes
        H, W = f.shape
        pad = getattr(self, "_mc_pad", 0)
        bh, bw = (bs, bs) if isinstance(bs, int) else bs
        fx, fy = mvx & 3, mvy & 3
        ix, iy = x0 + (mvx >> 2) + pad, y0 + (mvy >> 2) + pad
        rows = iy + np.arange(bh)[:, None]
        cols = ix + np.arange(bw)[None, :]

        def g(plane, dy=0, dx=0):
            r = np.clip(rows + dy, 0, H - 1)
            c = np.clip(cols + dx, 0, W - 1)
            return plane[r, c]

        q = fy * 4 + fx
        # plane picks per spec quarter-sample rules
        P0 = {0: (0, 0, 0), 1: (1, 0, 0), 2: (1, 0, 0), 3: (1, 0, 0),
              4: (0, 0, 0), 5: (1, 0, 0), 6: (1, 0, 0), 7: (1, 0, 0),
              8: (2, 0, 0), 9: (3, 0, 0), 10: (3, 0, 0), 11: (3, 0, 0),
              12: (0, 1, 0), 13: (1, 1, 0), 14: (1, 1, 0), 15: (1, 1, 0)}
        P1 = {1: (0, 0, 0), 2: None, 3: (0, 0, 1),
              4: (2, 0, 0), 5: (2, 0, 0), 6: (3, 0, 0), 7: (2, 0, 1),
              9: (2, 0, 0), 11: (2, 0, 1),
              12: (2, 0, 0), 13: (2, 0, 0), 14: (3, 0, 0), 15: (2, 0, 1)}
        planes_list = [f, b, hh, j]
        p0, dy0, dx0 = P0[q]
        s0 = g(planes_list[p0], dy0, dx0)
        if q in (0, 2, 8, 10):
            return s0
        p1, dy1, dx1 = P1[q]
        s1 = g(planes_list[p1], dy1, dx1)
        return (s0 + s1 + 1) >> 1

    def _chroma_mc(self, plane, x0, y0, mvx, mvy, bs=8):
        H, W = plane.shape
        bh, bw = (bs, bs) if isinstance(bs, int) else bs
        dx, dy = mvx & 7, mvy & 7
        ix, iy = x0 + (mvx >> 3), y0 + (mvy >> 3)
        rows = iy + np.arange(bh)[:, None]
        cols = ix + np.arange(bw)[None, :]
        A = plane[np.clip(rows, 0, H - 1), np.clip(cols, 0, W - 1)]
        B = plane[np.clip(rows, 0, H - 1), np.clip(cols + 1, 0, W - 1)]
        C = plane[np.clip(rows + 1, 0, H - 1), np.clip(cols, 0, W - 1)]
        D = plane[np.clip(rows + 1, 0, H - 1), np.clip(cols + 1, 0, W - 1)]
        A, B, C, D = [x.astype(np.int64) for x in (A, B, C, D)]
        return ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B
                + (8 - dx) * dy * C + dx * dy * D + 32) >> 6

    # -- slice decode --
    def decode(self, stream: bytes):
        for nal in split_nals(stream):
            ntype = nal[0] & 0x1F
            payload = unescape(nal[1:])
            r = BitReader(payload)
            if ntype == 7:
                self.sps = parse_sps(r)
            elif ntype == 8:
                self.pps = parse_pps(r)
            elif ntype in (1, 5):
                self.decode_slice(r, idr=(ntype == 5),
                                  nal_ref_idc=(nal[0] >> 5) & 3)
        return self.frames

    def decode_nal(self, nal: bytes):
        """Decode one NAL unit (without its start code)."""
        ntype = nal[0] & 0x1F
        r = BitReader(unescape(nal[1:]))
        if ntype == 7:
            self.sps = parse_sps(r)
        elif ntype == 8:
            self.pps = parse_pps(r)
        elif ntype in (1, 5):
            self.decode_slice(r, idr=(ntype == 5),
                              nal_ref_idc=(nal[0] >> 5) & 3)

    def seed(self, refs, prev_poc_lsb, prev_poc_msb):
        """Start decoding mid-stream: `refs` is the DPB as a decoder of
        the whole stream would hold it ({"poc", "fn", "planes": (y, u, v)
        uncropped int64}, in decoding order), the POC state that of the
        last reference picture before the next slice."""
        self._refs = list(refs)
        self._ref = self._refs[-1]["planes"] if self._refs else None
        self._prev_poc_lsb, self._prev_poc_msb = prev_poc_lsb, prev_poc_msb

    def decode_slice(self, r: BitReader, idr: bool, nal_ref_idc: int = 1):
        sps, pps = self.sps, self.pps
        self._wp = None
        self._l0_override = None
        first_mb = r.ue()
        slice_type = r.ue() % 5
        r.ue()  # pps id
        self._cur_fn = r.u(sps.log2_max_frame_num)
        if idr:
            r.ue()  # idr_pic_id
            self._prev_poc_lsb = self._prev_poc_msb = 0
            self._refs = []
        poc = 0
        if sps.poc_type == 0:
            poc_lsb = r.u(sps.log2_max_poc_lsb)
            # PicOrderCntMsb derivation (spec 8.2.1.1)
            max_lsb = 1 << sps.log2_max_poc_lsb
            if (poc_lsb < self._prev_poc_lsb
                    and self._prev_poc_lsb - poc_lsb >= max_lsb // 2):
                msb = self._prev_poc_msb + max_lsb
            elif (poc_lsb > self._prev_poc_lsb
                  and poc_lsb - self._prev_poc_lsb > max_lsb // 2):
                msb = self._prev_poc_msb - max_lsb
            else:
                msb = self._prev_poc_msb
            poc = msb + poc_lsb
            if nal_ref_idc:
                self._prev_poc_lsb, self._prev_poc_msb = poc_lsb, msb
        self._cur_poc = poc
        self._is_ref = nal_ref_idc > 0
        if slice_type not in (0, 1, 2):
            raise NotImplementedError(f"slice_type {slice_type}")
        num_ref = pps.num_ref_idx_l0
        if slice_type == 1:
            r.u1()                          # direct_spatial_mv_pred
        if slice_type in (0, 1):
            if r.u1():                      # num_ref_idx_override
                num_ref = r.ue() + 1
                if slice_type == 1:
                    r.ue()                  # num_ref_idx_l1_active -1
            if r.u1():                      # ref_pic_list_modification l0
                # spec 8.2.4.3: reorder l0 by pic_num ops; the encoder
                # emits these after invalidate_reference re-references an
                # older frame (inter.py apply_ref_list_mod)
                self._apply_ref_list_mod_l0(r)
            if slice_type == 1 and r.u1():  # ref_pic_list_modification l1
                raise NotImplementedError("ref list modification l1")
            if pps.weighted_pred and slice_type == 0:
                # pred_weight_table (spec 7.3.3.2): luma weights per l0
                # ref; chroma must be unweighted (encoder writes flag 0)
                denom_l = r.ue()
                r.ue()                        # chroma_log2_weight_denom
                wl = []
                for _ in range(num_ref):
                    if r.u1():
                        wl.append((denom_l, r.se(), r.se()))
                    else:
                        wl.append(None)
                    if r.u1():
                        raise NotImplementedError("chroma weights")
                self._wp = wl
        if nal_ref_idc:
            if idr:
                r.u1()
                r.u1()
            elif r.u1():                    # adaptive_ref_pic_marking
                raise NotImplementedError("MMCO")
        cabac_model = 0
        if pps.cabac and slice_type != 2:
            cabac_model = r.ue()            # cabac_init_idc
        qp = pps.pic_init_qp + r.se()
        self.slice_qps.append(qp)
        self._db = (0, 0, 0)   # (disable_idc, a_off, b_off)
        if pps.deblocking_control:
            disable_idc = r.ue()
            a_off = b_off = 0
            if disable_idc != 1:
                a_off = r.se() * 2
                b_off = r.se() * 2
            self._db = (disable_idc, a_off, b_off)
        if first_mb != 0:
            raise NotImplementedError("multi-slice")
        if pps.cabac:
            return self._decode_slice_cabac(r, slice_type, qp, cabac_model,
                                            num_ref)
        if slice_type == 1:
            return self._decode_b_body_cavlc(r, qp)
        if slice_type == 0:
            return self._decode_p_body(r, qp, num_ref)
        # frame buffers with -1 edge pad emulated by index -1 (top row/left
        # col physically present as padding)
        W, H = sps.mb_w * 16, sps.mb_h * 16
        y = np.zeros((H, W), np.int64)
        u = np.zeros((H // 2, W // 2), np.int64)
        v = np.zeros((H // 2, W // 2), np.int64)
        nnz_l = np.zeros((sps.mb_h * 4, sps.mb_w * 4), np.int32)
        nnz_c = np.zeros((2, sps.mb_h * 2, sps.mb_w * 2), np.int32)
        qp_map = np.zeros((sps.mb_h, sps.mb_w), np.int32)
        imode4 = np.full((sps.mb_h * 4, sps.mb_w * 4), 2, np.int32)
        if first_mb != 0:
            raise NotImplementedError("multi-slice")
        for mbidx in range(sps.mb_w * sps.mb_h):
            mx, my = mbidx % sps.mb_w, mbidx // sps.mb_w
            mb_type = r.ue()
            qp_map[my, mx] = qp
            if mb_type == 25:
                r.byte_align()
                yb = np.array([r.u(8) for _ in range(256)]).reshape(16, 16)
                ub = np.array([r.u(8) for _ in range(64)]).reshape(8, 8)
                vb = np.array([r.u(8) for _ in range(64)]).reshape(8, 8)
                y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = yb
                u[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = ub
                v[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = vb
                nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 16
                nnz_c[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 16
                continue
            if mb_type == 0:                # I_4x4
                modes = self._decode_i4_modes(r, imode4, mx, my)
                chroma_mode = r.ue()
                cbp_code = r.ue()
                if cbp_code >= 48:
                    raise ValueError("bad intra cbp code")
                cbp = int(_CBP_FROM_GOLOMB_INTRA[cbp_code])
                cbp_l, cbp_c = cbp & 15, cbp >> 4
                if cbp_l and pps.transform_8x8:
                    if r.u1():
                        raise NotImplementedError("8x8 transform")
                if cbp:
                    qp += r.se()
                qp_map[my, mx] = qp
                self._decode_i4_mb(r, y, u, v, nnz_l, nnz_c, mx, my,
                                   modes, chroma_mode, cbp_l, cbp_c, qp,
                                   sps, pps)
                continue
            if not 1 <= mb_type <= 24:
                raise ValueError(f"bad I mb_type {mb_type} at mb {mbidx}")
            pred_mode = (mb_type - 1) % 4
            cbp_c = ((mb_type - 1) // 4) % 3
            cbp_l = 15 * ((mb_type - 1) // 12)
            chroma_mode = r.ue()
            qp += r.se()
            qp_map[my, mx] = qp
            self._decode_i16(r, y, u, v, nnz_l, nnz_c, mx, my, pred_mode,
                             chroma_mode, cbp_l, cbp_c, qp, sps, pps)
        self._pending_fields = {
            "mvf": np.zeros((sps.mb_h, sps.mb_w, 2), np.int64),
            "interf": np.zeros((sps.mb_h, sps.mb_w), bool)}
        if self._db[0] != 1:
            y, u, v = deblock_frame_ref(
                y, u, v, qp_map, np.ones((sps.mb_h, sps.mb_w), bool),
                nnz_l, np.zeros((sps.mb_h, sps.mb_w, 2), np.int32),
                self._db[1], self._db[2], pps.chroma_qp_index_offset)
        self._finish_frame(y, u, v)

    def _finish_frame(self, y, u, v):
        """Store reference (sliding window, 2 entries) + emit
        display-cropped frame (coding order)."""
        sps = self.sps
        H, W = sps.mb_h * 16, sps.mb_w * 16
        if getattr(self, "_is_ref", True):
            self._ref = (y.copy(), u.copy(), v.copy())
            entry = {"poc": getattr(self, "_cur_poc", 0),
                     "fn": getattr(self, "_cur_fn", 0),
                     "planes": self._ref}
            # colocated fields for B spatial direct (mvpred.c:290)
            entry.update(getattr(self, "_pending_fields", None) or {})
            self._pending_fields = None
            self._refs.append(entry)
            while len(self._refs) > 2:
                self._refs.pop(0)
        self.full_frames.append((y, u, v))
        # crop: syntax units are SubWidthC/SubHeightC (=2 for 4:2:0)
        cl, cr, ct, cb = sps.crop
        top, bot, left, right = ct * 2, cb * 2, cl * 2, cr * 2
        self.frames.append((
            y[top:H - bot, left:W - right].astype(np.uint8),
            u[top // 2:(H - bot) // 2, left // 2:(W - right) // 2]
            .astype(np.uint8),
            v[top // 2:(H - bot) // 2, left // 2:(W - right) // 2]
            .astype(np.uint8)))

    def _apply_ref_list_mod_l0(self, r: BitReader):
        """ref_pic_list_modification for list0 (spec 7.3.3.1 / 8.2.4.3):
        short-term pic_num reordering ops. Only l0[0] matters here
        (num_ref_idx_l0_active == 1 in emitted streams): the selected
        entry becomes self._ref for this slice's P MC."""
        sps = self.sps
        max_fn = 1 << sps.log2_max_frame_num
        cur_fn = getattr(self, "_cur_fn", 0)
        # initial list: short-term refs by descending FrameNumWrap
        def wrap(fn):
            return fn - max_fn if fn > cur_fn else fn
        lst = sorted(self._refs, key=lambda e: -wrap(e.get("fn", 0)))
        pred = cur_fn
        out = []
        while True:
            idc = r.ue()
            if idc == 3:
                break
            if idc not in (0, 1):
                raise NotImplementedError(f"list-mod idc {idc}")
            diff = r.ue() + 1
            pic_num = (pred - diff) % max_fn if idc == 0 \
                else (pred + diff) % max_fn
            pred = pic_num
            match = [e for e in lst if e.get("fn", 0) % max_fn == pic_num]
            if not match:
                raise ValueError(f"list-mod: pic_num {pic_num} not in DPB")
            out.append(match[0])
        for e in lst:
            if not any(e is o for o in out):
                out.append(e)
        if out:
            self._ref = out[0]["planes"]
            self._l0_override = out

    def _l0_entries(self):
        """RefPicList0 (spec 8.2.4.2.1 default order, or the slice's
        modified order): short-term refs by descending FrameNumWrap."""
        if getattr(self, "_l0_override", None):
            return self._l0_override
        max_fn = 1 << self.sps.log2_max_frame_num
        cur_fn = getattr(self, "_cur_fn", 0)

        def wrap(fn):
            return fn - max_fn if fn > cur_fn else fn
        return sorted(self._refs, key=lambda e: -wrap(e.get("fn", 0)))

    def _decode_p_body(self, r: BitReader, qp: int, num_ref: int):
        """P slice MB layer: P_Skip / P_L0_16x16/16x8/8x16 (+intra-in-P),
        1 or 2 L0 references (te ref_idx per partition)."""
        sps, pps = self.sps, self.pps
        l0 = self._l0_entries()
        refs = [e["planes"] for e in l0[:max(1, num_ref)]] \
            or [self._ref]
        # spec clamps full-pel taps to the picture edge: equivalent to
        # interpolating on an edge-extended canvas (MVs bounded by PAD)
        PAD = 32
        planes_l = [self._interp_planes(np.pad(rp[0], PAD, mode="edge"))
                    for rp in refs]
        self._mc_pad = PAD
        W, H = sps.mb_w * 16, sps.mb_h * 16
        y = np.zeros((H, W), np.int64)
        u = np.zeros((H // 2, W // 2), np.int64)
        v = np.zeros((H // 2, W // 2), np.int64)
        nnz_l = np.zeros((sps.mb_h * 4, sps.mb_w * 4), np.int32)
        nnz_c = np.zeros((2, sps.mb_h * 2, sps.mb_w * 2), np.int32)
        n = sps.mb_w * sps.mb_h
        # 4x4-granular motion state: with 16x8/8x16 partitions the MVP /
        # P_Skip neighbors are partition cells, not whole MBs
        mv4 = np.zeros((sps.mb_h * 4, sps.mb_w * 4, 2), np.int64)
        use4 = np.zeros((sps.mb_h * 4, sps.mb_w * 4), bool)  # inter (L0)
        ref4 = np.zeros((sps.mb_h * 4, sps.mb_w * 4), np.int32)
        filled4 = np.zeros((sps.mb_h * 4, sps.mb_w * 4), bool)  # decoded
        intra_map = np.zeros((sps.mb_h, sps.mb_w), bool)
        qp_map = np.zeros((sps.mb_h, sps.mb_w), np.int32)
        imode4 = np.full((sps.mb_h * 4, sps.mb_w * 4), 2, np.int32)
        mbidx = 0
        multi = num_ref > 1

        def read_te_ref():
            """te() ref_idx (spec 9.1.1): single inverted bit for
            cMax 1, ue() beyond."""
            if not multi:
                return 0
            if num_ref == 2:
                return 1 - r.u1()
            return r.ue()

        def fill_mb(mx, my, mv, inter=True, ref=0):
            s = np.s_[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4]
            mv4[s] = mv
            use4[s] = inter
            ref4[s] = ref
            filled4[s] = True

        def mc_into(mx, my, mv, px=0, py=0, pw=16, ph=16, ref=0):
            """MC one partition: (px,py,pw,ph) in luma pixels within MB."""
            x0, y0 = mx * 16 + px, my * 16 + py
            _, ru, rv = refs[ref]
            pred = self._luma_mc(planes_l[ref], x0, y0,
                                 int(mv[0]), int(mv[1]), bs=(ph, pw))
            y[y0:y0 + ph, x0:x0 + pw] = self._wp_apply(pred, ref)
            cx, cy, cw, ch = x0 // 2, y0 // 2, pw // 2, ph // 2
            u[cy:cy + ch, cx:cx + cw] = self._chroma_mc(
                ru, cx, cy, int(mv[0]), int(mv[1]), bs=(ch, cw))
            v[cy:cy + ch, cx:cx + cw] = self._chroma_mc(
                rv, cx, cy, int(mv[0]), int(mv[1]), bs=(ch, cw))

        while mbidx < n:
            run = r.ue()
            for _ in range(run):
                mx, my = mbidx % sps.mb_w, mbidx // sps.mb_w
                mv = self._pskip_mv4(mv4, use4, filled4, mx, my,
                                     ref4=ref4 if multi else None)
                fill_mb(mx, my, mv)
                qp_map[my, mx] = qp
                mc_into(mx, my, mv)
                mbidx += 1
                if mbidx >= n:
                    break
            if mbidx >= n:
                break
            mx, my = mbidx % sps.mb_w, mbidx // sps.mb_w
            mb_type = r.ue()
            if mb_type >= 5:
                # I16-in-P (spec: P-slice intra mb_type = value - 5)
                icode = mb_type - 5
                if icode == 0:              # I_4x4 in P
                    modes = self._decode_i4_modes(r, imode4, mx, my)
                    chroma_mode = r.ue()
                    cbp_code = r.ue()
                    cbp = int(_CBP_FROM_GOLOMB_INTRA[cbp_code])
                    cbp_l, cbp_c = cbp & 15, cbp >> 4
                    if cbp:
                        qp += r.se()
                    qp_map[my, mx] = qp
                    intra_map[my, mx] = True
                    fill_mb(mx, my, 0, inter=False)
                    self._decode_i4_mb(r, y, u, v, nnz_l, nnz_c, mx, my,
                                       modes, chroma_mode, cbp_l, cbp_c,
                                       qp, sps, pps)
                    mbidx += 1
                    continue
                if icode == 25:
                    raise NotImplementedError("I_PCM in P")
                if not 1 <= icode <= 24:
                    raise ValueError(f"bad intra mb_type {mb_type}")
                pred_mode = (icode - 1) % 4
                cbp_c = ((icode - 1) // 4) % 3
                cbp_l = 15 * ((icode - 1) // 12)
                chroma_mode = r.ue()
                qp += r.se()
                qp_map[my, mx] = qp
                intra_map[my, mx] = True
                fill_mb(mx, my, 0, inter=False)
                self._decode_i16(r, y, u, v, nnz_l, nnz_c, mx, my,
                                 pred_mode, chroma_mode, cbp_l, cbp_c,
                                 qp, sps, pps)
                mbidx += 1
                continue
            if mb_type > 4:
                raise NotImplementedError(
                    f"P mb_type {mb_type} at {mbidx}")
            if mb_type in (3, 4):
                # P_8x8 (3) / P_8x8ref0 (4): sub_mb_pred (spec 7.3.5.2)
                # reads all four sub_mb_type, then all ref_idx, then all
                # mvd pairs; quadrant MVPs resolve sequentially so each
                # later quadrant sees earlier quadrants' final MVs.
                subs = [r.ue() for _ in range(4)]
                if any(st != 0 for st in subs):
                    raise NotImplementedError(
                        f"sub_mb_type {subs} (only P_L0_8x8)")
                if mb_type == 3:
                    prefs = [read_te_ref() for _ in range(4)]
                else:
                    prefs = [0] * 4
                mvds = [np.array([r.se(), r.se()], np.int64)
                        for _ in range(4)]
                for pi in range(4):
                    mv = self._mvp_part(mv4, use4, filled4, mx, my,
                                        3, pi,
                                        ref4=ref4 if multi else None,
                                        cur_ref=prefs[pi]) + mvds[pi]
                    qx, qy = 2 * (pi % 2), 2 * (pi // 2)
                    sl = np.s_[my * 4 + qy:my * 4 + qy + 2,
                               mx * 4 + qx:mx * 4 + qx + 2]
                    mv4[sl] = mv
                    use4[sl] = True
                    ref4[sl] = prefs[pi]
                    filled4[sl] = True
                    mc_into(mx, my, mv, 4 * qx, 4 * qy, 8, 8,
                            ref=prefs[pi])
            elif mb_type == 0:
                ref = read_te_ref()
                mvd = np.array([r.se(), r.se()], np.int64)
                mv = self._mvp_part(mv4, use4, filled4, mx, my, 0, 0,
                                    ref4=ref4 if multi else None,
                                    cur_ref=ref) + mvd
                fill_mb(mx, my, mv, ref=ref)
                mc_into(mx, my, mv, ref=ref)
            else:
                # P_L0_L0_16x8 (1) / 8x16 (2): all ref_idx, then both
                # mvds (spec 7.3.5.1 mb_pred order), per-partition MVP
                prefs = [read_te_ref() for _ in range(2)]
                mvds = [np.array([r.se(), r.se()], np.int64)
                        for _ in range(2)]
                for pi in range(2):
                    mv = self._mvp_part(mv4, use4, filled4, mx, my,
                                        mb_type, pi,
                                        ref4=ref4 if multi else None,
                                        cur_ref=prefs[pi]) + mvds[pi]
                    if mb_type == 1:
                        s = np.s_[my * 4 + 2 * pi:my * 4 + 2 * pi + 2,
                                  mx * 4:mx * 4 + 4]
                        geom = (0, 8 * pi, 16, 8)
                    else:
                        s = np.s_[my * 4:my * 4 + 4,
                                  mx * 4 + 2 * pi:mx * 4 + 2 * pi + 2]
                        geom = (8 * pi, 0, 8, 16)
                    mv4[s] = mv
                    use4[s] = True
                    ref4[s] = prefs[pi]
                    filled4[s] = True
                    mc_into(mx, my, mv, *geom, ref=prefs[pi])
            cbp_code = r.ue()
            if cbp_code >= 48:
                raise ValueError("bad cbp code")
            cbp = int(_CBP_FROM_GOLOMB_INTER[cbp_code])
            cbp_l, cbp_c = cbp & 15, cbp >> 4
            if cbp_l and pps.transform_8x8:
                if r.u1():
                    raise NotImplementedError("8x8 transform decode")
            if cbp:
                qp += r.se()
            qp_map[my, mx] = qp
            self._decode_inter_resid(r, y, u, v, nnz_l, nnz_c, mx, my,
                                     cbp_l, cbp_c, qp)
            # blocks not updated above -> zero nnz for uncoded quadrants
            mbidx += 1
        np.clip(y, 0, 255, out=y)
        np.clip(u, 0, 255, out=u)
        np.clip(v, 0, 255, out=v)
        mvf = mv4[::4, ::4].copy()          # part-0 MV per MB
        # colZero (8.4.1.2.2) needs refIdxCol == 0: exclude ref-1 MBs
        interf = (use4[::4, ::4] & (ref4[::4, ::4] == 0)).copy()
        self.last_mvf = mvf.copy()          # debug introspection
        self.last_qp_map = qp_map.copy()
        self.last_intra_map = intra_map.copy()
        self._pending_fields = {"mvf": mvf, "interf": interf,
                                "mvf4": mv4.copy()}
        if self._db[0] != 1:
            y, u, v = deblock_frame_ref(
                y, u, v, qp_map, intra_map,
                nnz_l, mv4, self._db[1], self._db[2],
                pps.chroma_qp_index_offset,
                ref4=ref4 if multi else None)
        self._finish_frame(y, u, v)

    def _decode_inter_resid(self, r, y, u, v, nnz_l, nnz_c, mx, my,
                            cbp_l, cbp_c, qp):
        sps, pps = self.sps, self.pps
        # luma: full 16-coeff 4x4 blocks, z-scan coding order
        for cidx in range(16):
            bx4, by4 = int(ZBLK_X[cidx]), int(ZBLK_Y[cidx])
            quad = (by4 // 2) * 2 + (bx4 // 2)
            gx, gy = mx * 4 + bx4, my * 4 + by4
            if cbp_l & (1 << quad):
                nc = self._nc(nnz_l, gx, gy)
                coeffs, tot = residual_block(r, nc, 16)
                nnz_l[gy, gx] = tot
                d = dequant4(coeffs, qp)
                res = idct4(d)
                py, px = my * 16 + by4 * 4, mx * 16 + bx4 * 4
                y[py:py + 4, px:px + 4] = np.clip(
                    y[py:py + 4, px:px + 4] + res, 0, 255)
            else:
                nnz_l[gy, gx] = 0
        # chroma
        qpc_idx = np.clip(qp + pps.chroma_qp_index_offset, 0, 51)
        qpc = int(CHROMA_QP[qpc_idx])
        dcvals = []
        for ci in range(2):
            if cbp_c:
                dcs, _ = residual_block(r, -1, 4)
            else:
                dcs = np.zeros(4, np.int32)
            dc2 = np.array([[dcs[0], dcs[1]], [dcs[2], dcs[3]]], np.int64)
            H2 = np.array([[1, 1], [1, -1]], np.int64)
            f2 = H2 @ dc2 @ H2
            mf16 = int(np.array([10, 11, 13, 14, 16, 18])[qpc % 6]) * 16
            dcvals.append(((f2 * mf16) << (qpc // 6)) >> 5)
        for ci, plane in ((0, u), (1, v)):
            for blk in range(4):
                bx2, by2 = blk % 2, blk // 2
                gx, gy = mx * 2 + bx2, my * 2 + by2
                if cbp_c == 2:
                    nc = self._nc(nnz_c[ci], gx, gy)
                    coeffs, tot = residual_block(r, nc, 15)
                    nnz_c[ci, gy, gx] = tot
                    cf = np.zeros(16, np.int64)
                    cf[1:] = coeffs
                else:
                    nnz_c[ci, gy, gx] = 0
                    cf = np.zeros(16, np.int64)
                d = dequant4(cf, qpc)
                d[0, 0] = dcvals[ci][by2, bx2]
                res = idct4(d)
                py, px = my * 8 + by2 * 4, mx * 8 + bx2 * 4
                plane[py:py + 4, px:px + 4] = np.clip(
                    plane[py:py + 4, px:px + 4] + res, 0, 255)

    # in-MB 4x4 blocks (raster bx,by) whose above-right neighbor is
    # unavailable by z-scan decoding order (spec 6.4.12.3)
    _I4_TR_UNAVAIL = {(1, 1), (3, 1), (3, 2), (1, 3), (3, 3)}

    @staticmethod
    def _pred4x4(mode, left, top, tl, al, at):
        """Intra_4x4 prediction, spec 8.3.1.2. left[4] downward, top[8]
        (caller substitutes t[3] for unavailable top-right), tl scalar."""
        p = np.zeros((4, 4), np.int64)
        t = np.asarray(top, np.int64)
        l_ = np.asarray(left, np.int64)
        tl = int(tl)
        xx = np.arange(4)[None, :]
        yy = np.arange(4)[:, None]
        if mode == 0:                      # Vertical
            p[:] = t[:4][None, :]
        elif mode == 1:                    # Horizontal
            p[:] = l_[:, None]
        elif mode == 2:                    # DC
            if at and al:
                p[:] = (t[:4].sum() + l_.sum() + 4) >> 3
            elif at:
                p[:] = (t[:4].sum() + 2) >> 2
            elif al:
                p[:] = (l_.sum() + 2) >> 2
            else:
                p[:] = 128
        elif mode == 3:                    # Diagonal-down-left
            for y_ in range(4):
                for x_ in range(4):
                    if x_ == 3 and y_ == 3:
                        p[y_, x_] = (t[6] + 3 * t[7] + 2) >> 2
                    else:
                        s = x_ + y_
                        p[y_, x_] = (t[s] + 2 * t[s + 1] + t[s + 2] + 2) \
                            >> 2
        elif mode == 4:                    # Diagonal-down-right
            for y_ in range(4):
                for x_ in range(4):
                    if x_ > y_:
                        s = x_ - y_
                        a = tl if s - 2 == -2 else 0
                        e = [tl, *t[:4]]       # e[i] = p[i-1,-1]
                        p[y_, x_] = (e[s - 1] + 2 * e[s] + e[s + 1] + 2) \
                            >> 2
                    elif x_ < y_:
                        s = y_ - x_
                        e = [tl, *l_]
                        p[y_, x_] = (e[s - 1] + 2 * e[s] + e[s + 1] + 2) \
                            >> 2
                    else:
                        p[y_, x_] = (t[0] + 2 * tl + l_[0] + 2) >> 2
        elif mode == 5:                    # Vertical-right
            e = [tl, *t]                   # e[i+1] = t[i]; e[0] = tl
            for y_ in range(4):
                for x_ in range(4):
                    z = 2 * x_ - y_
                    if z >= 0 and z % 2 == 0:
                        i = x_ - (y_ >> 1)
                        p[y_, x_] = (e[i] + e[i + 1] + 1) >> 1
                    elif z >= 0:
                        i = x_ - (y_ >> 1)
                        p[y_, x_] = (e[i - 1] + 2 * e[i] + e[i + 1] + 2) \
                            >> 2
                    elif z == -1:
                        p[y_, x_] = (l_[0] + 2 * tl + t[0] + 2) >> 2
                    else:
                        e2 = [tl, *l_]     # e2[i+1] = p[-1, i]
                        p[y_, x_] = (e2[y_] + 2 * e2[y_ - 1]
                                     + e2[y_ - 2] + 2) >> 2
        elif mode == 6:                    # Horizontal-down
            e = [tl, *l_]
            for y_ in range(4):
                for x_ in range(4):
                    z = 2 * y_ - x_
                    if z >= 0 and z % 2 == 0:
                        i = y_ - (x_ >> 1)
                        p[y_, x_] = (e[i] + e[i + 1] + 1) >> 1
                    elif z >= 0:
                        i = y_ - (x_ >> 1)
                        p[y_, x_] = (e[i - 1] + 2 * e[i] + e[i + 1] + 2) \
                            >> 2
                    elif z == -1:
                        p[y_, x_] = (l_[0] + 2 * tl + t[0] + 2) >> 2
                    else:
                        e2 = [tl, *t]      # e2[i+1] = p[i, -1]
                        p[y_, x_] = (e2[x_] + 2 * e2[x_ - 1]
                                     + e2[x_ - 2] + 2) >> 2
        elif mode == 7:                    # Vertical-left
            for y_ in range(4):
                for x_ in range(4):
                    i = x_ + (y_ >> 1)
                    if y_ % 2 == 0:
                        p[y_, x_] = (t[i] + t[i + 1] + 1) >> 1
                    else:
                        p[y_, x_] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) \
                            >> 2
        else:                              # 8: Horizontal-up
            for y_ in range(4):
                for x_ in range(4):
                    z = x_ + 2 * y_
                    i = y_ + (x_ >> 1)
                    if z > 5:
                        p[y_, x_] = l_[3]
                    elif z == 5:
                        p[y_, x_] = (l_[2] + 3 * l_[3] + 2) >> 2
                    elif z % 2 == 0:
                        p[y_, x_] = (l_[i] + l_[i + 1] + 1) >> 1
                    else:
                        p[y_, x_] = (l_[i] + 2 * l_[i + 1] + l_[i + 2]
                                     + 2) >> 2
        return p

    def _i4_block_neighbors(self, y, mx, my, bx, by, mbw):
        """(left4, top8, tl, al, at) for global block (mx*4+bx, my*4+by)
        from the decoded plane, spec availability + 8.3.1.2 top-right
        substitution."""
        gx, gy = mx * 4 + bx, my * 4 + by
        al = gx > 0
        at = gy > 0
        px, py = gx * 4, gy * 4
        left4 = y[py:py + 4, px - 1] if al else np.zeros(4, np.int64)
        if at:
            t03 = y[py - 1, px:px + 4]
            if by == 0:
                tr_ok = (bx < 3) or (mx < mbw - 1)
            else:
                tr_ok = (bx, by) not in self._I4_TR_UNAVAIL
            if tr_ok and px + 8 <= y.shape[1]:
                t47 = y[py - 1, px + 4:px + 8]
            else:
                t47 = np.full(4, t03[3], np.int64)
            top8 = np.concatenate([t03, t47])
        else:
            top8 = np.zeros(8, np.int64)
        tl = y[py - 1, px - 1] if (al and at) else 0
        return left4, top8, tl, al, at

    def _decode_i4_modes(self, r, imode4, mx, my):
        """Parse 16 prev_flag/rem mode elements (z-scan); returns raster
        [16] modes and updates the frame MPM grid."""
        modes = np.zeros(16, np.int32)
        for z in range(16):
            bx, by = int(ZBLK_X[z]), int(ZBLK_Y[z])
            gx, gy = mx * 4 + bx, my * 4 + by
            if gx == 0 or gy == 0:
                mpm = 2
            else:
                mpm = min(int(imode4[gy, gx - 1]), int(imode4[gy - 1, gx]))
            if r.u1():
                mode = mpm
            else:
                rem = r.u(3)
                mode = rem + (1 if rem >= mpm else 0)
            imode4[gy, gx] = mode
            modes[by * 4 + bx] = mode
        return modes

    def _decode_i4_mb(self, r, y, u, v, nnz_l, nnz_c, mx, my, modes,
                      chroma_mode, cbp_l, cbp_c, qp, sps, pps,
                      luma_resid=None):
        """I_4x4 MB: luma per-block residual parse (z-scan, cbp-gated,
        16-coeff blocks) + sequential prediction/recon; chroma exactly as
        I16. luma_resid [16,16] overrides parsing (CABAC path)."""
        mbw = sps.mb_w
        resid = np.zeros((16, 16), np.int64)
        if luma_resid is not None:
            resid = luma_resid
        for z in range(16):
            bx, by = int(ZBLK_X[z]), int(ZBLK_Y[z])
            raster = by * 4 + bx
            gx, gy = mx * 4 + bx, my * 4 + by
            quad = (by >> 1) * 2 + (bx >> 1)
            if luma_resid is None:
                if cbp_l & (1 << quad):
                    nc = self._nc(nnz_l, gx, gy)
                    coeffs, tot = residual_block(r, nc, 16)
                    resid[raster] = coeffs
                    nnz_l[gy, gx] = tot
                else:
                    nnz_l[gy, gx] = 0
            # recon must follow parse order (z-scan deps)
            left4, top8, tl, al, at = self._i4_block_neighbors(
                y, mx, my, bx, by, mbw)
            pred = self._pred4x4(int(modes[raster]), left4, top8, tl,
                                 al, at)
            d = dequant4(resid[raster], qp)
            res = idct4(d)
            px, py = gx * 4, gy * 4
            y[py:py + 4, px:px + 4] = np.clip(pred + res, 0, 255)
        # chroma: identical syntax/recon to the I16 path
        self._decode_chroma_intra(r, u, v, nnz_c, mx, my, chroma_mode,
                                  cbp_c, qp, pps)

    def _decode_chroma_intra(self, r, u, v, nnz_c, mx, my, chroma_mode,
                             cbp_c, qp, pps):
        qpc_idx = np.clip(qp + pps.chroma_qp_index_offset, 0, 51)
        qpc = int(CHROMA_QP[qpc_idx])
        dcvs = []
        for ci in range(2):
            if cbp_c:
                dcs, _ = residual_block(r, -1, 4)
            else:
                dcs = np.zeros(4, np.int32)
            dc2 = np.array([[dcs[0], dcs[1]], [dcs[2], dcs[3]]], np.int64)
            H2 = np.array([[1, 1], [1, -1]], np.int64)
            f2 = H2 @ dc2 @ H2
            mf16 = int(np.array([10, 11, 13, 14, 16, 18])[qpc % 6]) * 16
            dcvs.append(((f2 * mf16) << (qpc // 6)) >> 5)
        cac = np.zeros((2, 4, 16), np.int64)
        for ci in range(2):
            for blk in range(4):
                bx2, by2 = blk % 2, blk // 2
                if cbp_c == 2:
                    nc = self._nc(nnz_c[ci], mx * 2 + bx2, my * 2 + by2)
                    coeffs, tot = residual_block(r, nc, 15)
                    cac[ci, blk, 1:] = coeffs
                    nnz_c[ci, my * 2 + by2, mx * 2 + bx2] = tot
                else:
                    nnz_c[ci, my * 2 + by2, mx * 2 + bx2] = 0
        for ci, plane in ((0, u), (1, v)):
            predc = self.predc(chroma_mode, plane, mx, my)
            outc = np.zeros((8, 8), np.int64)
            for blk in range(4):
                bx2, by2 = blk % 2, blk // 2
                d = dequant4(cac[ci, blk], qpc)
                d[0, 0] = dcvs[ci][by2, bx2]
                res = idct4(d)
                outc[by2 * 4:by2 * 4 + 4, bx2 * 4:bx2 * 4 + 4] = \
                    predc[by2 * 4:by2 * 4 + 4, bx2 * 4:bx2 * 4 + 4] + res
            plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = \
                np.clip(outc, 0, 255)

    def _nc(self, nnz, bx, by):
        has_a, has_b = bx > 0, by > 0
        na = nnz[by, bx - 1] if has_a else 0
        nb = nnz[by - 1, bx] if has_b else 0
        if has_a and has_b:
            return (int(na) + int(nb) + 1) >> 1
        if has_a:
            return int(na)
        if has_b:
            return int(nb)
        return 0

    def _decode_i16(self, r, y, u, v, nnz_l, nnz_c, mx, my, pred_mode,
                    chroma_mode, cbp_l, cbp_c, qp, sps, pps):
        # luma DC
        nc = self._nc(nnz_l, mx * 4, my * 4)
        dc_scan, _ = residual_block(r, nc, 16)
        dc_blk = np.zeros((4, 4), np.int64)
        dc_blk.flat[ZIG4] = dc_scan
        f = ihadamard4(dc_blk)
        per = qp // 6
        mf16 = int(np.array([10, 11, 13, 14, 16, 18])[qp % 6]) * 16
        if per >= 6:
            dcv = (f * mf16) << (per - 6)
        else:
            dcv = (f * mf16 + (1 << (5 - per))) >> (6 - per)
        # luma AC: 16 blocks in z-scan coding order
        ac = np.zeros((16, 16), np.int64)   # [raster blk, 16 coeffs w/ pos0]
        totals = np.zeros(16, np.int32)
        if cbp_l:
            for cidx in range(16):
                bx4, by4 = int(ZBLK_X[cidx]), int(ZBLK_Y[cidx])
                raster = by4 * 4 + bx4
                nc = self._nc(nnz_l, mx * 4 + bx4, my * 4 + by4)
                coeffs, tot = residual_block(r, nc, 15)
                ac[raster, 1:] = coeffs
                totals[raster] = tot
                nnz_l[my * 4 + by4, mx * 4 + bx4] = tot
        else:
            nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        pred = self.pred16(pred_mode, y if my or mx else y, mx, my)
        out = np.zeros((16, 16), np.int64)
        for raster in range(16):
            by4, bx4 = raster // 4, raster % 4
            d = dequant4(ac[raster], qp)
            d[0, 0] = dcv[by4, bx4]
            res = idct4(d)
            blk = pred[by4 * 4:by4 * 4 + 4, bx4 * 4:bx4 * 4 + 4] + res
            out[by4 * 4:by4 * 4 + 4, bx4 * 4:bx4 * 4 + 4] = blk
        y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = np.clip(out, 0, 255)

        # chroma
        qpc_idx = np.clip(qp + pps.chroma_qp_index_offset, 0, 51)
        qpc = int(CHROMA_QP[qpc_idx])
        for ci, plane in ((0, u), (1, v)):
            if cbp_c:
                nc = -1
                dcs, _ = residual_block(r, -1, 4)
            else:
                dcs = np.zeros(4, np.int32)
            dc2 = np.array([[dcs[0], dcs[1]], [dcs[2], dcs[3]]], np.int64)
            H2 = np.array([[1, 1], [1, -1]], np.int64)
            f2 = H2 @ dc2 @ H2
            mf16 = int(np.array([10, 11, 13, 14, 16, 18])[qpc % 6]) * 16
            dcv2 = ((f2 * mf16) << (qpc // 6)) >> 5
            setattr(self, f"_cdc{ci}", dcs)
            if ci == 0:
                self._pending = []
            self._pending.append((plane, dcv2))
        # chroma AC after both DCs
        cac = np.zeros((2, 4, 16), np.int64)
        for ci in range(2):
            for blk in range(4):
                bx2, by2 = blk % 2, blk // 2
                if cbp_c == 2:
                    nc = self._nc(nnz_c[ci], mx * 2 + bx2, my * 2 + by2)
                    coeffs, tot = residual_block(r, nc, 15)
                    cac[ci, blk, 1:] = coeffs
                    nnz_c[ci, my * 2 + by2, mx * 2 + bx2] = tot
                else:
                    nnz_c[ci, my * 2 + by2, mx * 2 + bx2] = 0
        for ci, plane in ((0, u), (1, v)):
            predc = self.predc(chroma_mode, plane, mx, my)
            dcv2 = self._pending[ci][1]
            outc = np.zeros((8, 8), np.int64)
            for blk in range(4):
                bx2, by2 = blk % 2, blk // 2
                d = dequant4(cac[ci, blk], qpc)
                d[0, 0] = dcv2[by2, bx2]
                res = idct4(d)
                outc[by2 * 4:by2 * 4 + 4, bx2 * 4:bx2 * 4 + 4] = \
                    predc[by2 * 4:by2 * 4 + 4, bx2 * 4:bx2 * 4 + 4] + res
            plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = \
                np.clip(outc, 0, 255)

    # ---------------- shared helpers for B / CABAC paths ----------------
    def _mvp_match(self, mvf, usef, mx, my):
        """Median MVP over neighbors that use the same reference (spec
        8.4.1.3: refIdxN == refIdxLX); `usef` marks MBs whose list-X
        refIdx matches (intra / other-list-only MBs are False)."""
        mbw = usef.shape[1]
        z = np.zeros(2, np.int64)
        avail_a, avail_b = mx > 0, my > 0
        mv_a = mvf[my, mx - 1] if avail_a else z
        use_a = avail_a and bool(usef[my, mx - 1])
        mv_b = mvf[my - 1, mx] if avail_b else z
        use_b = avail_b and bool(usef[my - 1, mx])
        if my > 0 and mx < mbw - 1:
            mv_c, use_c, avail_c = (mvf[my - 1, mx + 1],
                                    bool(usef[my - 1, mx + 1]), True)
        elif my > 0 and mx > 0:
            mv_c, use_c, avail_c = (mvf[my - 1, mx - 1],
                                    bool(usef[my - 1, mx - 1]), True)
        else:
            mv_c, use_c, avail_c = z, False, False
        if avail_a and not avail_b and not avail_c:
            return mv_a.copy()
        ca = mv_a if use_a else z
        cbv = mv_b if use_b else z
        cc = mv_c if use_c else z
        nmatch = int(use_a) + int(use_b) + int(use_c)
        if nmatch == 1:
            return (ca if use_a else cbv if use_b else cc).copy()
        return np.array([np.median([ca[0], cbv[0], cc[0]]),
                         np.median([ca[1], cbv[1], cc[1]])], np.int64)

    def _pskip_mv(self, mvf, usef, mx, my):
        """P_Skip motion vector (spec 8.4.1.1)."""
        if mx == 0 or my == 0:
            return np.zeros(2, np.int64)
        if (usef[my, mx - 1] and not np.any(mvf[my, mx - 1])) or \
                (usef[my - 1, mx] and not np.any(mvf[my - 1, mx])):
            return np.zeros(2, np.int64)
        return self._mvp_match(mvf, usef, mx, my)

    def _wp_apply(self, pred, ref_idx=0):
        """Explicit weighted prediction, luma (spec 8.4.2.3.3)."""
        wl = getattr(self, "_wp", None)
        if not wl or wl[ref_idx] is None:
            return pred
        d, w, o = wl[ref_idx]
        if d >= 1:
            return np.clip(((pred * w + (1 << (d - 1))) >> d) + o, 0, 255)
        return np.clip(pred * w + o, 0, 255)

    @staticmethod
    def _mvp_block4(mv4, use4, filled4, gx, gy, pw, ref4=None, cur_ref=0):
        """Neighbors + median MVP for a partition whose top-left 4x4 cell
        is (gx, gy), width pw in 4x4 units (spec 8.4.1.3 at partition
        granularity; availability = already decoded, i.e. filled4).
        Inter neighbors always contribute their MV to the median; with
        ref4 given, only neighbors whose refIdx == cur_ref count for the
        exactly-one-match and directional rules (8.4.1.3.1).
        Returns (mvp, (mv_a, r_a), (mv_b, r_b), (mv_c, r_c)) — r_* marks
        matching neighbors."""
        H4, W4 = filled4.shape
        z = np.zeros(2, np.int64)

        def cell(cx, cy):
            if cx < 0 or cy < 0 or cx >= W4 or cy >= H4 \
                    or not filled4[cy, cx]:
                return z, False, False, False
            use = bool(use4[cy, cx])
            match = use if ref4 is None else \
                (use and int(ref4[cy, cx]) == cur_ref)
            return mv4[cy, cx], use, True, match

        mv_a, u_a, av_a, r_a = cell(gx - 1, gy)
        mv_b, u_b, av_b, r_b = cell(gx, gy - 1)
        mv_c, u_c, av_c, r_c = cell(gx + pw, gy - 1)
        if not av_c:                                  # C -> D (8.4.1.3.2)
            mv_c, u_c, av_c, r_c = cell(gx - 1, gy - 1)
        if av_a and not av_b and not av_c:
            mvp = np.asarray(mv_a, np.int64).copy()
        else:
            ca = mv_a if u_a else z
            cbv = mv_b if u_b else z
            cc = mv_c if u_c else z
            nmatch = int(r_a) + int(r_b) + int(r_c)
            if nmatch == 1:
                mvp = (ca if r_a else cbv if r_b else cc).copy()
            else:
                mvp = np.array([np.median([ca[0], cbv[0], cc[0]]),
                                np.median([ca[1], cbv[1], cc[1]])],
                               np.int64)
        return mvp, (mv_a, r_a), (mv_b, r_b), (mv_c, r_c)

    def _pskip_mv4(self, mv4, use4, filled4, mx, my, ref4=None):
        """P_Skip motion vector at 4x4 neighbor granularity (spec
        8.4.1.1): zero if A/B unavailable or a zero-MV inter-ref0
        neighbor cell, else the 16x16 median MVP (refIdx-0 match)."""
        z = np.zeros(2, np.int64)
        if mx == 0 or my == 0:
            return z
        gx, gy = mx * 4, my * 4

        def is_r0(cx, cy):
            ok = use4[cy, cx] and filled4[cy, cx]
            if ok and ref4 is not None:
                ok = int(ref4[cy, cx]) == 0
            return ok

        if (is_r0(gx - 1, gy) and not np.any(mv4[gy, gx - 1])) or \
                (is_r0(gx, gy - 1) and not np.any(mv4[gy - 1, gx])):
            return z
        mvp, _, _, _ = self._mvp_block4(mv4, use4, filled4, gx, gy, 4,
                                        ref4=ref4, cur_ref=0)
        return mvp

    def _mvp_part(self, mv4, use4, filled4, mx, my, part_kind, part_idx,
                  ref4=None, cur_ref=0):
        """MVP for P partition part_idx of an MB: part_kind 0=16x16,
        1=16x8, 2=8x16 — with the 16x8/8x16 directional rules
        (spec 8.4.1.3 items 2/3; reference mvpred.c:30) — or 3=P_8x8
        (quadrant part_idx in z order, plain median at 8x8
        granularity; earlier quadrants of the same MB are already in
        mv4/filled4 when this is called)."""
        if part_kind == 0:
            px, py, pw = 0, 0, 4
        elif part_kind == 1:
            px, py, pw = 0, 2 * part_idx, 4
        elif part_kind == 3:
            px, py, pw = 2 * (part_idx % 2), 2 * (part_idx // 2), 2
        else:
            px, py, pw = 2 * part_idx, 0, 2
        gx, gy = mx * 4 + px, my * 4 + py
        mvp, A, B, C = self._mvp_block4(mv4, use4, filled4, gx, gy, pw,
                                        ref4=ref4, cur_ref=cur_ref)
        if part_kind == 1:
            if part_idx == 0 and B[1]:
                return np.asarray(B[0], np.int64).copy()
            if part_idx == 1 and A[1]:
                return np.asarray(A[0], np.int64).copy()
        elif part_kind == 2:
            if part_idx == 0 and A[1]:
                return np.asarray(A[0], np.int64).copy()
            if part_idx == 1 and C[1]:
                return np.asarray(C[0], np.int64).copy()
        return mvp

    def _derive_direct_mb(self, mvf0, use0, mvf1, use1, mx, my,
                          col_inter, col_mv, col_mv4=None):
        """Spatial direct derivation for one MB (mvpred.c:290; 16x16,
        1 ref per list, progressive). Fields store mv 0 where the list
        is unused (the cache convention). Returns (u0, u1, m0, m1).

        col_mv4 (4x4-granular colocated MVs) enables the spec's
        per-quadrant colZero check (direct_8x8_inference corners,
        8.4.1.2.2); mixed-quadrant MBs raise — the encoder never codes
        direct/skip there (whole-MB coding would be nonconformant)."""
        mbw = use0.shape[1]
        z = np.zeros(2, np.int64)
        outs = []
        for use, mvf in ((use0, mvf0), (use1, mvf1)):
            avail_a, avail_b = mx > 0, my > 0
            mv_a = mvf[my, mx - 1] if avail_a else z
            r_a = avail_a and bool(use[my, mx - 1])
            mv_b = mvf[my - 1, mx] if avail_b else z
            r_b = avail_b and bool(use[my - 1, mx])
            if my > 0 and mx < mbw - 1:
                mv_c, r_c = mvf[my - 1, mx + 1], bool(use[my - 1, mx + 1])
            elif mx > 0 and my > 0:
                mv_c, r_c = mvf[my - 1, mx - 1], bool(use[my - 1, mx - 1])
            else:
                mv_c, r_c = z, False
            count = int(r_a) + int(r_b) + int(r_c)
            if count == 0:
                outs.append((False, z))
            elif count > 1:
                outs.append((True, np.array(
                    [np.median([mv_a[0], mv_b[0], mv_c[0]]),
                     np.median([mv_a[1], mv_b[1], mv_c[1]])], np.int64)))
            else:
                m = mv_a if r_a else mv_b if r_b else mv_c
                outs.append((True, np.asarray(m, np.int64).copy()))
        (u0, m0), (u1, m1) = outs
        if not u0 and not u1:
            return True, True, z, z
        if col_mv4 is not None and col_inter[my, mx]:
            czs = []
            for cy, cx in ((0, 0), (0, 3), (3, 0), (3, 3)):
                c = col_mv4[my * 4 + cy, mx * 4 + cx]
                czs.append(abs(int(c[0])) <= 1 and abs(int(c[1])) <= 1)
            if (np.any(m0) or np.any(m1)) and len(set(czs)) > 1:
                raise NotImplementedError(
                    "mixed per-quadrant colZero in direct MB")
            col_zero = czs[0]
        else:
            col_zero = (col_inter[my, mx]
                        and abs(int(col_mv[my, mx, 0])) <= 1
                        and abs(int(col_mv[my, mx, 1])) <= 1)
        if col_zero and (np.any(m0) or np.any(m1)):
            if u0:
                m0 = z
            if u1:
                m1 = z
        return u0, u1, m0, m1

    @staticmethod
    def _implicit_w(poc_cur, poc_l0, poc_l1):
        """Implicit bipred weights (spec 8.4.2.3.2)."""
        tb = max(-128, min(127, poc_cur - poc_l0))
        td = max(-128, min(127, poc_l1 - poc_l0))
        if td == 0:
            return 32, 32
        tx = (16384 + abs(td >> 1)) // td
        dsf = max(-1024, min(1023, (tb * tx + 32) >> 6))
        w1 = dsf >> 2
        if w1 < -64 or w1 > 128:
            return 32, 32
        return 64 - w1, w1

    def _apply_resid_arrays(self, y, u, v, mx, my, qp, luma, cdc, cac):
        """Add decoded inter residual coefficient arrays onto the MC
        prediction already written into y/u/v. luma [16 raster, 16]
        scan-order (full 16-coeff inter blocks); cdc [2,4]; cac [2,4,16]
        with position 0 unused."""
        pps = self.pps
        for raster in range(16):
            if not np.any(luma[raster]):
                continue
            by4, bx4 = raster // 4, raster % 4
            d = dequant4(luma[raster], qp)
            res = idct4(d)
            py, px = my * 16 + by4 * 4, mx * 16 + bx4 * 4
            y[py:py + 4, px:px + 4] = np.clip(
                y[py:py + 4, px:px + 4] + res, 0, 255)
        qpc = int(CHROMA_QP[np.clip(qp + pps.chroma_qp_index_offset,
                                    0, 51)])
        H2 = np.array([[1, 1], [1, -1]], np.int64)
        mf16 = int(np.array([10, 11, 13, 14, 16, 18])[qpc % 6]) * 16
        for ci, plane in ((0, u), (1, v)):
            dcs = cdc[ci]
            dc2 = np.array([[dcs[0], dcs[1]], [dcs[2], dcs[3]]], np.int64)
            dcv = ((H2 @ dc2 @ H2) * mf16 << (qpc // 6)) >> 5
            for blk in range(4):
                bx2, by2 = blk % 2, blk // 2
                cf = np.zeros(16, np.int64)
                cf[1:] = cac[ci, blk, 1:]
                d = dequant4(cf, qpc)
                d[0, 0] = dcv[by2, bx2]
                res = idct4(d)
                py, px = my * 8 + by2 * 4, mx * 8 + bx2 * 4
                plane[py:py + 4, px:px + 4] = np.clip(
                    plane[py:py + 4, px:px + 4] + res, 0, 255)

    def _recon_i16_arrays(self, y, u, v, mx, my, pred_mode, chroma_mode,
                          qp, dc_scan, ac, cdc, cac):
        """I16x16 reconstruction from decoded coefficient arrays.
        dc_scan [16] scan-order luma DC; ac [16 raster, 16] with pos 0
        unused; cdc [2,4]; cac [2,4,16] with pos 0 unused."""
        pps = self.pps
        dc_blk = np.zeros((4, 4), np.int64)
        dc_blk.flat[ZIG4] = dc_scan
        f = ihadamard4(dc_blk)
        per = qp // 6
        mf16 = int(np.array([10, 11, 13, 14, 16, 18])[qp % 6]) * 16
        if per >= 6:
            dcv = (f * mf16) << (per - 6)
        else:
            dcv = (f * mf16 + (1 << (5 - per))) >> (6 - per)
        pred = self.pred16(pred_mode, y, mx, my)
        out = np.zeros((16, 16), np.int64)
        for raster in range(16):
            by4, bx4 = raster // 4, raster % 4
            d = dequant4(ac[raster], qp)
            d[0, 0] = dcv[by4, bx4]
            res = idct4(d)
            out[by4 * 4:by4 * 4 + 4, bx4 * 4:bx4 * 4 + 4] = \
                pred[by4 * 4:by4 * 4 + 4, bx4 * 4:bx4 * 4 + 4] + res
        y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = \
            np.clip(out, 0, 255)
        self._recon_chroma_arrays(u, v, mx, my, chroma_mode, qp, cdc, cac)

    def _recon_chroma_arrays(self, u, v, mx, my, chroma_mode, qp, cdc,
                             cac):
        """Intra chroma recon from coefficient arrays (I16 and I4)."""
        pps = self.pps
        qpc = int(CHROMA_QP[np.clip(qp + pps.chroma_qp_index_offset,
                                    0, 51)])
        H2 = np.array([[1, 1], [1, -1]], np.int64)
        mfc = int(np.array([10, 11, 13, 14, 16, 18])[qpc % 6]) * 16
        for ci, plane in ((0, u), (1, v)):
            dcs = cdc[ci]
            dc2 = np.array([[dcs[0], dcs[1]], [dcs[2], dcs[3]]], np.int64)
            dcv2 = ((H2 @ dc2 @ H2) * mfc << (qpc // 6)) >> 5
            predc = self.predc(chroma_mode, plane, mx, my)
            outc = np.zeros((8, 8), np.int64)
            for blk in range(4):
                bx2, by2 = blk % 2, blk // 2
                cf = np.zeros(16, np.int64)
                cf[1:] = cac[ci, blk, 1:]
                d = dequant4(cf, qpc)
                d[0, 0] = dcv2[by2, bx2]
                res = idct4(d)
                outc[by2 * 4:by2 * 4 + 4, bx2 * 4:bx2 * 4 + 4] = \
                    predc[by2 * 4:by2 * 4 + 4, bx2 * 4:bx2 * 4 + 4] + res
            plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = \
                np.clip(outc, 0, 255)

    def _recon_i4_arrays(self, y, u, v, mx, my, modes, chroma_mode, qp,
                         luma, cdc, cac):
        """I_4x4 reconstruction from CABAC-decoded coefficient arrays.
        luma [16 raster, 16] scan-order 16-coeff blocks; recon follows
        z-scan so each block's neighbors are final (spec 8.3.1)."""
        mbw = self.sps.mb_w
        for z in range(16):
            bx, by = int(ZBLK_X[z]), int(ZBLK_Y[z])
            raster = by * 4 + bx
            left4, top8, tl, al, at = self._i4_block_neighbors(
                y, mx, my, bx, by, mbw)
            pred = self._pred4x4(int(modes[raster]), left4, top8, tl,
                                 al, at)
            d = dequant4(luma[raster], qp)
            res = idct4(d)
            px, py = (mx * 4 + bx) * 4, (my * 4 + by) * 4
            y[py:py + 4, px:px + 4] = np.clip(pred + res, 0, 255)
        self._recon_chroma_arrays(u, v, mx, my, chroma_mode, qp, cdc, cac)

    def _b_refs(self):
        """(l0, l1) reference entries for the current B picture: l0 =
        closest earlier POC, l1 = closest later POC (spec 8.2.4.2.3
        initialization with one active ref per list)."""
        cur = self._cur_poc
        before = [rf for rf in self._refs if rf["poc"] < cur]
        after = [rf for rf in self._refs if rf["poc"] > cur]
        if not before or not after:
            raise ValueError("B picture without both anchors in DPB")
        l0 = max(before, key=lambda rf: rf["poc"])
        l1 = min(after, key=lambda rf: rf["poc"])
        return l0, l1

    def _decode_b_body_cavlc(self, r: BitReader, qp: int):
        """B slice MB layer, CAVLC: B_L0/L1/BI_16x16 (the encoder's
        emitted subset; encode_bframe_entropy_dev is the writer)."""
        sps, pps = self.sps, self.pps
        l0, l1 = self._b_refs()
        ry0, ru0, rv0 = l0["planes"]
        ry1, ru1, rv1 = l1["planes"]
        if pps.weighted_bipred_idc == 2:
            w0, w1 = self._implicit_w(self._cur_poc, l0["poc"], l1["poc"])
        else:
            w0, w1 = 32, 32
        PAD = 32
        self._mc_pad = PAD
        planes0 = self._interp_planes(np.pad(ry0, PAD, mode="edge"))
        planes1 = self._interp_planes(np.pad(ry1, PAD, mode="edge"))
        W, H = sps.mb_w * 16, sps.mb_h * 16
        y = np.zeros((H, W), np.int64)
        u = np.zeros((H // 2, W // 2), np.int64)
        v = np.zeros((H // 2, W // 2), np.int64)
        nnz_l = np.zeros((sps.mb_h * 4, sps.mb_w * 4), np.int32)
        nnz_c = np.zeros((2, sps.mb_h * 2, sps.mb_w * 2), np.int32)
        n = sps.mb_w * sps.mb_h
        mvf0 = np.zeros((sps.mb_h, sps.mb_w, 2), np.int64)
        mvf1 = np.zeros((sps.mb_h, sps.mb_w, 2), np.int64)
        use0 = np.zeros((sps.mb_h, sps.mb_w), bool)
        use1 = np.zeros((sps.mb_h, sps.mb_w), bool)
        qp_map = np.zeros((sps.mb_h, sps.mb_w), np.int32)
        col_inter = l1.get("interf")
        col_mv = l1.get("mvf")
        col_mv4 = l1.get("mvf4")
        if col_inter is None or col_mv is None:
            col_inter = np.zeros((sps.mb_h, sps.mb_w), bool)
            col_mv = np.zeros((sps.mb_h, sps.mb_w, 2), np.int64)
            col_mv4 = None

        def do_direct(mx, my, has_resid):
            u0, u1, m0, m1 = self._derive_direct_mb(
                mvf0, use0, mvf1, use1, mx, my, col_inter, col_mv,
                col_mv4)
            dmode = 2 if (u0 and u1) else (0 if u0 else 1)
            self._b_mc(y, u, v, planes0, planes1, ru0, rv0, ru1, rv1,
                       mx, my, dmode, m0, m1, w0, w1)
            use0[my, mx], use1[my, mx] = u0, u1
            mvf0[my, mx] = m0 if u0 else 0
            mvf1[my, mx] = m1 if u1 else 0
            if not has_resid:
                nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                nnz_c[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
                qp_map[my, mx] = qp

        mbidx = 0
        while mbidx < n:
            run = r.ue()                    # mb_skip_run
            for _ in range(run):            # B_Skip: direct + no residual
                mx, my = mbidx % sps.mb_w, mbidx // sps.mb_w
                do_direct(mx, my, has_resid=False)
                mbidx += 1
                if mbidx >= n:
                    break
            if mbidx >= n:
                break
            mx, my = mbidx % sps.mb_w, mbidx // sps.mb_w
            mb_type = r.ue()
            if mb_type > 3:
                raise NotImplementedError(f"B mb_type {mb_type}")
            if mb_type == 0:                # B_Direct_16x16
                do_direct(mx, my, has_resid=True)
            else:
                mode = mb_type - 1          # 0=L0 1=L1 2=BI
                mv0 = mv1 = None
                if mode != 1:
                    mvd0 = np.array([r.se(), r.se()], np.int64)
                    mv0 = self._mvp_match(mvf0, use0, mx, my) + mvd0
                if mode != 0:
                    mvd1 = np.array([r.se(), r.se()], np.int64)
                    mv1 = self._mvp_match(mvf1, use1, mx, my) + mvd1
                self._b_mc(y, u, v, planes0, planes1, ru0, rv0, ru1, rv1,
                           mx, my, mode, mv0, mv1, w0, w1)
                if mv0 is not None:
                    mvf0[my, mx] = mv0
                    use0[my, mx] = True
                if mv1 is not None:
                    mvf1[my, mx] = mv1
                    use1[my, mx] = True
            cbp_code = r.ue()
            if cbp_code >= 48:
                raise ValueError("bad cbp code")
            cbp = int(_CBP_FROM_GOLOMB_INTER[cbp_code])
            cbp_l, cbp_c = cbp & 15, cbp >> 4
            if cbp_l and pps.transform_8x8 and r.u1():
                raise NotImplementedError("8x8 transform decode")
            if cbp:
                qp += r.se()
            qp_map[my, mx] = qp
            self._decode_inter_resid(r, y, u, v, nnz_l, nnz_c, mx, my,
                                     cbp_l, cbp_c, qp)
            mbidx += 1
        np.clip(y, 0, 255, out=y)
        np.clip(u, 0, 255, out=u)
        np.clip(v, 0, 255, out=v)
        if self._db[0] != 1:
            y, u, v = deblock_frame_ref(
                y, u, v, qp_map, np.zeros((sps.mb_h, sps.mb_w), bool),
                nnz_l, mvf0, self._db[1], self._db[2],
                pps.chroma_qp_index_offset,
                b_info=(use0, use1, mvf0, mvf1))
        self._finish_frame(y, u, v)

    def _b_mc(self, y, u, v, planes0, planes1, ru0, rv0, ru1, rv1,
              mx, my, mode, mv0, mv1, w0, w1):
        """Write the B prediction for one 16x16 MB into y/u/v (spec
        8.4.2.3: bipred = Clip((p0*w0 + p1*w1 + 32) >> 6))."""
        def lmc(planes, mv):
            return self._luma_mc(planes, mx * 16, my * 16,
                                 int(mv[0]), int(mv[1]))

        def cmc(plane, mv):
            return self._chroma_mc(plane, mx * 8, my * 8,
                                   int(mv[0]), int(mv[1]))
        if mode == 0:
            py, pu, pv = lmc(planes0, mv0), cmc(ru0, mv0), cmc(rv0, mv0)
        elif mode == 1:
            py, pu, pv = lmc(planes1, mv1), cmc(ru1, mv1), cmc(rv1, mv1)
        else:
            def bi(a, b):
                return np.clip((a.astype(np.int64) * w0
                                + b.astype(np.int64) * w1 + 32) >> 6,
                               0, 255)
            py = bi(lmc(planes0, mv0), lmc(planes1, mv1))
            pu = bi(cmc(ru0, mv0), cmc(ru1, mv1))
            pv = bi(cmc(rv0, mv0), cmc(rv1, mv1))
        y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = py
        u[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = pu
        v[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = pv

    # ------------------------------------------------ CABAC slice decode
    def _decode_slice_cabac(self, r: BitReader, slice_type: int,
                            slice_qp: int, model: int, num_ref: int):
        """CABAC slice body for I / P / B with the encoder's emitted MB
        modes (I16x16, P_Skip/P_L0_16x16/I16-in-P, B L0/L1/BI 16x16).
        Syntax is the inverse of native/cabac.cpp's writer; arithmetic is
        the spec 9.3.3.2 engine above."""
        sps, pps = self.sps, self.pps
        mbw, mbh = sps.mb_w, sps.mb_h
        n = mbw * mbh
        r.byte_align()                      # cabac_alignment_one_bit
        data = np.packbits(r.bits[r.pos:]).tobytes()
        cb = CabacReader(data, model, slice_type == 2, slice_qp)
        W, H = mbw * 16, mbh * 16
        y = np.zeros((H, W), np.int64)
        u = np.zeros((H // 2, W // 2), np.int64)
        v = np.zeros((H // 2, W // 2), np.int64)
        nnz_l = np.zeros((mbh * 4, mbw * 4), np.int32)
        nnz_c = np.zeros((2, mbh * 2, mbw * 2), np.int32)
        qp_map = np.zeros((mbh, mbw), np.int32)
        # neighbor caches (MBInfo mirror of the encoder's writer)
        c_coded = np.zeros((mbh, mbw), bool)
        c_skip = np.zeros((mbh, mbw), bool)
        c_direct = np.zeros((mbh, mbw), bool)
        c_not_i4x4 = np.zeros((mbh, mbw), bool)
        c_cpm = np.zeros((mbh, mbw), np.int32)
        c_cbp_l = np.zeros((mbh, mbw), np.int32)
        c_cbp_c = np.zeros((mbh, mbw), np.int32)
        c_dcnnz = np.zeros((mbh, mbw, 3), np.int32)
        # |mvd| context state at 4x4 granularity (spec 9.3.3.1.1.7 —
        # the neighbors of a 16x8/8x16 partition are partition cells)
        c_mvd4 = np.zeros((mbh * 4, mbw * 4, 2, 2), np.int64)
        intra_map = np.zeros((mbh, mbw), bool)
        mvf0 = np.zeros((mbh, mbw, 2), np.int64)
        mvf1 = np.zeros((mbh, mbw, 2), np.int64)
        use0 = np.zeros((mbh, mbw), bool)
        use1 = np.zeros((mbh, mbw), bool)
        # 4x4-granular motion state for P partitions
        mv40 = np.zeros((mbh * 4, mbw * 4, 2), np.int64)
        use40 = np.zeros((mbh * 4, mbw * 4), bool)
        filled40 = np.zeros((mbh * 4, mbw * 4), bool)
        # Intra_4x4 pred-mode grid for MPM (8.3.1.1); non-I4 blocks = DC
        c_i4m = np.full((mbh * 4, mbw * 4), 2, np.int64)
        last_qp = slice_qp
        state = {"last_dqp": 0}

        # reference setup
        planes0 = planes1 = ru0 = rv0 = ru1 = rv1 = None
        w0 = w1 = 32
        PAD = 32
        self._mc_pad = PAD
        p_refs = None
        p_planes = None
        multi = False
        ref40 = np.zeros((mbh * 4, mbw * 4), np.int32)
        refgt0 = np.zeros((mbh * 4, mbw * 4), bool)  # ref_idx ctx source
        if slice_type == 0:
            l0 = self._l0_entries()
            p_refs = [e["planes"] for e in l0[:max(1, num_ref)]] \
                or [self._ref]
            multi = num_ref > 1 and len(p_refs) > 1
            p_planes = [self._interp_planes(np.pad(rp[0], PAD,
                                                   mode="edge"))
                        for rp in p_refs]
            ry0, ru0, rv0 = p_refs[0]
            planes0 = p_planes[0]
        elif slice_type == 1:
            l0, l1 = self._b_refs()
            ry0, ru0, rv0 = l0["planes"]
            ry1, ru1, rv1 = l1["planes"]
            planes0 = self._interp_planes(np.pad(ry0, PAD, mode="edge"))
            planes1 = self._interp_planes(np.pad(ry1, PAD, mode="edge"))
            if pps.weighted_bipred_idc == 2:
                w0, w1 = self._implicit_w(self._cur_poc, l0["poc"],
                                          l1["poc"])
            col_inter = l1.get("interf")
            col_mv = l1.get("mvf")
            col_mv4 = l1.get("mvf4")
            if col_inter is None or col_mv is None:
                col_inter = np.zeros((mbh, mbw), bool)
                col_mv = np.zeros((mbh, mbw, 2), np.int64)
                col_mv4 = None

        def nzl(gx, gy, intra_cur):
            if gx < 0 or gy < 0:
                return intra_cur
            return 1 if nnz_l[gy, gx] > 0 else 0

        def nzc(pl, gx, gy, intra_cur):
            if gx < 0 or gy < 0:
                return intra_cur
            return 1 if nnz_c[pl, gy, gx] > 0 else 0

        def read_cbf_res(cat, nx, gx, gy, nza, nzb):
            """decision(cbf) then residual; returns (coeffs, nnz)."""
            ctx = _C_CBF_BASE[cat] + 2 * (1 if nzb else 0) \
                + (1 if nza else 0)
            if cb.decision(ctx):
                coeffs = _cabac_residual(cb, cat, nx)
                return coeffs, int(np.count_nonzero(coeffs))
            return np.zeros(nx, np.int64), 0

        def read_mvd_pair(mx, my, lst, px=0, py=0, pw=4, ph=4):
            """(px,py,pw,ph) = partition geometry in 4x4 units within
            the MB; ctx neighbors are the cells left/above its corner."""
            out = np.zeros(2, np.int64)
            gx, gy = mx * 4 + px, my * 4 + py
            for comp in range(2):
                amvd = (c_mvd4[gy, gx - 1, lst, comp] if gx > 0 else 0) \
                    + (c_mvd4[gy - 1, gx, lst, comp] if gy > 0 else 0)
                ctx = (1 if amvd > 2 else 0) + (1 if amvd > 32 else 0)
                vv = _cabac_mvd(cb, 47 if comp else 40, ctx)
                out[comp] = vv
                c_mvd4[gy:gy + ph, gx:gx + pw, lst, comp] = \
                    min(abs(int(vv)), 66)
            return out

        def read_ref_idx(mx, my, px, py, pw, ph):
            """ref_idx_l0 for one partition: U binarization, bin0 ctx
            54 + condTermFlagA + 2*condTermFlagB (spec 9.3.3.1.1.6),
            binIdx1 ctx 58, binIdx>=2 ctx 59; updates the partition's
            refgt0 cells (inverse of native/cabac.cpp
            write_ref_idx_part)."""
            gx, gy = mx * 4 + px, my * 4 + py
            condA = refgt0[gy, gx - 1] if gx > 0 else 0
            condB = refgt0[gy - 1, gx] if gy > 0 else 0
            ctx = 54 + int(condA) + 2 * int(condB)
            ref = 0
            if cb.decision(ctx):
                ref = 1
                while cb.decision(58 if ref == 1 else 59):
                    ref += 1
                    if ref > 32:
                        raise ValueError("ref_idx runaway")
            refgt0[gy:gy + ph, gx:gx + pw] = ref > 0
            return ref

        def read_dqp(has_residual):
            if has_residual:
                dqp = _cabac_qp_delta(cb, state["last_dqp"])
                state["last_dqp"] = dqp
                return dqp
            state["last_dqp"] = 0
            return 0

        def read_intra_payload(mx, my, cbp_l, cbp_c, qp):
            """chroma mode + dqp + I16 residual (cat 0/1/3/4)."""
            ctx = 64
            if mx > 0 and c_coded[my, mx - 1] and c_cpm[my, mx - 1] != 0:
                ctx += 1
            if my > 0 and c_coded[my - 1, mx] and c_cpm[my - 1, mx] != 0:
                ctx += 1
            chroma_mode = 0
            if cb.decision(ctx):
                chroma_mode = 1 + cb.decision(64 + 3)
                if chroma_mode == 2:
                    chroma_mode += cb.decision(64 + 3)
            dqp = _cabac_qp_delta(cb, state["last_dqp"])
            state["last_dqp"] = dqp
            qp = (qp + dqp) % 52
            # luma DC (cat 0)
            nza = (c_dcnnz[my, mx - 1, 0] if c_coded[my, mx - 1] else 0) \
                if mx > 0 else 1
            nzb = (c_dcnnz[my - 1, mx, 0] if c_coded[my - 1, mx] else 0) \
                if my > 0 else 1
            dc_scan, dc_nnz = read_cbf_res(0, 16, 0, 0, nza, nzb)
            c_dcnnz[my, mx, 0] = dc_nnz
            # luma AC (cat 1) if cbp_l, z-scan
            ac = np.zeros((16, 16), np.int64)
            if cbp_l:
                for bz in range(16):
                    bx4, by4 = int(ZBLK_X[bz]), int(ZBLK_Y[bz])
                    raster = by4 * 4 + bx4
                    gx, gy = mx * 4 + bx4, my * 4 + by4
                    coeffs, tot = read_cbf_res(
                        1, 15, gx, gy, nzl(gx - 1, gy, 1),
                        nzl(gx, gy - 1, 1))
                    ac[raster, 1:] = coeffs
                    nnz_l[gy, gx] = tot
            else:
                nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
            # chroma DC (cat 3) if cbp_c
            cdc = np.zeros((2, 4), np.int64)
            for pl in range(2):
                if not cbp_c:
                    c_dcnnz[my, mx, 1 + pl] = 0
                    continue
                nza = (c_dcnnz[my, mx - 1, 1 + pl]
                       if c_coded[my, mx - 1] else 1) if mx > 0 else 1
                nzb = (c_dcnnz[my - 1, mx, 1 + pl]
                       if c_coded[my - 1, mx] else 1) if my > 0 else 1
                cdc[pl], dnz = read_cbf_res(3, 4, 0, 0, nza, nzb)
                c_dcnnz[my, mx, 1 + pl] = dnz
            # chroma AC (cat 4) if cbp_c == 2
            cac = np.zeros((2, 4, 16), np.int64)
            for pl in range(2):
                for blk in range(4):
                    gx, gy = mx * 2 + (blk & 1), my * 2 + (blk >> 1)
                    if cbp_c != 2:
                        nnz_c[pl, gy, gx] = 0
                        continue
                    coeffs, tot = read_cbf_res(
                        4, 15, gx, gy, nzc(pl, gx - 1, gy, 1),
                        nzc(pl, gx, gy - 1, 1))
                    cac[pl, blk, 1:] = coeffs
                    nnz_c[pl, gy, gx] = tot
            return chroma_mode, qp, dc_scan, ac, cdc, cac

        def read_i4_modes(mx, my):
            """16 prev/rem pred-mode elements (z-scan, ctx 68/69)."""
            modes = np.zeros(16, np.int32)
            for z in range(16):
                bx, by = int(ZBLK_X[z]), int(ZBLK_Y[z])
                gx, gy = mx * 4 + bx, my * 4 + by
                if gx == 0 or gy == 0:
                    mpm = 2
                else:
                    mpm = min(int(c_i4m[gy, gx - 1]),
                              int(c_i4m[gy - 1, gx]))
                if cb.decision(68):
                    mode = mpm
                else:
                    rem = cb.decision(69) | (cb.decision(69) << 1) \
                        | (cb.decision(69) << 2)
                    mode = rem + (1 if rem >= mpm else 0)
                c_i4m[gy, gx] = mode
                modes[by * 4 + bx] = mode
            return modes

        def read_chroma_pred_mode(mx, my):
            ctx = 64
            if mx > 0 and c_coded[my, mx - 1] and c_cpm[my, mx - 1] != 0:
                ctx += 1
            if my > 0 and c_coded[my - 1, mx] and c_cpm[my - 1, mx] != 0:
                ctx += 1
            chroma_mode = 0
            if cb.decision(ctx):
                chroma_mode = 1 + cb.decision(64 + 3)
                if chroma_mode == 2:
                    chroma_mode += cb.decision(64 + 3)
            return chroma_mode

        def read_i4_payload(mx, my):
            """cbp + dqp + I4 residual (cat 2 luma with intra nnz
            defaults, chroma 3/4 with intra defaults)."""
            cl = (c_cbp_l[my, mx - 1] | (c_cbp_c[my, mx - 1] << 4)) \
                if mx > 0 and c_coded[my, mx - 1] else -1
            ct = (c_cbp_l[my - 1, mx] | (c_cbp_c[my - 1, mx] << 4)) \
                if my > 0 and c_coded[my - 1, mx] else -1
            b0 = cb.decision(76 - ((cl >> 1) & 1) - ((ct >> 1) & 2))
            b1 = cb.decision(76 - b0 - ((ct >> 2) & 2))
            b2 = cb.decision(76 - ((cl >> 3) & 1) - 2 * b0)
            b3 = cb.decision(76 - b2 - 2 * b1)
            cbp_l = b0 | (b1 << 1) | (b2 << 2) | (b3 << 3)
            ca = 0 if cl == -1 else cl & 0x30
            cbb = 0 if ct == -1 else ct & 0x30
            ctx = (1 if ca else 0) + 2 * (1 if cbb else 0)
            cbp_c = 0
            if cb.decision(77 + ctx):
                ctx = 4 + (1 if ca == 0x20 else 0) \
                    + 2 * (1 if cbb == 0x20 else 0)
                cbp_c = 1 + cb.decision(77 + ctx)
            dqp = read_dqp(cbp_l or cbp_c)
            qp = (qp_state["last_qp"] + dqp) % 52
            qp_state["last_qp"] = qp
            luma = np.zeros((16, 16), np.int64)
            for bz in range(16):
                bx4, by4 = int(ZBLK_X[bz]), int(ZBLK_Y[bz])
                raster = by4 * 4 + bx4
                quad = (by4 >> 1) * 2 + (bx4 >> 1)
                gx, gy = mx * 4 + bx4, my * 4 + by4
                if cbp_l & (1 << quad):
                    coeffs, tot = read_cbf_res(
                        2, 16, gx, gy, nzl(gx - 1, gy, 1),
                        nzl(gx, gy - 1, 1))
                    luma[raster] = coeffs
                    nnz_l[gy, gx] = tot
                else:
                    nnz_l[gy, gx] = 0
            cdc = np.zeros((2, 4), np.int64)
            for pl in range(2):
                if not cbp_c:
                    c_dcnnz[my, mx, 1 + pl] = 0
                    continue
                nza = (c_dcnnz[my, mx - 1, 1 + pl]
                       if c_coded[my, mx - 1] else 1) if mx > 0 else 1
                nzb = (c_dcnnz[my - 1, mx, 1 + pl]
                       if c_coded[my - 1, mx] else 1) if my > 0 else 1
                cdc[pl], dnz = read_cbf_res(3, 4, 0, 0, nza, nzb)
                c_dcnnz[my, mx, 1 + pl] = dnz
            cac = np.zeros((2, 4, 16), np.int64)
            for pl in range(2):
                for blk in range(4):
                    gx, gy = mx * 2 + (blk & 1), my * 2 + (blk >> 1)
                    if cbp_c != 2:
                        nnz_c[pl, gy, gx] = 0
                        continue
                    coeffs, tot = read_cbf_res(
                        4, 15, gx, gy, nzc(pl, gx - 1, gy, 1),
                        nzc(pl, gx, gy - 1, 1))
                    cac[pl, blk, 1:] = coeffs
                    nnz_c[pl, gy, gx] = tot
            return cbp_l, cbp_c, qp, luma, cdc, cac

        def decode_i4_mb(mx, my):
            """Full I_4x4 MB (modes, chroma mode, payload, recon) +
            neighbor cache update; shared by the I and P bodies."""
            modes = read_i4_modes(mx, my)
            chroma_mode = read_chroma_pred_mode(mx, my)
            cbp_l, cbp_c, qp, luma, cdc, cac = read_i4_payload(mx, my)
            self._recon_i4_arrays(y, u, v, mx, my, modes, chroma_mode,
                                  qp, luma, cdc, cac)
            intra_map[my, mx] = True
            c_not_i4x4[my, mx] = False
            c_cpm[my, mx] = chroma_mode
            c_cbp_l[my, mx] = cbp_l
            c_cbp_c[my, mx] = cbp_c
            c_dcnnz[my, mx, 0] = 0
            return qp

        def read_inter_payload(mx, my):
            """cbp + dqp + inter residual (cat 2/3/4)."""
            cl = (c_cbp_l[my, mx - 1] | (c_cbp_c[my, mx - 1] << 4)) \
                if mx > 0 and c_coded[my, mx - 1] else -1
            ct = (c_cbp_l[my - 1, mx] | (c_cbp_c[my - 1, mx] << 4)) \
                if my > 0 and c_coded[my - 1, mx] else -1
            b0 = cb.decision(76 - ((cl >> 1) & 1) - ((ct >> 1) & 2))
            b1 = cb.decision(76 - b0 - ((ct >> 2) & 2))
            b2 = cb.decision(76 - ((cl >> 3) & 1) - 2 * b0)
            b3 = cb.decision(76 - b2 - 2 * b1)
            cbp_l = b0 | (b1 << 1) | (b2 << 2) | (b3 << 3)
            ca = 0 if cl == -1 else cl & 0x30
            cbb = 0 if ct == -1 else ct & 0x30
            ctx = (1 if ca else 0) + 2 * (1 if cbb else 0)
            cbp_c = 0
            if cb.decision(77 + ctx):
                ctx = 4 + (1 if ca == 0x20 else 0) \
                    + 2 * (1 if cbb == 0x20 else 0)
                cbp_c = 1 + cb.decision(77 + ctx)
            dqp = read_dqp(cbp_l or cbp_c)
            qp = (qp_state["last_qp"] + dqp) % 52
            qp_state["last_qp"] = qp
            luma = np.zeros((16, 16), np.int64)
            for bz in range(16):
                bx4, by4 = int(ZBLK_X[bz]), int(ZBLK_Y[bz])
                raster = by4 * 4 + bx4
                quad = (by4 >> 1) * 2 + (bx4 >> 1)
                gx, gy = mx * 4 + bx4, my * 4 + by4
                if cbp_l & (1 << quad):
                    coeffs, tot = read_cbf_res(
                        2, 16, gx, gy, nzl(gx - 1, gy, 0),
                        nzl(gx, gy - 1, 0))
                    luma[raster] = coeffs
                    nnz_l[gy, gx] = tot
                else:
                    nnz_l[gy, gx] = 0
            cdc = np.zeros((2, 4), np.int64)
            for pl in range(2):
                if not cbp_c:
                    c_dcnnz[my, mx, 1 + pl] = 0
                    continue
                nza = (c_dcnnz[my, mx - 1, 1 + pl]
                       if c_coded[my, mx - 1] else 0) if mx > 0 else 0
                nzb = (c_dcnnz[my - 1, mx, 1 + pl]
                       if c_coded[my - 1, mx] else 0) if my > 0 else 0
                cdc[pl], dnz = read_cbf_res(3, 4, 0, 0, nza, nzb)
                c_dcnnz[my, mx, 1 + pl] = dnz
            cac = np.zeros((2, 4, 16), np.int64)
            for pl in range(2):
                for blk in range(4):
                    gx, gy = mx * 2 + (blk & 1), my * 2 + (blk >> 1)
                    if cbp_c != 2:
                        nnz_c[pl, gy, gx] = 0
                        continue
                    coeffs, tot = read_cbf_res(
                        4, 15, gx, gy, nzc(pl, gx - 1, gy, 0),
                        nzc(pl, gx, gy - 1, 0))
                    cac[pl, blk, 1:] = coeffs
                    nnz_c[pl, gy, gx] = tot
            return cbp_l, cbp_c, qp, luma, cdc, cac

        qp_state = {"last_qp": slice_qp}

        for mbidx in range(n):
            mx, my = mbidx % mbw, mbidx // mbw
            if slice_type != 2:
                ctx = 24 if slice_type == 1 else 11
                if mx > 0 and c_coded[my, mx - 1] and not c_skip[my, mx - 1]:
                    ctx += 1
                if my > 0 and c_coded[my - 1, mx] and not c_skip[my - 1, mx]:
                    ctx += 1
                if cb.decision(ctx):        # mb_skip_flag
                    if slice_type == 1:
                        # B_Skip: spatial direct prediction, no residual
                        u0, u1, m0, m1 = self._derive_direct_mb(
                            mvf0, use0, mvf1, use1, mx, my,
                            col_inter, col_mv, col_mv4)
                        dmode = 2 if (u0 and u1) else (0 if u0 else 1)
                        self._b_mc(y, u, v, planes0, planes1, ru0, rv0,
                                   ru1, rv1, mx, my, dmode, m0, m1,
                                   w0, w1)
                        use0[my, mx], use1[my, mx] = u0, u1
                        mvf0[my, mx] = m0 if u0 else 0
                        mvf1[my, mx] = m1 if u1 else 0
                        c_coded[my, mx] = True
                        c_skip[my, mx] = True
                        c_direct[my, mx] = True
                        c_not_i4x4[my, mx] = True
                        c_cpm[my, mx] = 0
                        c_cbp_l[my, mx] = 0
                        c_cbp_c[my, mx] = 0
                        c_dcnnz[my, mx] = 0
                        c_mvd4[my * 4:my * 4 + 4,
                               mx * 4:mx * 4 + 4] = 0
                        nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                        nnz_c[:, my * 2:my * 2 + 2,
                              mx * 2:mx * 2 + 2] = 0
                        state["last_dqp"] = 0
                        qp_map[my, mx] = qp_state["last_qp"]
                        if cb.terminal() != (1 if mbidx == n - 1 else 0):
                            raise ValueError("end_of_slice desync")
                        continue
                    mv = self._pskip_mv4(mv40, use40, filled40, mx, my,
                                         ref4=ref40 if multi else None)
                    mvf0[my, mx] = mv
                    use0[my, mx] = True
                    s4 = np.s_[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4]
                    mv40[s4] = mv
                    use40[s4] = True
                    ref40[s4] = 0
                    filled40[s4] = True
                    pred = self._luma_mc(planes0, mx * 16, my * 16,
                                         int(mv[0]), int(mv[1]))
                    y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = \
                        self._wp_apply(pred)
                    u[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = \
                        self._chroma_mc(ru0, mx * 8, my * 8,
                                        int(mv[0]), int(mv[1]))
                    v[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = \
                        self._chroma_mc(rv0, mx * 8, my * 8,
                                        int(mv[0]), int(mv[1]))
                    c_coded[my, mx] = True
                    c_skip[my, mx] = True
                    c_not_i4x4[my, mx] = True
                    c_cpm[my, mx] = 0
                    c_cbp_l[my, mx] = 0
                    c_cbp_c[my, mx] = 0
                    c_dcnnz[my, mx] = 0
                    c_mvd4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                    nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                    nnz_c[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
                    state["last_dqp"] = 0
                    qp_map[my, mx] = qp_state["last_qp"]
                    if cb.terminal() != (1 if mbidx == n - 1 else 0):
                        raise ValueError("end_of_slice desync")
                    continue

            if slice_type == 2:
                # I slice mb_type prefix
                ctx = 3
                if mx > 0 and c_coded[my, mx - 1] and c_not_i4x4[my, mx - 1]:
                    ctx += 1
                if my > 0 and c_coded[my - 1, mx] and c_not_i4x4[my - 1, mx]:
                    ctx += 1
                if cb.decision(ctx) == 0:
                    qp = decode_i4_mb(mx, my)
                    c_coded[my, mx] = True
                    qp_map[my, mx] = qp
                    if cb.terminal() != (1 if mbidx == n - 1 else 0):
                        raise ValueError("end_of_slice desync")
                    continue
                if cb.terminal():
                    raise NotImplementedError("I_PCM CABAC")
                cbp_l = 15 * cb.decision(3 + 3)
                cbp_c = 0
                if cb.decision(3 + 4):
                    cbp_c = 1 + cb.decision(3 + 5)
                i16_mode = 2 * cb.decision(3 + 6) + cb.decision(3 + 7)
                chroma_mode, qp, dc_scan, ac, cdc, cac = \
                    read_intra_payload(mx, my, cbp_l, cbp_c,
                                       qp_state["last_qp"])
                qp_state["last_qp"] = qp
                self._recon_i16_arrays(y, u, v, mx, my, i16_mode,
                                       chroma_mode, qp, dc_scan, ac,
                                       cdc, cac)
                intra_map[my, mx] = True
                c_cpm[my, mx] = chroma_mode
                c_cbp_l[my, mx] = cbp_l
                c_cbp_c[my, mx] = cbp_c
            elif slice_type == 0:
                if cb.decision(14):         # intra in P
                    if cb.decision(17) == 0:
                        qp = decode_i4_mb(mx, my)
                        c_coded[my, mx] = True
                        qp_map[my, mx] = qp
                        filled40[my * 4:my * 4 + 4,
                                 mx * 4:mx * 4 + 4] = True
                        if cb.terminal() != (1 if mbidx == n - 1 else 0):
                            raise ValueError("end_of_slice desync")
                        continue
                    if cb.terminal():
                        raise NotImplementedError("I_PCM in P")
                    cbp_l = 15 * cb.decision(17 + 1)
                    cbp_c = 0
                    if cb.decision(17 + 2):
                        cbp_c = 1 + cb.decision(17 + 2)
                    i16_mode = 2 * cb.decision(17 + 3) \
                        + cb.decision(17 + 3)
                    chroma_mode, qp, dc_scan, ac, cdc, cac = \
                        read_intra_payload(mx, my, cbp_l, cbp_c,
                                           qp_state["last_qp"])
                    qp_state["last_qp"] = qp
                    self._recon_i16_arrays(y, u, v, mx, my, i16_mode,
                                           chroma_mode, qp, dc_scan, ac,
                                           cdc, cac)
                    intra_map[my, mx] = True
                    filled40[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
                    c_cpm[my, mx] = chroma_mode
                    c_cbp_l[my, mx] = cbp_l
                    c_cbp_c[my, mx] = cbp_c
                else:
                    # mb_type bins (spec table 9-34 P): 000=16x16,
                    # 001=P_8x8, 010=8x16, 011=16x8
                    if cb.decision(15):
                        part = 1 if cb.decision(17) else 2
                    else:
                        if cb.decision(16):
                            raise NotImplementedError("P 8x8 CABAC")
                        part = 0
                    if part == 0:
                        geoms = [(0, 0, 4, 4)]
                    elif part == 1:                     # 16x8
                        geoms = [(0, 0, 4, 2), (0, 2, 4, 2)]
                    else:                               # 8x16
                        geoms = [(0, 0, 2, 4), (2, 0, 2, 4)]
                    # all ref_idx first, then all mvd (spec 7.3.5.1)
                    if multi:
                        prefs = [read_ref_idx(mx, my, *g) for g in geoms]
                    else:
                        prefs = [0] * len(geoms)
                    for pi, (px, py, pw, ph) in enumerate(geoms):
                        mvd = read_mvd_pair(mx, my, 0, px, py, pw, ph)
                        mv = self._mvp_part(
                            mv40, use40, filled40, mx, my, part, pi,
                            ref4=ref40 if multi else None,
                            cur_ref=prefs[pi]) + mvd
                        s4 = np.s_[my * 4 + py:my * 4 + py + ph,
                                   mx * 4 + px:mx * 4 + px + pw]
                        mv40[s4] = mv
                        use40[s4] = True
                        ref40[s4] = prefs[pi]
                        filled40[s4] = True
                        if pi == 0:
                            mvf0[my, mx] = mv
                            use0[my, mx] = prefs[pi] == 0
                        x0, y0 = mx * 16 + px * 4, my * 16 + py * 4
                        lw, lh = pw * 4, ph * 4
                        _, rup, rvp = p_refs[prefs[pi]]
                        y[y0:y0 + lh, x0:x0 + lw] = self._wp_apply(
                            self._luma_mc(p_planes[prefs[pi]], x0, y0,
                                          int(mv[0]), int(mv[1]),
                                          bs=(lh, lw)), prefs[pi])
                        cx, cy = x0 // 2, y0 // 2
                        cw, chh = lw // 2, lh // 2
                        u[cy:cy + chh, cx:cx + cw] = self._chroma_mc(
                            rup, cx, cy, int(mv[0]), int(mv[1]),
                            bs=(chh, cw))
                        v[cy:cy + chh, cx:cx + cw] = self._chroma_mc(
                            rvp, cx, cy, int(mv[0]), int(mv[1]),
                            bs=(chh, cw))
                    cbp_l, cbp_c, qp, luma, cdc, cac = \
                        read_inter_payload(mx, my)
                    self._apply_resid_arrays(y, u, v, mx, my, qp, luma,
                                             cdc, cac)
                    c_cpm[my, mx] = 0
                    c_cbp_l[my, mx] = cbp_l
                    c_cbp_c[my, mx] = cbp_c
            else:                           # B slice
                ctx = 27
                if (mx > 0 and c_coded[my, mx - 1]
                        and not c_skip[my, mx - 1]
                        and not c_direct[my, mx - 1]):
                    ctx += 1
                if (my > 0 and c_coded[my - 1, mx]
                        and not c_skip[my - 1, mx]
                        and not c_direct[my - 1, mx]):
                    ctx += 1
                if cb.decision(ctx) == 0:
                    # B_Direct_16x16 with residual
                    u0, u1, m0, m1 = self._derive_direct_mb(
                        mvf0, use0, mvf1, use1, mx, my,
                        col_inter, col_mv, col_mv4)
                    dmode = 2 if (u0 and u1) else (0 if u0 else 1)
                    self._b_mc(y, u, v, planes0, planes1, ru0, rv0,
                               ru1, rv1, mx, my, dmode, m0, m1, w0, w1)
                    use0[my, mx], use1[my, mx] = u0, u1
                    mvf0[my, mx] = m0 if u0 else 0
                    mvf1[my, mx] = m1 if u1 else 0
                    c_direct[my, mx] = True
                    cbp_l, cbp_c, qp, luma, cdc, cac = \
                        read_inter_payload(mx, my)
                    self._apply_resid_arrays(y, u, v, mx, my, qp, luma,
                                             cdc, cac)
                    c_cpm[my, mx] = 0
                    c_cbp_l[my, mx] = cbp_l
                    c_cbp_c[my, mx] = cbp_c
                    c_coded[my, mx] = True
                    c_skip[my, mx] = False
                    c_not_i4x4[my, mx] = True
                    qp_map[my, mx] = qp_state["last_qp"]
                    if cb.terminal() != (1 if mbidx == n - 1 else 0):
                        raise ValueError("end_of_slice desync")
                    continue
                if cb.decision(27 + 3) == 0:
                    bmode = cb.decision(27 + 5)      # 0=L0, 1=L1
                else:
                    if cb.decision(27 + 4):
                        raise NotImplementedError("B large mb_type")
                    bits = [cb.decision(27 + 5) for _ in range(3)]
                    if any(bits):
                        raise NotImplementedError("B sub mb_type")
                    bmode = 2                        # BI
                mv0 = mv1 = None
                if bmode != 1:
                    mvd0 = read_mvd_pair(mx, my, 0)
                    mv0 = self._mvp_match(mvf0, use0, mx, my) + mvd0
                if bmode != 0:
                    mvd1 = read_mvd_pair(mx, my, 1)
                    mv1 = self._mvp_match(mvf1, use1, mx, my) + mvd1
                self._b_mc(y, u, v, planes0, planes1, ru0, rv0, ru1, rv1,
                           mx, my, bmode, mv0, mv1, w0, w1)
                if mv0 is not None:
                    mvf0[my, mx] = mv0
                    use0[my, mx] = True
                if mv1 is not None:
                    mvf1[my, mx] = mv1
                    use1[my, mx] = True
                cbp_l, cbp_c, qp, luma, cdc, cac = read_inter_payload(
                    mx, my)
                self._apply_resid_arrays(y, u, v, mx, my, qp, luma,
                                         cdc, cac)
                c_cpm[my, mx] = 0
                c_cbp_l[my, mx] = cbp_l
                c_cbp_c[my, mx] = cbp_c
            c_coded[my, mx] = True
            c_skip[my, mx] = False
            c_not_i4x4[my, mx] = True
            qp_map[my, mx] = qp_state["last_qp"]
            if cb.terminal() != (1 if mbidx == n - 1 else 0):
                raise ValueError("end_of_slice desync")

        np.clip(y, 0, 255, out=y)
        np.clip(u, 0, 255, out=u)
        np.clip(v, 0, 255, out=v)
        self.last_mvf = mvf0.copy()
        self.last_qp_map = qp_map.copy()
        self.last_intra_map = intra_map.copy()
        if slice_type != 1:
            self._pending_fields = {"mvf": mvf0.copy(),
                                    "interf": use0.copy(),
                                    "mvf4": mv40.copy()}
        if self._db[0] != 1:
            b_info = (use0, use1, mvf0, mvf1) if slice_type == 1 else None
            y, u, v = deblock_frame_ref(
                y, u, v, qp_map, intra_map, nnz_l,
                mv40 if slice_type == 0 else mvf0,
                self._db[1], self._db[2], pps.chroma_qp_index_offset,
                b_info=b_info,
                ref4=ref40 if (slice_type == 0 and multi) else None)
        self._finish_frame(y, u, v)


# ------------------------------------------------------- CABAC (spec 9.3.3)
from . import cabac_tables as CT  # noqa: E402  spec tables (own copy)


class CabacReader:
    """Arithmetic decoding engine, spec 9.3.3.2 (DecodeDecision /
    DecodeBypass / DecodeTerminate with the 9.3.3.2.2 renormalization).
    Independent of the encoder's C++ engine; shares only the normative
    constant tables."""

    def __init__(self, data: bytes, model: int, slice_is_i: bool, qp: int):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0
        self.range = 510
        self.offset = self._read(9)
        tab = CT.CTX_INIT_I if slice_is_i else CT.CTX_INIT_PB[model]
        m = tab[:, 0].astype(np.int64)
        nn = tab[:, 1].astype(np.int64)
        pre = np.clip(((m * int(np.clip(qp, 0, 51))) >> 4) + nn, 1, 126)
        self.mps = (pre > 63).astype(np.int32)
        self.pstate = np.where(pre > 63, pre - 64, 63 - pre) \
            .astype(np.int32)

    def _read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            b = int(self.bits[self.pos]) if self.pos < len(self.bits) else 0
            self.pos += 1
            v = (v << 1) | b
        return v

    def decision(self, ctx: int) -> int:
        ps = int(self.pstate[ctx])
        rlps = int(CT.RANGE_TAB_LPS[ps][(self.range >> 6) & 3])
        self.range -= rlps
        if self.offset >= self.range:
            b = 1 - int(self.mps[ctx])
            self.offset -= self.range
            self.range = rlps
            if ps == 0:
                self.mps[ctx] ^= 1
            self.pstate[ctx] = int(CT.TRANS_IDX_LPS[ps])
        else:
            b = int(self.mps[ctx])
            self.pstate[ctx] = int(CT.TRANS_IDX_MPS[ps])
        while self.range < 256:
            self.range <<= 1
            self.offset = ((self.offset << 1) | self._read(1)) & 0x3FFFF
        return b

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read(1)
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminal(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = ((self.offset << 1) | self._read(1)) & 0x3FFFF
        return 0

    def ue_bypass(self, k: int) -> int:
        """k-th order Exp-Golomb suffix in bypass mode (UEGk)."""
        base = 0
        while self.bypass():
            base += 1 << k
            k += 1
            if k > 30:
                raise ValueError("CABAC desync in UEGk")
        suffix = 0
        for _ in range(k):
            suffix = (suffix << 1) | self.bypass()
        return base + suffix


# residual context layout (spec table 9-40 numbering as used by the
# encoder's writer; see native/cabac.cpp)
_C_SIG_OFF = [105, 120, 134, 149, 152]
_C_LAST_OFF = [166, 181, 195, 210, 213]
_C_LVL_OFF = [227, 237, 247, 257, 266]
_C_CBF_BASE = [85, 89, 93, 97, 101]
_C_COUNT_M1 = [15, 14, 15, 3, 14]
_C_LVL1_CTX = [1, 2, 3, 4, 0, 0, 0, 0]
_C_LVLGT1_CTX = [5, 5, 5, 5, 6, 7, 8, 9]
_C_LVL_TRANS = [[1, 2, 3, 3, 4, 5, 6, 7], [4, 4, 4, 4, 5, 6, 7, 7]]
_C_MVD_CTXES = [3, 4, 5, 6, 6, 6, 6, 6]


def _cabac_residual(cb: CabacReader, cat: int, n: int) -> np.ndarray:
    """Decode one residual block's significance map + levels (the inverse
    of native/cabac.cpp block_residual). Returns n coeffs in scan order.
    Caller has already decoded cbf=1."""
    count_m1 = _C_COUNT_M1[cat]
    sig, lst = _C_SIG_OFF[cat], _C_LAST_OFF[cat]
    coeffs = np.zeros(n, np.int64)
    positions = []
    i = 0
    while True:
        if i == count_m1:
            positions.append(i)
            break
        if cb.decision(sig + i):
            positions.append(i)
            if cb.decision(lst + i):
                break
        i += 1
    node = 0
    lvl = _C_LVL_OFF[cat]
    for pos in reversed(positions):
        if cb.decision(_C_LVL1_CTX[node] + lvl):
            ctx2 = _C_LVLGT1_CTX[node] + lvl
            a = 2
            while a < 15 and cb.decision(ctx2):
                a += 1
            if a == 15:
                a += cb.ue_bypass(0)
            node = _C_LVL_TRANS[1][node]
        else:
            a = 1
            node = _C_LVL_TRANS[0][node]
        coeffs[pos] = -a if cb.bypass() else a
    return coeffs


def _cabac_mvd(cb: CabacReader, base: int, ctx: int) -> int:
    """Decode one mvd component (inverse of write_mvd_list)."""
    if cb.decision(base + ctx) == 0:
        return 0
    a = 1
    while a < 9 and cb.decision(base + _C_MVD_CTXES[a - 1]):
        a += 1
    if a == 9:
        a = 9 + cb.ue_bypass(3)
    return -a if cb.bypass() else a


def _cabac_qp_delta(cb: CabacReader, last_dqp: int) -> int:
    """Decode mb_qp_delta (inverse of write_qp_delta). Returns the mapped
    delta; caller applies (qp + dqp + 52) % 52."""
    ctx = 60 + (1 if last_dqp != 0 else 0)
    val = 0
    first = True
    while cb.decision(ctx):
        val += 1
        ctx = 60 + (2 if first else 3)
        first = False
        if val > 104:
            raise ValueError("CABAC dqp desync")
    if val == 0:
        return 0
    return (val + 1) // 2 if val % 2 else -(val // 2)


# ------------------------------------------------------------ deblocking
_DB_ALPHA = np.array(
    [0] * 16 + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
                32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144,
                162, 182, 203, 226, 255, 255])
_DB_BETA = np.array(
    [0] * 16 + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10,
                10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17,
                18, 18])
_DB_TC0 = np.array(
    [[0, 0, 0]] * 17
    + [[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1],
       [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2],
       [1, 1, 2], [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4],
       [2, 3, 4], [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7],
       [4, 5, 8], [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13],
       [7, 10, 14], [8, 11, 16], [9, 12, 18], [10, 13, 20], [11, 15, 23],
       [13, 17, 25]])


def _db_luma_line(pix, idx, stride, alpha, beta, tc0, bs):
    """Filter one luma line across an edge; pix flat int array,
    idx = index of q0, stride = step towards q3."""
    p = [int(pix[idx - k * stride]) for k in (3, 2, 1)]  # p2,p1,p0
    q = [int(pix[idx + k * stride]) for k in (0, 1, 2)]
    p2, p1, p0 = p
    q0, q1, q2 = q
    if abs(p0 - q0) >= alpha or abs(p1 - p0) >= beta or abs(q1 - q0) >= beta:
        return
    ap = abs(p2 - p0) < beta
    aq = abs(q2 - q0) < beta
    if bs == 4:
        if ap and abs(p0 - q0) < (alpha >> 2) + 2:
            p3 = int(pix[idx - 4 * stride])
            pix[idx - 1 * stride] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1
                                     + 4) >> 3
            pix[idx - 2 * stride] = (p2 + p1 + p0 + q0 + 2) >> 2
            pix[idx - 3 * stride] = (2 * p3 + 3 * p2 + p1 + p0 + q0
                                     + 4) >> 3
        else:
            pix[idx - 1 * stride] = (2 * p1 + p0 + q1 + 2) >> 2
        if aq and abs(p0 - q0) < (alpha >> 2) + 2:
            q3 = int(pix[idx + 3 * stride])
            pix[idx + 0 * stride] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1
                                     + 4) >> 3
            pix[idx + 1 * stride] = (q2 + q1 + q0 + p0 + 2) >> 2
            pix[idx + 2 * stride] = (2 * q3 + 3 * q2 + q1 + q0 + p0
                                     + 4) >> 3
        else:
            pix[idx + 0 * stride] = (2 * q1 + q0 + p1 + 2) >> 2
    else:
        tc = tc0 + (1 if ap else 0) + (1 if aq else 0)
        delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
        pix[idx - stride] = np.clip(p0 + delta, 0, 255)
        pix[idx] = np.clip(q0 - delta, 0, 255)
        if ap:
            d = np.clip((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1,
                        -tc0, tc0)
            pix[idx - 2 * stride] = p1 + d
        if aq:
            d = np.clip((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1,
                        -tc0, tc0)
            pix[idx + stride] = q1 + d


def _db_chroma_line(pix, idx, stride, alpha, beta, tc0, bs):
    p1, p0 = int(pix[idx - 2 * stride]), int(pix[idx - stride])
    q0, q1 = int(pix[idx]), int(pix[idx + stride])
    if abs(p0 - q0) >= alpha or abs(p1 - p0) >= beta or abs(q1 - q0) >= beta:
        return
    if bs == 4:
        pix[idx - stride] = (2 * p1 + p0 + q1 + 2) >> 2
        pix[idx] = (2 * q1 + q0 + p1 + 2) >> 2
    else:
        tc = tc0 + 1
        delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
        pix[idx - stride] = np.clip(p0 + delta, 0, 255)
        pix[idx] = np.clip(q0 - delta, 0, 255)


def deblock_frame_scalar(y, u, v, qp_map, intra_map, nnz_l, mvf,
                         a_off=0, b_off=0, chroma_qp_offset=0,
                         b_info=None, ref4=None):
    """Spec 8.7 deblocking, scalar, MB raster order, V then H per MB.
    deblock_frame_ref computes the same, vectorised; tests hold the two
    equal.

    b_info=(use0, use1, mvf0, mvf1) switches edge strengths to the B-slice
    mixed-prediction rules (spec 8.7.2.1): bs=1 when the two sides use
    different reference sets, or any used list's |mv delta| >= 4.

    mvf: [mbh,mbw,2] MB-granular or [mbh*4,mbw*4,2] 4x4-granular (the
    latter needed for 16x8/8x16 partition-internal edges).

    ref4: [mbh*4,mbw*4] L0 refIdx per 4x4 cell (multi-ref P): blocks
    predicting from different reference pictures get bs 1 (8.7.2.1)."""
    mbh, mbw = qp_map.shape
    H, W = y.shape
    if mvf is not None and mvf.shape[0] == mbh:
        mvf = np.repeat(np.repeat(mvf, 4, axis=0), 4, axis=1)
    yf = y.astype(np.int64).ravel()
    uf = u.astype(np.int64).ravel()
    vf = v.astype(np.int64).ravel()

    def bs_of(mbx, mby, e, line, vertical):
        bx = mbx * 4 + (e if vertical else line)
        by = mby * 4 + (line if vertical else e)
        if vertical:
            pbx, pby = bx - 1, by
        else:
            pbx, pby = bx, by - 1
        if intra_map[mby, mbx] or intra_map[pby // 4, pbx // 4]:
            return 4 if e == 0 else 3
        if nnz_l[by, bx] > 0 or nnz_l[pby, pbx] > 0:
            return 2
        if b_info is not None:
            u0f, u1f, mv0f, mv1f = b_info
            px, py = pbx // 4, pby // 4
            if (u0f[mby, mbx] != u0f[py, px]
                    or u1f[mby, mbx] != u1f[py, px]):
                return 1
            if u0f[mby, mbx]:
                d = mv0f[mby, mbx] - mv0f[py, px]
                if abs(int(d[0])) >= 4 or abs(int(d[1])) >= 4:
                    return 1
            if u1f[mby, mbx]:
                d = mv1f[mby, mbx] - mv1f[py, px]
                if abs(int(d[0])) >= 4 or abs(int(d[1])) >= 4:
                    return 1
            return 0
        if ref4 is not None and ref4[by, bx] != ref4[pby, pbx]:
            return 1
        mvq = mvf[by, bx]
        mvp = mvf[pby, pbx]
        if abs(int(mvq[0]) - int(mvp[0])) >= 4 or \
                abs(int(mvq[1]) - int(mvp[1])) >= 4:
            return 1
        return 0

    for mby in range(mbh):
        for mbx in range(mbw):
            qp_q = int(qp_map[mby, mbx])
            # vertical luma edges
            for e in range(4):
                if e == 0 and mbx == 0:
                    continue
                qp_p = int(qp_map[mby, mbx - 1]) if e == 0 else qp_q
                qav = (qp_p + qp_q + 1) >> 1
                ia = np.clip(qav + a_off, 0, 51)
                ib = np.clip(qav + b_off, 0, 51)
                alpha, beta = int(_DB_ALPHA[ia]), int(_DB_BETA[ib])
                x = mbx * 16 + 4 * e
                for line in range(16):
                    bs = bs_of(mbx, mby, e, line // 4, True)
                    if bs == 0:
                        continue
                    tc0 = int(_DB_TC0[ia][min(bs, 3) - 1])
                    yidx = (mby * 16 + line) * W + x
                    _db_luma_line(yf, yidx, 1, alpha, beta, tc0, bs)
            # horizontal luma edges
            for e in range(4):
                if e == 0 and mby == 0:
                    continue
                qp_p = int(qp_map[mby - 1, mbx]) if e == 0 else qp_q
                qav = (qp_p + qp_q + 1) >> 1
                ia = np.clip(qav + a_off, 0, 51)
                ib = np.clip(qav + b_off, 0, 51)
                alpha, beta = int(_DB_ALPHA[ia]), int(_DB_BETA[ib])
                yy = mby * 16 + 4 * e
                for line in range(16):
                    bs = bs_of(mbx, mby, e, line // 4, False)
                    if bs == 0:
                        continue
                    tc0 = int(_DB_TC0[ia][min(bs, 3) - 1])
                    yidx = yy * W + mbx * 16 + line
                    _db_luma_line(yf, yidx, W, alpha, beta, tc0, bs)
            # chroma edges (4:2:0): luma edges 0 and 2
            Wc = W // 2
            for plane in (uf, vf):
                for e in (0, 2):
                    if e == 0 and mbx == 0:
                        continue
                    qp_p = int(qp_map[mby, mbx - 1]) if e == 0 else qp_q
                    cqp_p = int(CHROMA_QP[np.clip(qp_p + chroma_qp_offset,
                                                  0, 51)])
                    cqp_q = int(CHROMA_QP[np.clip(qp_q + chroma_qp_offset,
                                                  0, 51)])
                    cqp = (cqp_p + cqp_q + 1) >> 1
                    ia = np.clip(cqp + a_off, 0, 51)
                    ib = np.clip(cqp + b_off, 0, 51)
                    alpha, beta = int(_DB_ALPHA[ia]), int(_DB_BETA[ib])
                    x = mbx * 8 + 2 * e
                    for line in range(8):
                        bs = bs_of(mbx, mby, e, line // 2, True)
                        if bs == 0:
                            continue
                        tc0 = int(_DB_TC0[ia][min(bs, 3) - 1])
                        cidx = (mby * 8 + line) * Wc + x
                        _db_chroma_line(plane, cidx, 1, alpha, beta, tc0,
                                        bs)
                for e in (0, 2):
                    if e == 0 and mby == 0:
                        continue
                    qp_p = int(qp_map[mby - 1, mbx]) if e == 0 else qp_q
                    cqp_p = int(CHROMA_QP[np.clip(qp_p + chroma_qp_offset,
                                                  0, 51)])
                    cqp_q = int(CHROMA_QP[np.clip(qp_q + chroma_qp_offset,
                                                  0, 51)])
                    cqp = (cqp_p + cqp_q + 1) >> 1
                    ia = np.clip(cqp + a_off, 0, 51)
                    ib = np.clip(cqp + b_off, 0, 51)
                    alpha, beta = int(_DB_ALPHA[ia]), int(_DB_BETA[ib])
                    yy = mby * 8 + 2 * e
                    for line in range(8):
                        bs = bs_of(mbx, mby, e, line // 2, False)
                        if bs == 0:
                            continue
                        tc0 = int(_DB_TC0[ia][min(bs, 3) - 1])
                        cidx = yy * Wc + mbx * 8 + line
                        _db_chroma_line(plane, cidx, Wc, alpha, beta, tc0,
                                        bs)
    return (yf.reshape(H, W), uf.reshape(H // 2, W // 2),
            vf.reshape(H // 2, W // 2))


# ---------------------------------------------- deblocking, vectorised
# The scalar filter above walks MBs in raster order, each MB's vertical
# edges before its horizontal ones. Two MBs touch common samples only if
# they are neighbours (8-connected), and for every such pair raster order
# and the order of t = mbx + 2 * mby agree; MBs with the same t touch no
# common sample. So the MBs of one t are filtered together, edge by edge,
# in the scalar order within each MB: the same arithmetic on the same
# inputs, hence the same output.

def _strengths(intra_map, nnz_l, mvf4, b_info, ref4, vertical):
    """bS of every 4x4 block's left (vertical) or top edge, [mbh*4,
    mbw*4], as bs_of in deblock_frame_scalar; 0 on the picture edge."""
    h4, w4 = nnz_l.shape
    by, bx = np.mgrid[0:h4, 0:w4]
    pby, pbx = (by, bx - 1) if vertical else (by - 1, bx)
    edge = (bx if vertical else by) % 4 == 0
    valid = (pbx >= 0) & (pby >= 0)
    pby, pbx = np.maximum(pby, 0), np.maximum(pbx, 0)
    mby, mbx, pmy, pmx = by // 4, bx // 4, pby // 4, pbx // 4
    bs = np.zeros((h4, w4), np.int64)
    if b_info is not None:
        u0f, u1f, mv0f, mv1f = b_info
        one = ((u0f[mby, mbx] != u0f[pmy, pmx])
               | (u1f[mby, mbx] != u1f[pmy, pmx]))
        d0 = np.abs(mv0f[mby, mbx].astype(np.int64)
                    - mv0f[pmy, pmx].astype(np.int64)) >= 4
        d1 = np.abs(mv1f[mby, mbx].astype(np.int64)
                    - mv1f[pmy, pmx].astype(np.int64)) >= 4
        one |= u0f[mby, mbx] & d0.any(-1)
        one |= u1f[mby, mbx] & d1.any(-1)
    else:
        one = np.zeros((h4, w4), bool)
        if ref4 is not None:
            one |= ref4[by, bx] != ref4[pby, pbx]
        d = np.abs(mvf4[by, bx].astype(np.int64)
                   - mvf4[pby, pbx].astype(np.int64)) >= 4
        one |= d.any(-1)
    bs[one] = 1
    bs[(nnz_l[by, bx] > 0) | (nnz_l[pby, pbx] > 0)] = 2
    intra = intra_map[mby, mbx] | intra_map[pmy, pmx]
    bs[intra] = 3
    bs[intra & edge] = 4
    bs[~valid] = 0
    return bs


def _filter_luma(s, bs, alpha, beta, tc0):
    """s [..., 8] = p3 p2 p1 p0 q0 q1 q2 q3 (int64); bs, alpha, beta, tc0
    broadcast over the leading axes. Returns the filtered samples."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (s[..., k] for k in range(8))
    filt = ((bs > 0) & (np.abs(p0 - q0) < alpha)
            & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta))
    ap = np.abs(p2 - p0) < beta
    aq = np.abs(q2 - q0) < beta
    small = np.abs(p0 - q0) < (alpha >> 2) + 2
    out = s.copy()
    st = filt & (bs == 4)
    sp, sq = st & ap & small, st & aq & small
    out[..., 3] = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                           np.where(st, (2 * p1 + p0 + q1 + 2) >> 2,
                                    out[..., 3]))
    out[..., 2] = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, out[..., 2])
    out[..., 1] = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                           out[..., 1])
    out[..., 4] = np.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                           np.where(st, (2 * q1 + q0 + p1 + 2) >> 2,
                                    out[..., 4]))
    out[..., 5] = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, out[..., 5])
    out[..., 6] = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                           out[..., 6])
    nf = filt & (bs < 4)
    tc = tc0 + ap + aq
    delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    out[..., 3] = np.where(nf, np.clip(p0 + delta, 0, 255), out[..., 3])
    out[..., 4] = np.where(nf, np.clip(q0 - delta, 0, 255), out[..., 4])
    avg = (p0 + q0 + 1) >> 1
    out[..., 2] = np.where(nf & ap, p1 + np.clip((p2 + avg - 2 * p1) >> 1,
                                                 -tc0, tc0), out[..., 2])
    out[..., 5] = np.where(nf & aq, q1 + np.clip((q2 + avg - 2 * q1) >> 1,
                                                 -tc0, tc0), out[..., 5])
    return out


def _filter_chroma(s, bs, alpha, beta, tc0):
    """s [..., 4] = p1 p0 q0 q1 (int64); as _filter_luma."""
    p1, p0, q0, q1 = (s[..., k] for k in range(4))
    filt = ((bs > 0) & (np.abs(p0 - q0) < alpha)
            & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta))
    out = s.copy()
    st = filt & (bs == 4)
    nf = filt & (bs < 4)
    tc = tc0 + 1
    delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    out[..., 1] = np.where(st, (2 * p1 + p0 + q1 + 2) >> 2,
                           np.where(nf, np.clip(p0 + delta, 0, 255), p0))
    out[..., 2] = np.where(st, (2 * q1 + q0 + p1 + 2) >> 2,
                           np.where(nf, np.clip(q0 - delta, 0, 255), q0))
    return out


def _edge_tables(qp_p, qp_q, a_off, b_off):
    """alpha, beta and the tc0 row index of edges between QPs qp_p, qp_q
    (arrays)."""
    qav = (qp_p + qp_q + 1) >> 1
    ia = np.clip(qav + a_off, 0, 51)
    ib = np.clip(qav + b_off, 0, 51)
    return _DB_ALPHA[ia], _DB_BETA[ib], ia


def deblock_frame_ref(y, u, v, qp_map, intra_map, nnz_l, mvf,
                      a_off=0, b_off=0, chroma_qp_offset=0, b_info=None,
                      ref4=None):
    """Spec 8.7 deblocking, as deblock_frame_scalar (same arguments, same
    result), with the MBs of one wave t = mbx + 2 * mby filtered
    together."""
    mbh, mbw = qp_map.shape
    H, W = y.shape
    Wc = W // 2
    if mvf is not None and mvf.shape[0] == mbh:
        mvf = np.repeat(np.repeat(mvf, 4, axis=0), 4, axis=1)
    intra_map = np.asarray(intra_map, bool)
    if b_info is not None:
        b_info = (np.asarray(b_info[0], bool), np.asarray(b_info[1], bool),
                  b_info[2], b_info[3])
    bs_v = _strengths(intra_map, nnz_l, mvf, b_info, ref4, True)
    bs_h = _strengths(intra_map, nnz_l, mvf, b_info, ref4, False)
    qp = qp_map.astype(np.int64)
    cqp = CHROMA_QP[np.clip(qp + chroma_qp_offset, 0, 51)].astype(np.int64)
    yf = y.astype(np.int64).ravel()
    cf = np.stack([u.astype(np.int64).ravel(), v.astype(np.int64).ravel()])
    line16, line8 = np.arange(16), np.arange(8)
    k8, k4 = np.arange(-4, 4), np.arange(-2, 2)
    for t in range(mbw + 2 * mbh - 2):
        mys = np.arange(max(0, (t - mbw + 2) // 2), min(mbh - 1, t // 2) + 1)
        mxs = t - 2 * mys
        if not len(mys):
            continue
        for vertical in (True, False):
            bs_t = bs_v if vertical else bs_h
            # the neighbour across each MB's first edge
            pmy, pmx = (mys, np.maximum(mxs - 1, 0)) if vertical else \
                (np.maximum(mys - 1, 0), mxs)
            for e in range(4):
                if e == 0:
                    qa, qb = qp[pmy, pmx], qp[mys, mxs]
                    ca, cb = cqp[pmy, pmx], cqp[mys, mxs]
                else:
                    qa = qb = qp[mys, mxs]
                    ca = cb = cqp[mys, mxs]
                alpha, beta, ia = _edge_tables(qa, qb, a_off, b_off)
                # luma: [n, 16 lines, 8 samples across the edge]
                lines = (mys if vertical else mxs)[:, None] * 16 + line16
                edge = (mxs if vertical else mys)[:, None] * 16 + 4 * e
                across = edge[:, :, None] + k8
                rows, cols = ((lines[:, :, None], across) if vertical
                              else (across, lines[:, :, None]))
                bs = (bs_t[mys[:, None] * 4 + line16 // 4,
                           mxs[:, None] * 4 + e] if vertical else
                      bs_t[mys[:, None] * 4 + e,
                           mxs[:, None] * 4 + line16 // 4])
                tc0 = _DB_TC0[ia][np.arange(len(ia))[:, None],
                                  np.clip(bs, 1, 3) - 1]
                idx = rows * W + cols
                yf[idx] = _filter_luma(yf[idx], bs, alpha[:, None],
                                       beta[:, None], tc0)
                if e % 2:
                    continue
                # chroma (4:2:0): luma edges 0 and 2, 8 lines of 4 samples
                calpha, cbeta, cia = _edge_tables(ca, cb, a_off, b_off)
                clines = (mys if vertical else mxs)[:, None] * 8 + line8
                cedge = (mxs if vertical else mys)[:, None] * 8 + 2 * e
                cacross = cedge[:, :, None] + k4
                crows, ccols = ((clines[:, :, None], cacross) if vertical
                                else (cacross, clines[:, :, None]))
                cbs = (bs_t[mys[:, None] * 4 + line8 // 2,
                            mxs[:, None] * 4 + e] if vertical else
                       bs_t[mys[:, None] * 4 + e,
                            mxs[:, None] * 4 + line8 // 2])
                ctc0 = _DB_TC0[cia][np.arange(len(cia))[:, None],
                                    np.clip(cbs, 1, 3) - 1]
                cidx = crows * Wc + ccols
                cf[:, cidx] = _filter_chroma(cf[:, cidx], cbs, calpha[:, None],
                                             cbeta[:, None], ctc0)
    return (yf.reshape(H, W), cf[0].reshape(H // 2, Wc),
            cf[1].reshape(H // 2, Wc))


def slice_header_start(nal: bytes, sps: DecSPS) -> dict:
    """The first fields of a slice NAL's header (spec 7.3.3): enough to
    follow frame_num, POC and the reference window without decoding."""
    r = BitReader(unescape(nal[1:]))
    r.ue()                                  # first_mb_in_slice
    slice_type = r.ue() % 5
    r.ue()                                  # pic_parameter_set_id
    fn = r.u(sps.log2_max_frame_num)
    idr = (nal[0] & 0x1F) == 5
    if idr:
        r.ue()                              # idr_pic_id
    poc_lsb = r.u(sps.log2_max_poc_lsb) if sps.poc_type == 0 else 0
    return {"idr": idr, "ref_idc": (nal[0] >> 5) & 3,
            "slice_type": slice_type, "fn": fn, "poc_lsb": poc_lsb}


def poc_step(poc_lsb, prev_lsb, prev_msb, log2_max_poc_lsb):
    """PicOrderCntMsb derivation (spec 8.2.1.1) as decode_slice does it.
    Returns (poc, msb)."""
    max_lsb = 1 << log2_max_poc_lsb
    if poc_lsb < prev_lsb and prev_lsb - poc_lsb >= max_lsb // 2:
        msb = prev_msb + max_lsb
    elif poc_lsb > prev_lsb and poc_lsb - prev_lsb > max_lsb // 2:
        msb = prev_msb - max_lsb
    else:
        msb = prev_msb
    return msb + poc_lsb, msb
