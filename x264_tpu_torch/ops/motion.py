"""Motion search kernels (csrc/motion.cu), the port's form of x264_tpu's
compiled search scans (x264_tpu/encoder/inter.py).

- `lowres_scan_launch`: stage 1 of the seeded search, the half-res scan of
  every offset of [-rl, rl]^2 (`me_lowres_scan_kernel`);
- `refine_launch`: stage 2 of the seeded search, the full-res +-refine
  scan around each MB's seed (`me_fullpel_kernel`);
- `esa_launch`: one pass of the exhaustive search over [-R, R]^2 (the
  same kernel, centred on 0);
- `subpel_launch`: the qpel refine of L <= 9 partition lanes over the
  candidate table (`me_subpel_kernel`, one block per MB over every lane).

Each wrapper checks its tensors (device, dtype, shape, contiguity) before
it touches the library, allocates the outputs with torch.empty, launches
one kernel on the current stream, raises on a non-zero return, and adds
one to its `launches` count. None reads anything back or synchronises.
The encoder reaches them through `encoder/inter.py` (`motion_search`,
`motion_search_seeded`, `subpel_refine_all`, `subpel_refine_mc`), which
send CUDA tensors here and CPU tensors to their sequential plain versions
(`*_ref`). `lowres_scan_plain`, `fullpel_plain` and `subpel_plain` below
are each kernel's specification: what it computes, in its order.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from ._cuda import check_tensor
from .mc import PAD
from .warp import mb_windows_ref

_LIB = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
_i32, _u8 = torch.int32, torch.uint8
_SIGNATURES = {
    "lowres_scan": [_P, _P, _I, _I, _I, _I, _P],
    "refine": [_P, _I, _I, _I, _P, _I, _I, _P, _I, _P, _P, _I, _I,
               _P, _P, _P, _P],
    "esa": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P],
    "subpel": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _I, _P, _I,
               _P, _P, _P],
}
MAX_SUBPEL_LANES = 9


def _library():
    if "lib" not in _LIB:
        lib = _cuda.library()
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, f"x264t_me_{name}")
            fn.restype = ctypes.c_int
            fn.argtypes = args + [_P]
        _LIB["lib"] = lib
    return _LIB["lib"]


def _device(t, name):
    """The CUDA device of `t`; raises for a tensor anywhere else."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        where = t.device if isinstance(t, torch.Tensor) else type(t)
        raise ValueError(f"{name}: the motion kernels take CUDA tensors, got "
                         f"{where}")
    return t.device


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _host_int(v, name):
    if isinstance(v, bool) or not isinstance(v, int):
        raise TypeError(f"{name}: expected a host integer, got {type(v)}")
    return v


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launched(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def lowres_scan_launch(lsrc, lref, rl: int, lam: int):
    """Stage 1 of motion_search_seeded: lsrc [Hl, Wl] int32 (the half-res
    source, Hl and Wl multiples of 8), lref [Hl + 2 rl + 2, Wl + 2 rl + 2]
    int32 (the half-res reference, edge-extended by rl + 1). Returns bm
    [Hl / 8, Wl / 8, 2] int32, each MB's half-res winner (dx, dy)."""
    dev = _device(lsrc, "lsrc")
    rl, lam = _host_int(rl, "rl"), _host_int(lam, "lam")
    hl, wl = lsrc.shape if lsrc.dim() == 2 else (0, 0)
    if hl % 8 or wl % 8 or not hl or not wl:
        raise ValueError(f"lsrc: shape {tuple(lsrc.shape)}, expected whole "
                         f"8x8 blocks")
    check_tensor(lsrc, "lsrc", (hl, wl), _i32, dev)
    check_tensor(lref, "lref", (hl + 2 * rl + 2, wl + 2 * rl + 2), _i32, dev)
    mbh, mbw = hl // 8, wl // 8
    bm = torch.empty((mbh, mbw, 2), dtype=_i32, device=dev)
    _launched(_library().x264t_me_lowres_scan(
        lsrc.data_ptr(), lref.data_ptr(), mbw, mbh, rl, lam, bm.data_ptr(),
        _stream(dev)), "me_lowres_scan")
    lowres_scan_launch.launches += 1
    return bm


def _fullpel_args(padded_ref, y_src, fields, pir_cap, shapes):
    """Check a full-pel search's planes and per-MB fields and allocate its
    outputs. Returns (device, (hp, wp), (mbh, mbw), outputs)."""
    dev = _device(y_src, "y_src")
    h, w = y_src.shape if y_src.dim() == 2 else (0, 0)
    if h % 16 or w % 16 or not h or not w:
        raise ValueError(f"y_src: shape {tuple(y_src.shape)}, expected whole "
                         f"MBs")
    mbh, mbw = h // 16, w // 16
    check_tensor(y_src, "y_src", (h, w), _u8, dev)
    check_tensor(padded_ref, "padded_ref", (h + 2 * PAD, w + 2 * PAD), _u8,
                 dev)
    for name, t in fields.items():
        check_tensor(t, name, (mbh, mbw, 2), _i32, dev)
    if pir_cap is not None:
        check_tensor(pir_cap, "pir_cap", (mbh, mbw), _i32, dev)
    out = {"16x16": torch.empty((mbh, mbw, 2), dtype=_i32, device=dev)}
    if shapes:
        for key, parts in (("16x8", 2), ("8x16", 2), ("8x8", 4)):
            out[key] = torch.empty((mbh, mbw, parts, 2), dtype=_i32,
                                   device=dev)
    return dev, tuple(padded_ref.shape), (mbh, mbw), out


def _fullpel_out(out, shapes):
    ptrs = [_ptr(out.get(k)) for k in ("16x16", "16x8", "8x16", "8x8")]
    return ptrs, (out if shapes else out["16x16"])


def refine_launch(padded_ref, y_src, seed, mvp, lam: int, refine: int,
                  shapes: bool, pir_cap=None):
    """Stage 2 of motion_search_seeded: every offset of [-refine,
    refine]^2 around each MB's seed [mbh, mbw, 2] (full-pel), the MV rate
    against mvp [mbh, mbw, 2] (qpel), pir_cap [mbh, mbw] or None.
    padded_ref [H + 2 PAD, W + 2 PAD] and y_src [H, W] uint8. Returns mv
    [mbh, mbw, 2], or with shapes the dict of the four MV fields
    (motion_search_seeded's layout)."""
    lam = _host_int(lam, "lam")
    refine = _host_int(refine, "refine")
    dev, (hp, wp), (mbh, mbw), out = _fullpel_args(
        padded_ref, y_src, {"seed": seed, "mvp": mvp}, pir_cap, shapes)
    ptrs, res = _fullpel_out(out, shapes)
    _launched(_library().x264t_me_refine(
        padded_ref.data_ptr(), hp, wp, PAD, y_src.data_ptr(), mbw, mbh,
        seed.data_ptr(), refine, mvp.data_ptr(), _ptr(pir_cap), lam,
        9 if shapes else 1, *ptrs, _stream(dev)), "me_refine")
    refine_launch.launches += 1
    return res


def esa_launch(padded_ref, y_src, mvp, lam: int, me_range: int,
               shapes: bool, pir_cap=None):
    """One pass of motion_search: every offset of [-me_range, me_range]^2,
    the MV rate against mvp [mbh, mbw, 2] (None: zero, the first pass),
    pir_cap and the result as refine_launch's."""
    lam = _host_int(lam, "lam")
    me_range = _host_int(me_range, "me_range")
    fields = {} if mvp is None else {"mvp": mvp}
    dev, (hp, wp), (mbh, mbw), out = _fullpel_args(
        padded_ref, y_src, fields, pir_cap, shapes)
    ptrs, res = _fullpel_out(out, shapes)
    _launched(_library().x264t_me_esa(
        padded_ref.data_ptr(), hp, wp, PAD, y_src.data_ptr(), mbw, mbh,
        me_range, _ptr(mvp), _ptr(pir_cap), lam, 9 if shapes else 1, *ptrs,
        _stream(dev)), "me_esa")
    esa_launch.launches += 1
    return res


def subpel_launch(hpel, y_src, lane_mv, masks, tab, lam: int, mvp_q=None):
    """_subpel_refine_scan over L <= 9 lanes, reading the half-pel planes
    directly: hpel [4, H + 2 PAD, W + 2 PAD] uint8; y_src [H, W] uint8;
    lane_mv [L, mbh, mbw, 2] full-pel; masks [L, 16] int32 over the raster
    4x4 blocks; tab [K, 9] int32 (_subpel_cand_table, K <= 49); mvp_q [n,
    2] qpel or None (zero). Returns (best_q [L, n, 2], best_pred [L, n, 16,
    16] int32, best_cost [L, n])."""
    lam = _host_int(lam, "lam")
    dev = _device(y_src, "y_src")
    h, w = y_src.shape if y_src.dim() == 2 else (0, 0)
    if h % 16 or w % 16 or not h or not w:
        raise ValueError(f"y_src: shape {tuple(y_src.shape)}, expected whole "
                         f"MBs")
    mbh, mbw = h // 16, w // 16
    n = mbh * mbw
    lanes = lane_mv.shape[0] if lane_mv.dim() == 4 else 0
    cands = tab.shape[0] if tab.dim() == 2 else 0
    if not 1 <= lanes <= MAX_SUBPEL_LANES or not 1 <= cands <= 49:
        raise ValueError(f"lane_mv {tuple(lane_mv.shape)} / tab "
                         f"{tuple(tab.shape)}: expected [L <= "
                         f"{MAX_SUBPEL_LANES}, mbh, mbw, 2] and [K <= 49, 9]")
    check_tensor(y_src, "y_src", (h, w), _u8, dev)
    check_tensor(hpel, "hpel", (4, h + 2 * PAD, w + 2 * PAD), _u8, dev)
    check_tensor(lane_mv, "lane_mv", (lanes, mbh, mbw, 2), _i32, dev)
    check_tensor(masks, "masks", (lanes, 16), _i32, dev)
    check_tensor(tab, "tab", (cands, 9), _i32, dev)
    if mvp_q is not None:
        check_tensor(mvp_q, "mvp_q", (n, 2), _i32, dev)
    bq = torch.empty((lanes, n, 2), dtype=_i32, device=dev)
    bp = torch.empty((lanes, n, 16, 16), dtype=_i32, device=dev)
    bc = torch.empty((lanes, n), dtype=_i32, device=dev)
    _launched(_library().x264t_me_subpel(
        hpel.data_ptr(), hpel.shape[1], hpel.shape[2], PAD, y_src.data_ptr(),
        mbw, mbh, lanes, lane_mv.data_ptr(), masks.data_ptr(),
        tab.data_ptr(), cands, _ptr(mvp_q), lam, bq.data_ptr(),
        bp.data_ptr(), bc.data_ptr(), _stream(dev)), "me_subpel")
    subpel_launch.launches += 1
    return bq, bp, bc


LAUNCHES = (lowres_scan_launch, refine_launch, esa_launch, subpel_launch)
for _fn in LAUNCHES:
    _fn.launches = 0


# ------------------------------------- the motion kernels' plain versions
# What each kernel computes, in its order: every candidate's cost first,
# then the first minimum over (cost, scan index), kept only where it is
# below the scans' initial cost 1 << 30. The card holds each kernel
# against its plain version, and the tests hold each plain version
# against encoder/inter.py's sequential *_ref (and x264_tpu). They take
# inter.py's cost helpers at call time, since inter.py imports this module.
def _scan_winner(costs):
    """The winner of a scan over the leading axis of costs [K, ...] that
    starts from cost 1 << 30 and takes a candidate only when its cost is
    strictly lower. Returns (cost, first index of the least cost, whether
    a candidate won)."""
    from ..encoder.inter import _first_min_along
    best, first = _first_min_along(costs)
    won = best < (1 << 30)
    return torch.where(won, best, 1 << 30), first, won


def lowres_scan_plain(lsrc, lref, rl: int, lam: int):
    """The me_lowres_scan kernel's function (stage 1 of
    motion_search_seeded): lsrc [Hl, Wl], lref edge-extended by rl + 1;
    returns bm [Hl / 8, Wl / 8, 2]."""
    from ..encoder.inter import _mv_bits, _mv_cost_bits, _offsets
    hl, wl = lsrc.shape
    mbh, mbw = hl // 8, wl // 8
    dev = lsrc.device
    K = 2 * rl + 1
    bits = _mv_cost_bits(8 * torch.arange(-rl, rl + 1, dtype=_i32,
                                          device=dev))
    costs = []
    for dy in range(-rl, rl + 1):
        # [Hl, K, Wl]: column k is the reference shifted by dx = k - rl
        sl = lref[rl + 1 + dy:rl + 1 + dy + hl, 1:1 + wl + 2 * rl] \
            .unfold(1, wl, 1)
        sad = (sl - lsrc[:, None, :]).abs().reshape(mbh, 8, K, mbw, 8) \
            .sum((1, 4), dtype=_i32).permute(1, 0, 2)
        costs.append(4 * sad + lam * (bits[:, None, None] + _mv_bits(8 * dy)))
    _, first, won = _scan_winner(torch.cat(costs))
    offs = [(dx, dy) for dy in range(-rl, rl + 1)
            for dx in range(-rl, rl + 1)]
    return torch.where(won[..., None], _offsets(offs, dev)[first], 0)


def fullpel_plain(padded_ref, y_src, center, mvp, lam: int, radius: int,
                  shapes: bool, pir_cap=None):
    """The me_fullpel_kernel's function (me_refine: `center` the seeds,
    `radius` the refine; me_esa: `center` None, `radius` me_range): every
    offset of [-radius, radius]^2 around `center` [mbh, mbw, 2] (None:
    0), the MV rate against mvp [mbh, mbw, 2] (None: 0), pir_cap as in
    motion_search_ref. Returns motion_search_ref's result."""
    from ..encoder.inter import _mb_tiles, _mv_cost_bits, _offsets
    H, W = y_src.shape
    mbh, mbw = H // 16, W // 16
    dev = y_src.device
    K = 2 * radius + 1
    zero = torch.zeros((mbh, mbw, 2), dtype=_i32, device=dev)
    center = zero if center is None else center
    mvp = zero if mvp is None else mvp
    win = mb_windows_ref(padded_ref[None], center - radius, bs=16,
                         win=16 + 2 * radius, pad=PAD)[:, :, 0].to(_i32)
    tiles = _mb_tiles(y_src, 16).to(_i32)[:, :, None]
    quads = []
    for oy in range(K):
        # [mbh, mbw, K, 16, 16]: window rows oy.., columns ox.. per ox
        sl = win[:, :, oy:oy + 16].unfold(3, 16, 1).transpose(2, 3)
        quads.append((sl - tiles).abs().reshape(mbh, mbw, K, 2, 8, 2, 8)
                     .sum((4, 6), dtype=_i32).reshape(mbh, mbw, K, 4))
    # [K * K, mbh, mbw, 4], dy outer and dx inner
    q = torch.stack(quads, 2).reshape(mbh, mbw, K * K, 4).permute(2, 0, 1, 3)
    offs = [(dx, dy) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]
    off_t = _offsets(offs, dev)
    mv = center + off_t[:, None, None, :]             # [K * K, mbh, mbw, 2]
    mvcost = lam * (_mv_cost_bits(mv[..., 0] * 4 - mvp[..., 0])
                    + _mv_cost_bits(mv[..., 1] * 4 - mvp[..., 1]))
    if pir_cap is not None:
        mvcost = mvcost + torch.where(mv[..., 0] > pir_cap, 1 << 28, 0)
    mvcost = mvcost[..., None]
    lanes = {"16x16": q.sum(-1, dtype=_i32)[..., None],
             "16x8": torch.stack([q[..., 0] + q[..., 1],
                                  q[..., 2] + q[..., 3]], -1),
             "8x16": torch.stack([q[..., 0] + q[..., 2],
                                  q[..., 1] + q[..., 3]], -1),
             "8x8": q}
    out = {}
    for key in (lanes if shapes else ("16x16",)):
        _, first, won = _scan_winner(lanes[key] + mvcost)
        out[key] = torch.where(won[..., None],
                               center[:, :, None, :] + off_t[first], 0)
    if not shapes:
        return out["16x16"][:, :, 0]
    out["16x16"] = out["16x16"][:, :, 0]
    return out


def subpel_plain(hpel, y_src, lane_mv, masks, tab, lam: int, mvp_q=None):
    """The me_subpel kernel's function: _subpel_refine_scan over the lanes
    of lane_mv [L, mbh, mbw, 2], masks [L, 16], the candidate table tab
    [K, 9] (_subpel_cand_table) and mvp_q [n, 2] (None: 0). Returns
    (best_q [L, n, 2], best_pred [L, n, 16, 16], best_cost [L, n])."""
    from ..encoder.inter import (SUBPEL_MARG, _mb_tiles, _mv_cost_bits,
                                 _offsets, _satd16_map, _subpel_windows)
    H, W = y_src.shape
    n, L = (H // 16) * (W // 16), lane_mv.shape[0]
    M = SUBPEL_MARG
    win = _subpel_windows(hpel, lane_mv, 0).to(_i32)  # [L, n, 4, 24, 24]
    src = _mb_tiles(y_src, 16).reshape(n, 16, 16).to(_i32)
    mv_q = lane_mv.reshape(L, n, 2) * 4
    mvp = (torch.zeros((n, 2), dtype=_i32, device=y_src.device)
           if mvp_q is None else mvp_q)
    rows = tab.tolist()

    def pred(row):
        _, _, p0, p1, oy0, ix, iy, ox1, avg = row
        p = win[:, :, p0, M + oy0:M + oy0 + 16, M + ix:M + ix + 16]
        if avg:
            p = (p + win[:, :, p1, M + iy:M + iy + 16,
                         M + ox1:M + ox1 + 16] + 1) >> 1
        return p

    costs = [(_satd16_map(pred(row), src) * masks[:, None, :]).sum(
        -1, dtype=_i32) + lam * (_mv_cost_bits(mv_q[..., 0] + row[0]
                                               - mvp[:, 0])
                                 + _mv_cost_bits(mv_q[..., 1] + row[1]
                                                 - mvp[:, 1]))
             for row in rows]
    bc, first, won = _scan_winner(torch.stack(costs))
    bq, bp = mv_q, win[:, :, 0, M:M + 16, M:M + 16]
    for k, row in enumerate(rows):
        hit = won & (first == k)
        off = _offsets(row[:2], y_src.device)
        bq = torch.where(hit[..., None], mv_q + off, bq)
        bp = torch.where(hit[..., None, None], pred(row), bp)
    return bq, bp, bc
