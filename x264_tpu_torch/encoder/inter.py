"""P-frame encoding (x264_tpu/encoder/inter.py), CAVLC and CABAC, at every
preset's settings: the seeded full-pel search (dia / hex / umh) or the
exhaustive one (esa / tesa: `motion_search`, which B frames always run),
the 16x8 / 8x16 partitions (and 8x8 under CAVLC: x264_tpu's CABAC writer
has no sub_mb_type, so its CABAC frames run without P8x8) or the 16x16
lane alone (no ANALYSE_PSUB16x16: ultrafast, superfast), two references,
weighted prediction, intra-in-P with I_4x4, the subme-7 RD tier (subme 7
and up), trellis quantization of inter luma (CABAC only), noise
reduction, periodic intra refresh, dct decimation and the deblock.

`encode_pframe` is the whole per-frame pipeline on the frame's device:
  1. full-pel ME per reference (`p_fullpel_core` -> motion_search_seeded,
     or motion_search with me_method esa / tesa);
  2. quarter-pel refinement of every partition lane, then the per-MB
     reference choice (`p_subpel_core`, `p_me_select`);
  3. the intra candidate (`p_intra_core`) and the RD re-rank (`p_rd_core`);
  4. transform, noise reduction, decimation and chroma MC (`p_xfrm_core`);
  5. the mixed wavefront commit and cbp / skip (`p_merge_core` ->
     ops/commit.commit: the CUDA kernel's mixed variant, with or without
     I_4x4, on a card, commit_ref on the CPU);
  6. CAVLC on the device (entropy/cavlc_dev.encode_pframe_entropy_dev),
     or for CABAC the decoder-carried QP and the decision tensors
     (`p_decisions_core`) that the host C++ writer codes in finalize
     (`cabac_finalize_pframe`);
  7. the deblock (`p_deblock_core`).

x264_tpu's search scans (lax.scan over offsets and candidates) are
hand-written kernels on a card (csrc/motion.cu through ops/motion.py:
`motion_search`, `motion_search_seeded`, `subpel_refine_all` and
`subpel_refine_mc` send CUDA tensors there) and Python loops over the same
static tables on the CPU (`*_ref`), in the same order: a step replaces the
best only when its cost is strictly lower, so ties resolve as in JAX. The
kernels reduce over all candidates at once, by the first minimum of (cost,
scan index); ops/motion.py's `*_plain` functions compute what each kernel
computes in that order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import const
from ..entropy import nal as nal_mod
from ..entropy.cabac_host import encode_slice_cabac
from ..entropy.cavlc_dev import (LUMA4x4_RASTER, _nc_grid_dev,
                                 encode_pframe_entropy_dev,
                                 residual_blocks_dev)
from ..ops import dct, mc, motion, predict, quant
from ..ops._cuda import to_device, to_host
from ..ops.commit import (_chroma_blocks, _chroma_merge, _encode_luma_i16,
                          _luma_blocks, _luma_merge, commit)
from ..ops.deblock import _rep4, compute_strengths, deblock_frame
from ..ops.tables import ZIGZAG4_FRAME
from ..ops.trellis import frame_ctx_costs, trellis_4x4
from ..ops.warp import mb_windows_ref
from ..params import ANALYSE_I4x4, ANALYSE_PSUB16x16
from ..utils import trace
from .frame_encode import build_qp_maps
from .intra import (_host, _mb_tiles, cap_bytes_per_mb, decide_modes_full,
                    decide_modes_i4, finalize_slice, finalize_slice_cabac,
                    mb_lambda)

_i32 = torch.int32


# ------------------------------------------------------------ cost helpers
def _mv_bits(v: int) -> int:
    """_mv_cost_bits of one host integer."""
    v = abs(v)
    return 2 * sum((2 * v + 1) >= (1 << k) for k in range(1, 16)) - 1


def _mv_cost_bits(mvd):
    """Approximate rate of an MV component (se golomb length)."""
    v = mvd.abs()
    nbits = torch.zeros_like(v)
    for k in range(1, 16):
        nbits = nbits + ((2 * v + 1) >= (1 << k)).to(v.dtype)
    return 2 * nbits - 1


_DECIMATE_TAB = np.array([3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                         np.int32)


def _decimate_score(lv_z):
    """x264 decimate score per block (decimate_score16, quant.c): +tab[run]
    per |level| == 1 coefficient, 99 if any |level| > 1. lv_z [n, B, L]."""
    n, blocks, L = lv_z.shape
    dev = lv_z.device
    nz = lv_z != 0
    big = (lv_z.abs() > 1).any(2)
    pos = torch.arange(L, dtype=_i32, device=dev)
    last_prev = torch.cummax(torch.where(nz, pos, -1), 2).values
    prev = torch.cat([torch.full((n, blocks, 1), -1, dtype=_i32, device=dev),
                      last_prev[:, :, :-1]], dim=2)
    run = torch.where(nz, pos - prev - 1, 0)
    tab = const(_DECIMATE_TAB, dev)
    sc = torch.where(nz, tab[run.clamp(0, 15).long()], 0).sum(2, dtype=_i32)
    return torch.where(big, 99, sc).to(_i32)


def _satd16_map(pred, src):
    """Per-4x4-block SATD of [..., 16, 16] tiles -> [..., 16] (raster block
    order, each block's sum halved), so partition lanes can sum subsets."""
    d = pred.to(_i32) - src.to(_i32)
    lead = d.shape[:-2]
    dd = d.reshape(lead + (4, 4, 4, 4)).transpose(-3, -2)
    s = dct.hadamard4x4(dd).abs().sum((-2, -1), dtype=_i32)
    return s.reshape(lead + (16,)) >> 1


def _satd16(pred, src):
    """SATD of [N, 16, 16] blocks -> [N]: the sum over all 16 4x4 blocks,
    halved once (x264_tpu inter._satd16)."""
    d = pred.to(_i32) - src.to(_i32)
    dd = d.reshape(-1, 4, 4, 4, 4).transpose(2, 3)
    return dct.hadamard4x4(dd).abs().sum((1, 2, 3, 4), dtype=_i32) >> 1


def _offsets(pairs, device):
    """[K, 2] int32 tensor of (dx, dy) pairs on `device`."""
    return const(np.asarray(pairs, np.int32).reshape(-1, 2), device)


# ------------------------------------------------------------ full-pel ME
def _lowres(p):
    p = p.to(_i32)
    return (p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2]
            + 2) >> 2


def _keep_best(best, key, cost, mv):
    bc, bm = best[key]
    better = cost < bc
    best[key] = (torch.where(better, cost, bc),
                 torch.where(better[..., None], mv, bm))


def _first_min_along(cost, dim=0):
    """(minimum, index of its first occurrence) along `dim`."""
    best = cost.amin(dim)
    n = cost.shape[dim]
    shape = [1] * cost.dim()
    shape[dim] = n
    pos = torch.arange(n, dtype=_i32, device=cost.device).reshape(shape)
    first = torch.where(cost == best.unsqueeze(dim), pos, n).amin(dim)
    return best, first


@trace.spanned("analysis:esa")
def motion_search(padded_ref, hpel, y_src, lam, me_range: int,
                  shapes: bool = False, pir_cap=None):
    """Exhaustive full-pel search (x264_tpu inter.motion_search, the ESA),
    with motion_search_ref's arguments and result: CUDA tensors go to the
    me_esa kernel (ops/motion.py esa_launch), one launch per pass with the
    MVP estimate between them; CPU tensors to motion_search_ref. `lam` is
    a host integer."""
    if not y_src.is_cuda:
        return motion_search_ref(padded_ref, hpel, y_src, lam, me_range,
                                 shapes=shapes, pir_cap=pir_cap)
    padded_ref, y_src = padded_ref.contiguous(), y_src.contiguous()
    mv1 = motion.esa_launch(padded_ref, y_src, None, lam, me_range, False,
                            pir_cap)
    mvp_est, _ = mv_predictors(mv1 * 4)
    return motion.esa_launch(padded_ref, y_src, mvp_est.contiguous(), lam,
                             me_range, shapes, pir_cap)


def motion_search_ref(padded_ref, hpel, y_src, lam, me_range: int,
                      shapes: bool = False, pir_cap=None):
    """Exhaustive full-pel search (x264_tpu inter.motion_search, the ESA):
    every offset of [-R, R]^2 as a shifted-plane SAD map, in two passes.
    The first costs the MV rate against zero; the median predictor of its
    winners gives a per-MB MVP estimate, and the second pass re-scores
    every offset against it.

    x264_tpu scans the offsets one by one, dy outer and dx inner, and keeps
    a candidate only when its cost is strictly lower. Here one step takes a
    whole row of dx: the row's first minimum, then the same strict
    comparison against the best so far, which picks the same winner.
    `hpel` is unused, as in x264_tpu. pir_cap [mbh, mbw] (periodic intra
    refresh): an offset with dx above the MB's cap costs 1 << 28 more.

    Returns mv [mbh, mbw, 2] full-pel, or with shapes=True a dict
    {"16x16": [mbh,mbw,2], "16x8" / "8x16": [mbh,mbw,2,2], "8x8":
    [mbh,mbw,4,2]} (partition axis before the xy axis)."""
    H, W = y_src.shape
    mbh, mbw = H // 16, W // 16
    dev = y_src.device
    R = me_range
    K = 2 * R + 1
    src16 = y_src.to(torch.int16)[:, None, :]
    offs = torch.arange(-R, R + 1, dtype=_i32, device=dev)
    i16 = torch.int16

    def esa_scan(mvp, want_shapes):
        # the rate of every dx / dy against the MB's predictor: [K, mbh, mbw]
        bits_x = _mv_cost_bits(offs[:, None, None] * 4 - mvp[..., 0])
        bits_y = _mv_cost_bits(offs[:, None, None] * 4 - mvp[..., 1])
        best = {"16x16": (torch.full((mbh, mbw), 1 << 30, dtype=_i32,
                                     device=dev),
                          torch.zeros((mbh, mbw, 2), dtype=_i32, device=dev))}
        if want_shapes:
            for key, np_ in (("16x8", 2), ("8x16", 2), ("8x8", 4)):
                best[key] = (torch.full((mbh, mbw, np_), 1 << 30, dtype=_i32,
                                        device=dev),
                             torch.zeros((mbh, mbw, np_, 2), dtype=_i32,
                                         device=dev))
        for j in range(K):
            dy = j - R
            slab = padded_ref[mc.PAD + dy:mc.PAD + dy + H,
                              mc.PAD - R:mc.PAD + R + W]
            # [H, K, W]: column k is the plane shifted by dx = k - R
            ad = (slab.unfold(1, W, 1).to(i16) - src16).abs()
            # absdiff <= 255 and the 8-wide partial sums <= 2040 fit int16
            quad = ad.reshape(mbh, 2, 8, K, mbw, 2, 8).sum(6, dtype=i16) \
                .sum(2, dtype=_i32).permute(2, 0, 3, 1, 4)
            mvcost = lam * (bits_x + bits_y[j])          # [K, mbh, mbw]
            if pir_cap is not None:
                mvcost = mvcost + torch.where(
                    offs[:, None, None] > pir_cap, 1 << 28, 0)
            cand = {"16x16": quad.sum((3, 4), dtype=_i32) + mvcost}
            if want_shapes:
                m4 = mvcost[..., None]
                cand["16x8"] = quad.sum(4, dtype=_i32) + m4
                cand["8x16"] = quad.sum(3, dtype=_i32) + m4
                # the quadrants in z order (TL, TR, BL, BR)
                cand["8x8"] = quad.reshape(K, mbh, mbw, 4) + m4
            for key, cost in cand.items():
                row_best, k = _first_min_along(cost)
                bc, bm = best[key]
                better = row_best < bc
                mv = torch.stack([k - R, torch.full_like(k, dy)], dim=-1)
                best[key] = (torch.where(better, row_best, bc),
                             torch.where(better[..., None], mv, bm))
        return best

    zero_mvp = torch.zeros((mbh, mbw, 2), dtype=_i32, device=dev)
    mv1 = esa_scan(zero_mvp, False)["16x16"][1]
    mvp_est, _ = mv_predictors(mv1 * 4)
    best = esa_scan(mvp_est, shapes)
    if not shapes:
        return best["16x16"][1]
    return {key: best[key][1] for key in ("16x16", "16x8", "8x16", "8x8")}


def motion_search_seeded(padded_ref, y_src, lam, me_range: int,
                         shapes: bool = False, pir_cap=None, refine: int = 4):
    """Hierarchical full-pel search (x264_tpu
    inter.motion_search_seeded), with motion_search_seeded_ref's arguments
    and result: CUDA tensors go to the me_lowres_scan kernel (stage 1) and
    the me_refine kernel (stage 2; ops/motion.py), with the seed and its
    MVP estimate between them; CPU tensors to motion_search_seeded_ref.
    `lam` is a host integer."""
    if not y_src.is_cuda:
        return motion_search_seeded_ref(padded_ref, y_src, lam, me_range,
                                        shapes=shapes, pir_cap=pir_cap,
                                        refine=refine)
    H, W = y_src.shape
    R, M = me_range, refine
    padded_ref, y_src = padded_ref.contiguous(), y_src.contiguous()
    Rl = (R + 1) // 2
    lref = mc._clamped(
        _lowres(padded_ref[mc.PAD:mc.PAD + H, mc.PAD:mc.PAD + W]),
        Rl + 1, Rl + 1, Rl + 1, Rl + 1)
    bm = motion.lowres_scan_launch(_lowres(y_src), lref, Rl, lam)
    seed = (2 * bm).clamp(-(R - M), R - M)
    mvp_est, _ = mv_predictors(seed * 4)
    return motion.refine_launch(padded_ref, y_src, seed, mvp_est.contiguous(),
                                lam, M, shapes, pir_cap)


def motion_search_seeded_ref(padded_ref, y_src, lam, me_range: int,
                             shapes: bool = False, pir_cap=None,
                             refine: int = 4):
    """Hierarchical full-pel search: an exhaustive half-res scan seeds a
    +-refine full-res refine per MB (x264_tpu inter.motion_search_seeded);
    pir_cap as in motion_search, on the refine only.
    Returns mv [mbh, mbw, 2] full-pel, or with shapes=True a dict
    {"16x16": [mbh,mbw,2], "16x8"/"8x16": [mbh,mbw,2,2], "8x8":
    [mbh,mbw,4,2]}."""
    H, W = y_src.shape
    mbh, mbw = H // 16, W // 16
    dev = y_src.device
    R, M = me_range, refine

    # ---- stage 1: half-res exhaustive scan, one 8x8 block per MB ----
    lsrc = _lowres(y_src)
    lref_in = _lowres(padded_ref[mc.PAD:mc.PAD + H, mc.PAD:mc.PAD + W])
    Rl = (R + 1) // 2
    lref = mc._clamped(lref_in, Rl + 1, Rl + 1, Rl + 1, Rl + 1)
    Hl, Wl = H // 2, W // 2
    loffs = [(dx, dy) for dy in range(-Rl, Rl + 1)
             for dx in range(-Rl, Rl + 1)]
    loff_t = _offsets(loffs, dev)
    bc = torch.full((mbh, mbw), 1 << 30, dtype=_i32, device=dev)
    bm = torch.zeros((mbh, mbw, 2), dtype=_i32, device=dev)
    for k, (dx, dy) in enumerate(loffs):
        sh = lref[Rl + 1 + dy:Rl + 1 + dy + Hl, Rl + 1 + dx:Rl + 1 + dx + Wl]
        sad = (sh - lsrc).abs().reshape(mbh, 8, mbw, 8).sum((1, 3),
                                                            dtype=_i32)
        cost = 4 * sad + lam * (_mv_bits(dx * 8) + _mv_bits(dy * 8))
        better = cost < bc
        bc = torch.where(better, cost, bc)
        bm = torch.where(better[..., None], loff_t[k], bm)

    # ---- stage 2: full-res +-M refine around the 2x-upscaled seed ----
    seed = (2 * bm).clamp(-(R - M), R - M)
    win = mb_windows_ref(padded_ref[None], seed - M, bs=16, win=16 + 2 * M,
                         pad=mc.PAD)[:, :, 0].to(_i32)
    tiles = _mb_tiles(y_src, 16).to(_i32)
    roffs = [(dx, dy) for dy in range(-M, M + 1) for dx in range(-M, M + 1)]
    roff_t = _offsets(roffs, dev)
    mvp_est, _ = mv_predictors(seed * 4)
    best = {"16x16": (torch.full((mbh, mbw), 1 << 30, dtype=_i32,
                                 device=dev),
                      torch.zeros((mbh, mbw, 2), dtype=_i32, device=dev))}
    if shapes:
        for key, np_ in (("16x8", 2), ("8x16", 2), ("8x8", 4)):
            best[key] = (torch.full((mbh, mbw, np_), 1 << 30, dtype=_i32,
                                    device=dev),
                         torch.zeros((mbh, mbw, np_, 2), dtype=_i32,
                                     device=dev))
    for k, (dx, dy) in enumerate(roffs):
        cand_mv = seed + roff_t[k]
        sl = win[:, :, M + dy:M + dy + 16, M + dx:M + dx + 16]
        quad = (sl - tiles).abs().reshape(mbh, mbw, 2, 8, 2, 8) \
            .sum((3, 5), dtype=_i32)                     # [mbh,mbw,2,2]
        mvcost = lam * (_mv_cost_bits(cand_mv[..., 0] * 4 - mvp_est[..., 0])
                        + _mv_cost_bits(cand_mv[..., 1] * 4
                                        - mvp_est[..., 1]))
        if pir_cap is not None:
            mvcost = mvcost + torch.where(cand_mv[..., 0] > pir_cap,
                                          1 << 28, 0)
        _keep_best(best, "16x16", quad.sum((2, 3), dtype=_i32) + mvcost,
                   cand_mv)
        if shapes:
            m3, mv3 = mvcost[..., None], cand_mv[:, :, None, :]
            _keep_best(best, "16x8", quad.sum(3, dtype=_i32) + m3, mv3)
            _keep_best(best, "8x16", quad.sum(2, dtype=_i32) + m3, mv3)
            _keep_best(best, "8x8", quad.reshape(mbh, mbw, 4) + m3, mv3)
    if not shapes:
        return best["16x16"][1]
    return {key: best[key][1] for key in ("16x16", "16x8", "8x16", "8x8")}


# --------------------------------------------------------- MV prediction
def _shift(f, dx, dy):
    """out[y, x] = f[y - dy, x - dx] over the leading [mbh, mbw] axes,
    zero (False) outside the frame."""
    if dy:
        f = torch.cat([torch.zeros_like(f[:dy]), f[:-dy]], dim=0)
    if dx > 0:
        f = torch.cat([torch.zeros_like(f[:, :dx]), f[:, :-dx]], dim=1)
    elif dx < 0:
        f = torch.cat([f[:, -dx:], torch.zeros_like(f[:, :(-dx)])], dim=1)
    return f


def _median3(a, b, c):
    return torch.minimum(torch.maximum(a, torch.minimum(b, c)),
                         torch.maximum(b, c))


def mv_predictors(mv_field, inter_mask=None, ref_grid=None, cur_ref=None):
    """Median MV predictor and P-Skip predictor per MB (spec 8.4.1.1 /
    8.4.1.3; x264_tpu inter.mv_predictors). mv_field [mbh, mbw, 2];
    inter_mask [mbh, mbw] bool (False: intra, refIdx -1); ref_grid /
    cur_ref [mbh, mbw] refIdx of the neighbours / of the MB (two refs).
    Returns (mvp [mbh, mbw, 2], pskip_mv [mbh, mbw, 2])."""
    mbh, mbw = mv_field.shape[:2]
    dev = mv_field.device
    if inter_mask is None:
        inter_mask = torch.ones((mbh, mbw), dtype=torch.bool, device=dev)
    mv_m = torch.where(inter_mask[..., None], mv_field, 0)
    mv_a, mv_b = _shift(mv_m, 1, 0), _shift(mv_m, 0, 1)
    mv_c, mv_d = _shift(mv_m, -1, 1), _shift(mv_m, 1, 1)
    use_a0, use_b0 = _shift(inter_mask, 1, 0), _shift(inter_mask, 0, 1)
    use_c0, use_d0 = _shift(inter_mask, -1, 1), _shift(inter_mask, 1, 1)
    col = torch.arange(mbw, device=dev)[None, :]
    row = torch.arange(mbh, device=dev)[:, None]
    avail_a = (col > 0).expand(mbh, mbw)
    avail_b = (row > 0).expand(mbh, mbw)
    avail_c = (row > 0) & (col < mbw - 1)
    avail_d = (row > 0) & (col > 0)
    # C unavailable -> D (spec 8.4.1.3.2)
    mv_c = torch.where(avail_c[..., None], mv_c,
                       torch.where(avail_d[..., None], mv_d, 0))
    use_c0 = torch.where(avail_c, use_c0, avail_d & use_d0)
    avail_c2 = avail_c | avail_d
    use_a, use_b, use_c = avail_a & use_a0, avail_b & use_b0, \
        avail_c2 & use_c0
    a = torch.where(use_a[..., None], mv_a, 0)
    b = torch.where(use_b[..., None], mv_b, 0)
    c = torch.where(use_c[..., None], mv_c, 0)
    med = _median3(a, b, c)
    if ref_grid is None:
        m_a, m_b, m_c = use_a, use_b, use_c
        m_a0, m_b0, m_c0 = use_a, use_b, use_c
    else:
        rg = torch.where(inter_mask, ref_grid, -1)
        ref_a, ref_b = _shift(rg, 1, 0), _shift(rg, 0, 1)
        ref_c = torch.where(avail_c, _shift(rg, -1, 1), _shift(rg, 1, 1))
        m_a, m_b, m_c = (use_a & (ref_a == cur_ref),
                         use_b & (ref_b == cur_ref),
                         use_c & (ref_c == cur_ref))
        m_a0, m_b0, m_c0 = use_a & (ref_a == 0), use_b & (ref_b == 0), \
            use_c & (ref_c == 0)

    def mvp_for(ma, mb_, mc_):
        n_match = ma.to(_i32) + mb_.to(_i32) + mc_.to(_i32)
        only = torch.where(ma[..., None], a,
                           torch.where(mb_[..., None], b, c))
        out = torch.where((n_match == 1)[..., None], only, med)
        return torch.where(((~avail_b) & (~avail_c2) & avail_a)[..., None],
                           a, out)

    mvp = mvp_for(m_a, m_b, m_c)
    mvp0 = mvp if ref_grid is None else mvp_for(m_a0, m_b0, m_c0)
    azero = m_a0[..., None] & (mv_a == 0).all(-1, keepdim=True)
    bzero = m_b0[..., None] & (mv_b == 0).all(-1, keepdim=True)
    pskip = torch.where(((~avail_a) | (~avail_b))[..., None], 0,
                        torch.where(azero | bzero, 0, mvp0))
    return mvp, pskip


def mv_predictors_part(mv4, inter4, part_mode, ref4=None, cur_ref=None):
    """Partition-aware MV predictors at 4x4 granularity (spec 8.4.1.3 with
    the 16x8 / 8x16 directional rules; x264_tpu inter.mv_predictors_part).
    mv4 [mbh*4, mbw*4, 2]; inter4 the inter mask on the same grid;
    part_mode [mbh, mbw] 0=16x16 1=16x8 2=8x16 3=8x8; ref4 / cur_ref the
    neighbours' and the MB's refIdx (two refs).
    Returns (mvp [mbh, mbw, 4, 2] per partition slot, pskip [mbh, mbw, 2])."""
    H4, W4 = inter4.shape
    mbh, mbw = H4 // 4, W4 // 4
    dev = mv4.device
    mv_p = torch.zeros((H4 + 1, W4 + 2, 2), dtype=mv4.dtype, device=dev)
    mv_p[1:, 1:-1] = mv4
    use_p = torch.zeros((H4 + 1, W4 + 2), dtype=torch.bool, device=dev)
    use_p[1:, 1:-1] = inter4
    if ref4 is not None:
        ref_p = torch.full((H4 + 1, W4 + 2), -1, dtype=_i32, device=dev)
        ref_p[1:, 1:-1] = torch.where(inter4, ref4, -1)
    col = torch.arange(mbw, device=dev)[None, :]
    row = torch.arange(mbh, device=dev)[:, None]

    def pick(dy, dx):
        """(mv, use, avail, match, match0) of the 4x4 block at the MB origin
        + (dy, dx): avail = in frame and decoded before the partition."""
        def at(t):
            return t[1 + dy::4][:mbh][:, 1 + dx::4][:, :mbw]
        mv, use = at(mv_p), at(use_p)
        in_frame = torch.ones((mbh, mbw), dtype=torch.bool, device=dev)
        if dy < 0:
            in_frame = in_frame & (row > 0)
        if dx < 0:
            in_frame = in_frame & (col > 0)
        if dx >= 4:
            in_frame = in_frame & (col < mbw - 1)
        decoded = (dy < 0) or (dx < 0) or (0 <= dx < 4 and 0 <= dy < 4)
        avail = in_frame if decoded else torch.zeros_like(in_frame)
        use = avail & use
        if ref4 is None:
            match = match0 = use
        else:
            nref = at(ref_p)
            match = use & (nref == cur_ref)
            match0 = use & (nref == 0)
        return (torch.where(avail[..., None], mv, 0), use, avail, match,
                match0)

    def median_mvp(a, b, c, r0=False):
        (mva, ua, aa, xa, za), (mvb, ub, ab, xb, zb), \
            (mvc, uc, ac, xc, zc) = a, b, c
        if r0:
            xa, xb, xc = za, zb, zc
        ca = torch.where(ua[..., None], mva, 0)
        cb = torch.where(ub[..., None], mvb, 0)
        cc = torch.where(uc[..., None], mvc, 0)
        med = _median3(ca, cb, cc)
        nm = xa.to(_i32) + xb.to(_i32) + xc.to(_i32)
        only = torch.where(xa[..., None], ca,
                           torch.where(xb[..., None], cb, cc))
        mvp = torch.where((nm == 1)[..., None], only, med)
        return torch.where(((~ab) & (~ac) & aa)[..., None], ca, mvp)

    def sub_c(c, d):
        """C unavailable -> D (8.4.1.3.2)."""
        (mvc, uc, ac, xc, zc), (mvd, ud, ad, xd, zd) = c, d
        return (torch.where(ac[..., None], mvc, mvd), torch.where(ac, uc, ud),
                ac | ad, torch.where(ac, xc, xd), torch.where(ac, zc, zd))

    A0, B0 = pick(0, -1), pick(-1, 0)
    C0 = sub_c(pick(-1, 4), pick(-1, -1))
    mvp16 = median_mvp(A0, B0, C0)
    # 16x8: top by the B rule, bottom by the A rule
    t_mvp = torch.where(B0[3][..., None], B0[0], mvp16)
    A1 = pick(2, -1)
    bot_med = median_mvp(A1, pick(1, 0), sub_c(pick(1, 4), pick(1, -1)))
    b_mvp = torch.where(A1[3][..., None], A1[0], bot_med)
    # 8x16: left by the A rule, right by the C rule
    l_med = median_mvp(A0, B0, sub_c(pick(-1, 2), pick(-1, -1)))
    l_mvp = torch.where(A0[3][..., None], A0[0], l_med)
    C2 = sub_c(pick(-1, 4), pick(-1, 1))
    r_med = median_mvp(pick(0, 1), pick(-1, 2), C2)
    r_mvp = torch.where(C2[3][..., None], C2[0], r_med)
    # 8x8 quadrants: plain medians
    q0_mvp = median_mvp(A0, B0, sub_c(pick(-1, 2), pick(-1, -1)))
    q1_mvp = median_mvp(pick(0, 1), pick(-1, 2),
                        sub_c(pick(-1, 4), pick(-1, 1)))
    q2_mvp = median_mvp(pick(2, -1), pick(1, 0),
                        sub_c(pick(1, 2), pick(1, -1)))
    q3_mvp = median_mvp(pick(2, 1), pick(1, 2),
                        sub_c(pick(1, 4), pick(1, 1)))

    pm = part_mode[..., None]
    mvp0 = torch.where(pm == 0, mvp16, torch.where(
        pm == 1, t_mvp, torch.where(pm == 2, l_mvp, q0_mvp)))
    mvp1 = torch.where(pm == 1, b_mvp, torch.where(
        pm == 2, r_mvp, torch.where(pm == 3, q1_mvp, mvp16)))
    mvp2 = torch.where(pm == 3, q2_mvp, mvp16)
    mvp3 = torch.where(pm == 3, q3_mvp, mvp16)
    mvp = torch.stack([mvp0, mvp1, mvp2, mvp3], dim=2)
    # P-Skip (8.4.1.1): the MB's own left / top 4x4 neighbours, refIdx 0
    mvp16_r0 = mvp16 if ref4 is None else median_mvp(A0, B0, C0, r0=True)
    azero = A0[4][..., None] & (A0[0] == 0).all(-1, keepdim=True)
    bzero = B0[4][..., None] & (B0[0] == 0).all(-1, keepdim=True)
    pskip = torch.where(((~A0[2]) | (~B0[2]))[..., None], 0,
                        torch.where(azero | bzero, 0, mvp16_r0))
    return mvp, pskip


# ---------------------------------------------------- sub-pel refinement
SUBPEL_MARG = 2      # window margin: covers the qpel radius-3 taps
SUBPEL_WIN = 24


def _subpel_cand_table(radius: int) -> np.ndarray:
    """One row per candidate of the +-radius qpel grid, (0, 0) first:
    (qdx, qdy, p0, p1, oy0, ix, iy, ox1, avg)."""
    cands = [(0, 0)] + [(qdx, qdy)
                        for qdy in range(-radius, radius + 1)
                        for qdx in range(-radius, radius + 1)
                        if (qdx, qdy) != (0, 0)]
    rows = []
    for qdx, qdy in cands:
        fx, fy = qdx & 3, qdy & 3
        ix, iy = qdx >> 2, qdy >> 2
        q = fy * 4 + fx
        rows.append((qdx, qdy, int(mc.HPEL_REF0[q]), int(mc.HPEL_REF1[q]),
                     iy + (1 if fy == 3 else 0), ix, iy,
                     ix + (1 if fx == 3 else 0), 1 if (q & 5) else 0))
    return np.asarray(rows, np.int32)


def _subpel_refine_scan(win, tiles, mv_fp, lam, masks, radius: int = 3,
                        mvp_q=None):
    """The qpel grid over L partition lanes at once (x264_tpu
    inter._subpel_refine_scan). win [L, n, 4, 24, 24] hpel windows (any
    integer dtype) at each lane's full-pel winner; tiles [n, 16, 16];
    mv_fp [L, n, 2]; masks [L, 16] 0/1 over the raster 4x4 blocks of each
    lane's partition; mvp_q [n, 2] the qpel MVP the rate is costed against.
    Returns (best_q [L, n, 2], best_pred [L, n, 16, 16], best_cost [L, n])."""
    L, n = win.shape[:2]
    dev = win.device
    M = SUBPEL_MARG
    tab = _subpel_cand_table(radius)
    off_t = const(tab[:, :2], dev)
    maskb = masks.to(_i32)[:, None, :]
    if mvp_q is None:
        mvp_q = torch.zeros((1, n, 2), dtype=_i32, device=dev)
    elif mvp_q.dim() == 2:
        mvp_q = mvp_q[None]
    src = tiles.to(_i32)[None]
    bc = torch.full((L, n), 1 << 30, dtype=_i32, device=dev)
    bq = mv_fp * 4
    bp = win[:, :, 0, M:M + 16, M:M + 16].to(_i32)
    for k, row in enumerate(tab.tolist()):
        _, _, p0, p1, oy0, ix, iy, ox1, avg = row
        predq = win[:, :, p0, M + oy0:M + oy0 + 16,
                    M + ix:M + ix + 16].to(_i32)
        if avg:
            s1 = win[:, :, p1, M + iy:M + iy + 16, M + ox1:M + ox1 + 16]
            predq = (predq + s1.to(_i32) + 1) >> 1
        mvq = mv_fp * 4 + off_t[k]
        cost = ((_satd16_map(predq, src) * maskb).sum(-1, dtype=_i32)
                + lam * (_mv_cost_bits(mvq[..., 0] - mvp_q[..., 0])
                         + _mv_cost_bits(mvq[..., 1] - mvp_q[..., 1])))
        better = cost < bc
        bc = torch.where(better, cost, bc)
        bq = torch.where(better[..., None], mvq, bq)
        bp = torch.where(better[..., None, None], predq, bp)
    return bq, bp, bc


def _subpel_windows(hpel, mv_c, me_range: int):
    """24x24 hpel windows at mv_c [..., mbh, mbw, 2] -> [..., n, 4, 24, 24]
    uint8 (x264_tpu inter._subpel_windows, which gives them as int32).
    The search keeps |mv| <= me_range <= PAD - 8, so they stay inside."""
    mbh, mbw = mv_c.shape[-3:-1]
    win = mb_windows_ref(hpel, mv_c - SUBPEL_MARG, bs=16, win=SUBPEL_WIN,
                         pad=mc.PAD)
    return win.reshape(mv_c.shape[:-3] + (mbh * mbw, 4, SUBPEL_WIN,
                                          SUBPEL_WIN))


@trace.spanned("analysis:subpel")
def subpel_refine_mc(hpel, y_src, mv_c, lam, me_range: int, radius: int = 3,
                     mvp_q=None):
    """subpel_refine_mc_ref's refinement of one lane, with its arguments
    and result: CUDA tensors go to the me_subpel kernel (ops/motion.py
    subpel_launch), CPU tensors to subpel_refine_mc_ref. `lam` is a host
    integer."""
    if not y_src.is_cuda:
        return subpel_refine_mc_ref(hpel, y_src, mv_c, lam, me_range,
                                    radius=radius, mvp_q=mvp_q)
    bq, bp, bc = _subpel_lanes_cuda(hpel, y_src, mv_c[None], lam, radius,
                                    mvp_q)
    return bq[0], bp[0], bc[0]


def subpel_refine_mc_ref(hpel, y_src, mv_c, lam, me_range: int,
                         radius: int = 3, mvp_q=None):
    """Qpel refinement of the 16x16 full-pel winners mv_c [mbh, mbw, 2]
    over the whole +-radius grid, and the luma prediction at the result
    (x264_tpu inter.subpel_refine_mc).
    Returns (mvq [n, 2] qpel, pred [n, 16, 16] int32, cost [n])."""
    H, W = y_src.shape
    n = (H // 16) * (W // 16)
    tiles = _mb_tiles(y_src, 16).reshape(n, 16, 16)
    win = _subpel_windows(hpel, mv_c, me_range)[None]
    bq, bp, bc = _subpel_refine_scan(
        win, tiles, mv_c.reshape(1, n, 2), lam,
        torch.ones((1, 16), dtype=_i32, device=y_src.device), radius,
        mvp_q=mvp_q)
    return bq[0], bp[0], bc[0]


# raster 4x4-block membership of the 9 refine lanes: 16x16, 16x8 top /
# bottom, 8x16 left / right, 8x8 q0..q3
_PART_MASKS = np.zeros((9, 16), np.int32)
for _b in range(16):
    _by, _bx = _b // 4, _b % 4
    _PART_MASKS[:, _b] = [1, _by < 2, _by >= 2, _bx < 2, _bx >= 2,
                          _by < 2 and _bx < 2, _by < 2 and _bx >= 2,
                          _by >= 2 and _bx < 2, _by >= 2 and _bx >= 2]


def _subpel_lanes_cuda(hpel, y_src, lane_mv, lam, radius, mvp_q):
    """The me_subpel kernel over the lanes of lane_mv [L, mbh, mbw, 2],
    each weighing the 4x4 blocks of its partition (_PART_MASKS)."""
    dev = y_src.device
    return motion.subpel_launch(
        hpel.contiguous(), y_src.contiguous(), lane_mv.contiguous(),
        const(_PART_MASKS[:lane_mv.shape[0]], dev),
        const(_subpel_cand_table(radius), dev), lam,
        None if mvp_q is None else mvp_q.contiguous())


def subpel_refine_all(hpel, y_src, mvs, lam, me_range: int, radius: int = 3,
                      mvp_q=None, p8x8: bool = True):
    """subpel_refine_all_ref's refinement of 5 or 9 lanes, with its
    arguments and result: CUDA tensors go to the me_subpel kernel (one
    launch for every lane, ops/motion.py subpel_launch), CPU tensors to
    subpel_refine_all_ref. `lam` is a host integer."""
    if not y_src.is_cuda:
        return subpel_refine_all_ref(hpel, y_src, mvs, lam, me_range,
                                     radius=radius, mvp_q=mvp_q, p8x8=p8x8)
    lane_mvs = [mvs["16x16"], mvs["16x8"][:, :, 0], mvs["16x8"][:, :, 1],
                mvs["8x16"][:, :, 0], mvs["8x16"][:, :, 1]]
    if p8x8:
        lane_mvs += [mvs["8x8"][:, :, q] for q in range(4)]
    bq, bp, bc = _subpel_lanes_cuda(hpel, y_src, torch.stack(lane_mvs), lam,
                                    radius, mvp_q)
    pred_parts = (bp[1, :, 0:8, :], bp[2, :, 8:16, :], bp[3, :, :, 0:8],
                  bp[4, :, :, 8:16])
    if p8x8:
        pred_parts += (bp[5, :, 0:8, 0:8], bp[6, :, 0:8, 8:16],
                       bp[7, :, 8:16, 0:8], bp[8, :, 8:16, 8:16])
    return bq[0], bp[0], bc[0], bq[1:], pred_parts, bc[1:]


def subpel_refine_all_ref(hpel, y_src, mvs, lam, me_range: int,
                          radius: int = 3, mvp_q=None, p8x8: bool = True):
    """Qpel refinement of the 16x16, 16x8 and 8x16 winners, and with p8x8
    of the four 8x8 quadrants, in one pass over 5 or 9 lanes (x264_tpu
    inter.subpel_refine_all).
    Returns (mvq16 [n,2], pred16 [n,16,16], cost16 [n], q_parts [4|8,n,2],
    pred_parts (t, b, l, r [, q0..q3]), cost_parts [4|8,n])."""
    H, W = y_src.shape
    n = (H // 16) * (W // 16)
    tiles = _mb_tiles(y_src, 16).reshape(n, 16, 16)
    lane_mvs = [mvs["16x16"], mvs["16x8"][:, :, 0], mvs["16x8"][:, :, 1],
                mvs["8x16"][:, :, 0], mvs["8x16"][:, :, 1]]
    if p8x8:
        lane_mvs += [mvs["8x8"][:, :, q] for q in range(4)]
    L = len(lane_mvs)
    lane_mv = torch.stack(lane_mvs)                      # [L, mbh, mbw, 2]
    win = _subpel_windows(hpel, lane_mv, me_range)
    bq, bp, bc = _subpel_refine_scan(
        win, tiles, lane_mv.reshape(L, n, 2), lam,
        const(_PART_MASKS[:L], y_src.device), radius, mvp_q=mvp_q)
    pred_parts = (bp[1, :, 0:8, :], bp[2, :, 8:16, :], bp[3, :, :, 0:8],
                  bp[4, :, :, 8:16])
    if p8x8:
        pred_parts += (bp[5, :, 0:8, 0:8], bp[6, :, 0:8, 8:16],
                       bp[7, :, 8:16, 0:8], bp[8, :, 8:16, 8:16])
    return bq[0], bp[0], bc[0], bq[1:], pred_parts, bc[1:]


def _first_min(costs):
    """(index of the first minimum, minimum) over a list of equal-shape
    cost tensors, as jnp.argmin / jnp.min of their stack give them."""
    best, idx = costs[0], torch.zeros_like(costs[0])
    for k, c in enumerate(costs[1:], 1):
        better = c < best
        best = torch.where(better, c, best)
        idx = torch.where(better, k, idx)
    return idx.to(_i32), best


@trace.spanned("analysis:fullpel")
def p_fullpel_core(y, ref_y_pad, lam, pir_cap=None, *, me_range,
                   me_seeded=True, shapes=True):
    """Full-pel ME against one reference (the seeded search, or the
    exhaustive one without me_seeded) and the qpel MVP estimate of its
    16x16 winners; without shapes only the 16x16 lane is searched.
    Returns (mvs dict, mvp_q_est [n, 2])."""
    if me_seeded:
        mvs = motion_search_seeded(ref_y_pad, y, lam, me_range,
                                   shapes=shapes, pir_cap=pir_cap)
    else:
        mvs = motion_search(ref_y_pad, None, y, lam, me_range,
                            shapes=shapes, pir_cap=pir_cap)
    if not shapes:
        mvs = {"16x16": mvs}
    mvp_q_est, _ = mv_predictors(mvs["16x16"] * 4)
    return mvs, mvp_q_est.reshape(-1, 2)


@trace.spanned("analysis:subpel")
def p_subpel_core(y, ref_hpel, mvs, mvp_q_est, lam, w, o, *, me_range,
                  weighted=True, return_cands=False, p8x8=True,
                  partitions=True):
    """One reference: qpel refinement of all partition lanes, the SATD
    partition choice and weighted prediction (x264_tpu
    inter.p_subpel_core; p8x8 adds the P_8x8 candidate; without
    partitions only the 16x16 lane is refined, and no candidates are
    returned). Returns a dict of per-MB cost, pred_y, mvq, part_mode,
    mv_parts; with return_cands the 3 or 4 assembled candidates cand_pred
    [M,n,16,16] and cand_mv [M,n,4,2]."""
    n = mvp_q_est.shape[0]

    def wp_apply(p):
        if weighted:
            return (((p * w + 64) >> 7) + o).clamp(0, 255)
        return p

    if not partitions:
        mvq, pred_y, inter_cost = subpel_refine_mc(
            ref_hpel, y, mvs["16x16"], lam, me_range, mvp_q=mvp_q_est)
        return {"mvq": mvq, "pred_y": wp_apply(pred_y), "cost": inter_cost,
                "part_mode": torch.zeros((n,), dtype=_i32, device=y.device),
                "mv_parts": mvq[:, None, :].expand(n, 4, 2)}

    (mvq, pred16, cost16, q_parts, pp, c_parts) = subpel_refine_all(
        ref_hpel, y, mvs, lam, me_range, mvp_q=mvp_q_est, p8x8=p8x8)
    q_t, q_b, q_l, q_r = q_parts[0], q_parts[1], q_parts[2], q_parts[3]
    # partition cost = the sum of its parts' ME costs; P_8x8 also pays its
    # header delta (mb_type ue(3) + four sub_mb_type bits)
    costs = [cost16, c_parts[0] + c_parts[1], c_parts[2] + c_parts[3]]
    cand_pred = [pred16, torch.cat([pp[0], pp[1]], dim=1),
                 torch.cat([pp[2], pp[3]], dim=2)]
    cand_mv = [mvq[:, None, :].expand(n, 4, 2),
               torch.stack([q_t, q_b, q_t, q_b], dim=1),
               torch.stack([q_l, q_r, q_l, q_r], dim=1)]
    if p8x8:
        costs.append(c_parts[4] + c_parts[5] + c_parts[6] + c_parts[7]
                     + lam * 8)
        cand_pred.append(torch.cat([torch.cat([pp[4], pp[5]], dim=2),
                                    torch.cat([pp[6], pp[7]], dim=2)], dim=1))
        cand_mv.append(torch.stack([q_parts[4], q_parts[5], q_parts[6],
                                    q_parts[7]], dim=1))
    part_mode, inter_cost = _first_min(costs)
    pm3 = part_mode[:, None, None]
    pred_y, mv_parts = cand_pred[-1], cand_mv[-1]
    for m in range(len(costs) - 2, -1, -1):
        pred_y = torch.where(pm3 == m, cand_pred[m], pred_y)
        mv_parts = torch.where(pm3 == m, cand_mv[m], mv_parts)
    out = {"mvq": mvq, "pred_y": wp_apply(pred_y), "cost": inter_cost,
           "part_mode": part_mode, "mv_parts": mv_parts}
    if return_cands:
        out["cand_pred"] = wp_apply(torch.stack(cand_pred))
        out["cand_mv"] = torch.stack(cand_mv)
    return out


@trace.spanned("analysis:subpel")
def p_me_select(r0, r1, ref1_valid):
    """Per-MB choice between the two L0 references: ref 1 only when its
    cost is strictly lower; ref1_valid False (a bool or a 0-d tensor) pins
    ref 0. Returns (inter_cost, pred_y, mvq, part_mode, mv_parts, refidx,
    cands)."""
    sel1 = r1["cost"] < r0["cost"]
    if ref1_valid is not None:
        sel1 = sel1 & to_device(ref1_valid, sel1.device, "ref1_valid")

    def pick_sel(k, lead=0):
        a = r0[k]
        s = sel1.reshape((1,) * lead + (-1,) + (1,) * (a.dim() - lead - 1))
        return torch.where(s, r1[k], a)

    cands = None
    if "cand_pred" in r0:
        cands = (pick_sel("cand_pred", 1), pick_sel("cand_mv", 1))
    return (pick_sel("cost"), pick_sel("pred_y"), pick_sel("mvq"),
            pick_sel("part_mode"), pick_sel("mv_parts"), sel1.to(_i32),
            cands)


# ------------------------------------------------------------ RD tier
# mb_type ue() bits of P modes 0..3 (P_8x8 with its four sub_mb_type
# bits), partitions per mode, and the MV slots each mode codes
_P_MODE_HDR_BITS = np.array([1, 3, 3, 5 + 4], np.int32)
_P_MODE_NPARTS = np.array([1, 2, 2, 4], np.int32)
_P_MODE_SLOTS = np.array([[1, 0, 0, 0], [1, 1, 0, 0], [1, 1, 0, 0],
                          [1, 1, 1, 1]], np.int32)
# lambda2 = max(1, round(.9 * 2 ** ((qp - 12) / 3))) in float32, by qp
LAMBDA2_TAB = np.maximum(1, np.round(
    np.float32(0.9) * np.float32(2.0) ** (
        (np.arange(52, dtype=np.float32) - np.float32(12))
        / np.float32(3.0)))).astype(np.int32)


def _luma_bits(lv_z, mbh, mbw, lo=0):
    """CAVLC bits of [n, 16, 16] zig-zag luma levels (from position lo)."""
    n = lv_z.shape[0]
    nnz = (lv_z[:, :, lo:] != 0).sum(2, dtype=_i32)
    nc = _nc_grid_dev(nnz, mbh, mbw, 4)
    _, lens, _, _ = residual_blocks_dev(
        lv_z[:, :, lo:].reshape(n * 16, 16 - lo), nc.reshape(-1))
    return lens.reshape(n, -1).sum(1, dtype=_i32), nc


@trace.spanned("analysis:rd")
def p_rd_core(y, cand_pred, cand_mv, mvp_q_est, qp_mb, two_refs_live,
              i16_mode, *, mbw, mbh, two_refs, intra_rd=True):
    """RD re-rank of the partition shape and, with intra_rd, of intra vs
    inter (x264_tpu inter.p_rd_core) over the M = 3 or 4 candidates it is
    given: every candidate is coded in full and priced SSD + lambda2 *
    (CAVLC luma bits + MVD / header / ref bits), under CABAC too, as in
    x264_tpu. Returns (part_mode [n], pred_y [n,16,16], mv_parts [n,4,2],
    is_intra_rd [mbh, mbw], None without intra_rd)."""
    dev = y.device
    M = cand_pred.shape[0]
    n = mbw * mbh
    src = _mb_tiles(y, 16).reshape(n, 16, 16).to(_i32)
    qp = qp_mb.reshape(-1).to(_i32)
    lam2 = const(LAMBDA2_TAB, dev)[qp.long()]
    bc = torch.full((n,), torch.iinfo(torch.int32).max, dtype=_i32,
                    device=dev)
    part_mode = torch.zeros((n,), dtype=_i32, device=dev)
    for m in range(M):
        pred = cand_pred[m]
        w = dct.dct4x4(_luma_blocks(src - pred))
        lv = quant.quant4x4(w, qp[:, None], intra=False)
        dq = quant.dequant4x4(lv, qp[:, None])
        d = (pred + _luma_merge(dct.idct4x4(dq))).clamp(0, 255) - src
        ssd = (d * d).sum((1, 2), dtype=_i32)
        rbits, _ = _luma_bits(dct.zigzag4(lv), mbh, mbw)
        mvd = cand_mv[m] - mvp_q_est[:, None, :]
        slots = const(_P_MODE_SLOTS[m], dev)
        mvbits = (slots * (_mv_cost_bits(mvd[..., 0])
                           + _mv_cost_bits(mvd[..., 1]))).sum(1, dtype=_i32)
        bits = rbits + mvbits + int(_P_MODE_HDR_BITS[m])
        if two_refs:
            live = to_device(two_refs_live, dev, "ref1_valid")
            bits = bits + torch.where(live, int(_P_MODE_NPARTS[m]), 0)
        cost = ssd + lam2 * bits
        better = cost < bc
        bc = torch.where(better, cost, bc)
        part_mode = torch.where(better, m, part_mode)
    ar = torch.arange(n, device=dev)
    pred_y = cand_pred[part_mode.long(), ar]
    mv_parts = cand_mv[part_mode.long(), ar]
    if not intra_rd:
        return part_mode, pred_y, mv_parts, None

    # the intra candidate at the same tier: exact I16 luma from source
    # neighbours, true CAVLC bits plus a flat 12-bit header
    t16 = _mb_tiles(y, 16)
    top = torch.roll(t16[:, :, 15, :], 1, dims=0)
    left = torch.roll(t16[:, :, :, 15], 1, dims=1)
    tl = torch.roll(torch.roll(t16[:, :, 15, 15], 1, 0), 1, 1)
    at = (torch.arange(mbh, device=dev)[:, None] > 0).expand(mbh, mbw)
    al = (torch.arange(mbw, device=dev)[None, :] > 0).expand(mbh, mbw)
    preds = predict.predict_16x16_all(left, top, tl, al, at)
    pred_i = torch.gather(
        preds, 2, i16_mode.long()[:, :, None, None, None].expand(
            mbh, mbw, 1, 16, 16))[:, :, 0].reshape(n, 16, 16)
    dc_lv, ac_lv, rec_i = _encode_luma_i16(src, pred_i.to(_i32), qp)
    di = rec_i - src
    ssd_i = (di * di).sum((1, 2), dtype=_i32)
    abits, nc = _luma_bits(dct.zigzag4(ac_lv), mbh, mbw, lo=1)
    _, dlens, _, _ = residual_blocks_dev(dct.zigzag4(dc_lv), nc[:, 0])
    bits_i = dlens.sum(1, dtype=_i32) + abits + 12
    is_intra_rd = (ssd_i + lam2 * bits_i < bc).reshape(mbh, mbw)
    return part_mode, pred_y, mv_parts, is_intra_rd


@trace.spanned("analysis:intra")
def p_intra_core(y, u, v, qp_mb, *, i4):
    """The intra candidate of every P MB: I16x16 / chroma mode costs (and
    I_4x4 with i4) from source neighbours at the per-MB lambda. Returns
    (i16_mode, chroma_mode, i4_modes, use_i4, best_intra [mbh, mbw])."""
    mbh, mbw = qp_mb.shape
    lam_mb = mb_lambda(qp_mb)
    i16_mode, chroma_mode, _, i16_cost = decide_modes_full(y, u, v,
                                                           lam=lam_mb)
    if not i4:
        return (i16_mode, chroma_mode, None,
                torch.zeros((mbh, mbw), dtype=torch.bool, device=y.device),
                i16_cost)
    i4_modes, i4_cost = decide_modes_i4(y, lam=lam_mb)
    return (i16_mode, chroma_mode, i4_modes, i4_cost < i16_cost,
            torch.minimum(i16_cost, i4_cost))


# ----------------------------------------------------- transform and MC
def chroma_mc_warp(cpads, mvq, mbh: int, mbw: int):
    """Chroma MC of every MB through 9x9 windows and the spec bilinear
    (8.4.2.2.2). cpads [2, Hc + 2*CPAD, Wc + 2*CPAD]; mvq [n, 2] luma qpel.
    Returns pred [n, 2, 8, 8] int32."""
    n = mvq.shape[0]
    coff = (mvq >> 3).reshape(mbh, mbw, 2)
    cwin = mb_windows_ref(cpads, coff, bs=8, win=9, pad=mc.CPAD) \
        .reshape(n, 2, 9, 9).to(_i32)
    A, B = cwin[:, :, 0:8, 0:8], cwin[:, :, 0:8, 1:9]
    C, D = cwin[:, :, 1:9, 0:8], cwin[:, :, 1:9, 1:9]
    dx = (mvq[:, 0] & 7)[:, None, None, None]
    dy = (mvq[:, 1] & 7)[:, None, None, None]
    return ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B
            + (8 - dx) * dy * C + dx * dy * D + 32) >> 6


def _merge_plane(mb_tensor, s, hh, ww):
    return mb_tensor.reshape(hh // s, ww // s, s, s).transpose(1, 2) \
        .reshape(hh, ww)


@trace.spanned("analysis:xfrm")
def p_xfrm_core(y, u, v, ref_cuv_pad, ref1_cuv_pad, inter_cost, pred_y, mvq,
                part_mode, mv_parts, refidx, i16_mode, chroma_mode, i4_modes,
                use_i4, best_intra, qp_mb, qpc_mb, is_intra_override=None,
                trl_tabs=None, pir_band=None, nr_offset=None, *, mbw, mbh,
                two_refs, decimate, p8x8=True, partitions=True,
                intra_in_p=True, pir=False, nr=False):
    """Intra vs inter -> MVP / skip predictor / MVD -> chroma MC ->
    transform, noise reduction (nr: denoise_dct by nr_offset), quant (given
    trl_tabs = frame_ctx_costs(False, qp, cat=2), the trellis: the
    RD-optimal requantization of the inter luma levels) and decimation ->
    the inter reconstruction (x264_tpu inter.p_xfrm_core; without p8x8 no
    MB has part_mode 3 and chroma is predicted from 2 partition slots, not
    4; without partitions every MB is one 16x16 partition). Without
    intra_in_p no MB is intra; pir forces the column band pir_band intra.
    ref1_cuv_pad None: no MB takes reference 1. Returns the dict
    p_merge_core reads."""
    H, W = y.shape
    n = mbw * mbh
    dev = y.device
    satd_cost = inter_cost.sum(dtype=_i32)

    # intra vs inter: the RD tier's verdict when it ran, else SATD
    if intra_in_p:
        if is_intra_override is not None:
            is_intra = is_intra_override
        else:
            is_intra = (best_intra.reshape(-1) < inter_cost).reshape(mbh,
                                                                     mbw)
        i4_mask = is_intra & use_i4
    else:
        i16_mode = torch.zeros((mbh, mbw), dtype=_i32, device=dev)
        chroma_mode = torch.zeros_like(i16_mode)
        is_intra = torch.zeros((mbh, mbw), dtype=torch.bool, device=dev)
        i4_mask = torch.zeros_like(is_intra)
        i4_modes = None
    if pir:
        # the refresh sweep's column band is intra whatever it chose (an
        # MB it forces is I16 unless the decision already took I_4x4)
        assert intra_in_p, "PIR requires the intra-in-P candidate"
        is_intra = is_intra | pir_band
    is_intra_f = is_intra.reshape(-1)
    refidx = torch.where(is_intra_f, 0, refidx).to(_i32)
    ref_grid = refidx.reshape(mbh, mbw)
    two_ref_grid = ref_grid if two_refs else None
    if partitions:
        part_grid = part_mode.reshape(mbh, mbw)
        # which partition slot each 4x4 cell belongs to, per mode
        r4 = torch.arange(4, device=dev)
        pm4 = part_grid[..., None, None]
        row_hi = (r4[:, None] >= 2).to(_i32)
        col_hi = (r4[None, :] >= 2).to(_i32)
        pid4 = torch.where(pm4 == 1, row_hi, torch.where(
            pm4 == 2, col_hi, torch.where(pm4 == 3, 2 * row_hi + col_hi, 0)))
        mvp5 = mv_parts.reshape(mbh, mbw, 4, 2)
        mv4 = mvp5[:, :, 0][:, :, None, None, :].expand(mbh, mbw, 4, 4, 2)
        for k in range(1, 4):
            mv4 = torch.where((pid4 == k)[..., None],
                              mvp5[:, :, k][:, :, None, None, :], mv4)
        inter4 = _rep4(~is_intra)
        mv4_grid = torch.where(
            inter4[..., None],
            mv4.transpose(1, 2).reshape(mbh * 4, mbw * 4, 2), 0)
        mvp_pp, pskip = mv_predictors_part(
            mv4_grid, inter4, part_grid,
            ref4=None if two_ref_grid is None else _rep4(two_ref_grid),
            cur_ref=two_ref_grid)
        mvd_parts = (mvp5 - mvp_pp).reshape(n, 4, 2)
        mvd, mvd2, mvd23 = (mvd_parts[:, 0], mvd_parts[:, 1],
                            mvd_parts[:, 2:4])
        mv_field = mv_parts[:, 0].reshape(mbh, mbw, 2)
    else:
        mv_field = mvq.reshape(mbh, mbw, 2)
        mvp, pskip = mv_predictors(mv_field, ~is_intra, ref_grid=two_ref_grid,
                                   cur_ref=two_ref_grid)
        mvd = (mv_field - mvp).reshape(n, 2)
        mvd2 = torch.zeros((n, 2), dtype=_i32, device=dev)
        mvd23 = torch.zeros((n, 2, 2), dtype=_i32, device=dev)
        part_mode = torch.zeros((n,), dtype=_i32, device=dev)
        mv4_grid = None

    # ---- luma transform and quant ----
    src_y = _mb_tiles(y, 16).reshape(n, 16, 16)
    qp = qp_mb.reshape(-1).to(_i32)
    w = dct.dct4x4(_luma_blocks(src_y.to(_i32) - pred_y))
    nr_sums = None
    if nr:
        # noise reduction before quant, inter luma only
        w, nr_sums = quant.denoise_dct(w, nr_offset)
    lv = quant.quant4x4(w, qp[:, None], intra=False)
    if trl_tabs is not None:
        # one batched Viterbi over all 16 n 4x4 blocks of the frame
        sig_c, last_c, lvl_s = trl_tabs
        out_z, _ = trellis_4x4(dct.zigzag4(lv).reshape(n * 16, 16),
                               dct.zigzag4(w).reshape(n * 16, 16),
                               qp.repeat_interleave(16), sig_c, last_c, lvl_s)
        lv = dct.izigzag4(out_z).reshape(n, 16, 4, 4)

    # ---- chroma: one MC per partition slot, selected per pixel ----
    qpc = qpc_mb.reshape(-1).to(_i32)
    r8 = torch.arange(8, device=dev)
    pmf = part_mode[:, None, None]
    rhi = (r8[:, None] >= 4).to(_i32)
    chi = (r8[None, :] >= 4).to(_i32)
    pidc = torch.where(pmf == 1, rhi, torch.where(
        pmf == 2, chi, torch.where(pmf == 3, 2 * rhi + chi, 0)))[:, None]

    def chroma_pred(cuv_pad):
        if not partitions:
            return chroma_mc_warp(cuv_pad, mvq, mbh, mbw)
        out = chroma_mc_warp(cuv_pad, mv_parts[:, 0], mbh, mbw)
        for k in range(1, 4 if p8x8 else 2):
            out = torch.where(pidc == k, chroma_mc_warp(
                cuv_pad, mv_parts[:, k], mbh, mbw), out)
        return out

    pred_c_all = chroma_pred(ref_cuv_pad)
    if two_refs and ref1_cuv_pad is not None:
        pred_c_all = torch.where((refidx == 1)[:, None, None, None],
                                 chroma_pred(ref1_cuv_pad), pred_c_all)
    out_c = []
    for ci, src_pl in enumerate((u, v)):
        pred_c = pred_c_all[:, ci]
        src_c = _mb_tiles(src_pl, 8).reshape(n, 8, 8)
        wc = dct.dct4x4(_chroma_blocks(src_c.to(_i32) - pred_c))
        had = dct.hadamard2x2(wc[:, :, 0, 0].reshape(-1, 2, 2))
        dc_lv = quant.quant2x2_dc(had, qpc, intra=False)
        ac_lv = quant.quant4x4(wc, qpc[:, None], intra=False)
        ac_lv[:, :, 0, 0] = 0
        dc_vals = quant.dequant2x2_dc(dct.ihadamard2x2(dc_lv), qpc)
        d = quant.dequant4x4(ac_lv, qpc[:, None])
        d[:, :, 0, 0] = dc_vals.reshape(-1, 4)
        rec_c = (pred_c + _chroma_merge(dct.idct4x4(d))).clamp(0, 255)
        out_c.append((dc_lv, ac_lv, rec_c))
    (udc, uac, urec), (vdc, vac, vrec) = out_c

    # ---- dct decimation (macroblock.c:654): drop 8x8 groups scoring < 4
    # and the whole MB's luma under 6 ----
    dec_score = (_decimate_score(dct.zigzag4(lv)) if decimate else
                 torch.full((n, 16), 99, dtype=_i32, device=dev))
    quad_of = [(r // 2) * 2 + (c // 2) for r in range(4) for c in range(4)]
    qsum = torch.stack([sum(dec_score[:, b] for b in range(16)
                            if quad_of[b] == q) for q in range(4)], dim=1)
    keep_quad = (qsum >= 4) & (qsum.sum(1) >= 6)[:, None]
    keep_blk = keep_quad[:, const(quad_of, dev, torch.int64)]
    lv = torch.where(keep_blk[:, :, None, None], lv, 0)
    dq = quant.dequant4x4(lv, qp[:, None])
    recon_y_mb = (pred_y + _luma_merge(dct.idct4x4(dq))).clamp(0, 255)

    u8 = torch.uint8
    return {
        "lv": lv, "udc": udc, "vdc": vdc, "uac": uac, "vac": vac,
        "recon_y": _merge_plane(recon_y_mb, 16, H, W).to(u8),
        "recon_u": _merge_plane(urec, 8, H // 2, W // 2).to(u8),
        "recon_v": _merge_plane(vrec, 8, H // 2, W // 2).to(u8),
        "is_intra": is_intra, "i4_mask": i4_mask, "i16_mode": i16_mode,
        "chroma_mode": chroma_mode, "i4_modes": i4_modes,
        "mvd": mvd, "mvd2": mvd2, "mvd23": mvd23, "part_mode": part_mode,
        "refidx": refidx, "ref_grid": ref_grid, "mv_field": mv_field,
        "mv4_grid": mv4_grid, "pskip": pskip, "qp": qp,
        "nr_sums": nr_sums, "satd_cost": satd_cost,
    }


def mixed_commit_inputs(y, u, v, qp_mb, qpc_mb, xm, *, mbw, mbh, i4):
    """(args, kwargs) of the mixed commit of a P frame (ops/commit.commit,
    the kernel's mixed + I_4x4 variant with i4) from p_xfrm_core's dict."""
    args = (y, u, v, xm["i16_mode"].to(_i32).contiguous(),
            xm["chroma_mode"].to(_i32).contiguous(), qp_mb.contiguous(),
            qpc_mb.contiguous(), mbw, mbh)
    kw = dict(is_intra=xm["is_intra"].contiguous(),
              inter_planes=(xm["recon_y"], xm["recon_u"], xm["recon_v"]))
    if i4:
        kw.update(i4_mask=xm["i4_mask"].contiguous(),
                  i4_modes=xm["i4_modes"].to(_i32).contiguous())
    return args, kw


@trace.spanned("analysis:merge_cbp_skip")
def p_merge_core(y, u, v, qp_mb, qpc_mb, xm, *, mbw, mbh, two_refs, i4,
                 intra_in_p=True):
    """The mixed wavefront commit (intra MBs against their true decoded
    neighbours, inter MBs copied) and the level merge, then cbp / skip
    and the MB histogram (x264_tpu inter.p_merge_core).

    x264_tpu runs the commit under a lax.cond only when some MB is intra;
    the commit with no intra lane gives what its skip branch gives (the
    inter planes and zero levels), so the port commits every P frame of
    intra_in_p and never asks the device whether any MB is intra. Without
    intra_in_p nothing is committed."""
    committed = None
    if intra_in_p:
        args, kw = mixed_commit_inputs(y, u, v, qp_mb, qpc_mb, xm, mbw=mbw,
                                       mbh=mbh, i4=i4)
        committed = commit(*args, **kw)
    return p_merge_levels(xm, committed, mbw=mbw, mbh=mbh,
                          two_refs=two_refs, i4=i4)


def p_merge_levels(xm, committed, *, mbw, mbh, two_refs, i4):
    """What follows the mixed commit in p_merge_core: the level merge,
    cbp / skip and the MB histogram. committed: the commit's (coeffs,
    recon planes), or None without intra_in_p."""
    n = mbw * mbh
    dev = xm["lv"].device
    is_intra = xm["is_intra"]
    is_intra_f = is_intra.reshape(-1)
    i4_mask = xm["i4_mask"]
    lv, udc, vdc, uac, vac = (xm["lv"], xm["udc"], xm["vdc"], xm["uac"],
                              xm["vac"])
    if committed is not None:
        icoeffs, (recon_y, recon_u, recon_v) = committed
        im3 = is_intra_f[:, None, None]
        im4 = is_intra_f[:, None, None, None]
        lv = torch.where(im4, icoeffs["ac"], lv)
        udc = torch.where(im3, icoeffs["udc"], udc)
        vdc = torch.where(im3, icoeffs["vdc"], vdc)
        uac = torch.where(im4, icoeffs["uac"], uac)
        vac = torch.where(im4, icoeffs["vac"], vac)
        dc_blk = icoeffs["dc"]
    else:
        recon_y, recon_u, recon_v = (xm["recon_y"], xm["recon_u"],
                                     xm["recon_v"])
        dc_blk = torch.zeros((n, 4, 4), dtype=_i32, device=dev)

    # ---- cbp / skip on the merged levels ----
    nnz_l = (lv.reshape(n, 16, 16) != 0).sum(2, dtype=_i32)
    cbp_luma = torch.zeros((n,), dtype=_i32, device=dev)
    for qd in range(4):
        qy, qx = qd // 2, qd % 2
        qnnz = sum(nnz_l[:, (2 * qy + by) * 4 + (2 * qx + bx)]
                   for by in range(2) for bx in range(2))
        cbp_luma = cbp_luma + ((qnnz > 0).to(_i32) << qd)
    is_i4_f = i4_mask.reshape(-1)
    # I16 MBs code cbp_luma all-or-nothing; I4 MBs keep the quadrant bits
    cbp_luma = torch.where(is_intra_f & ~is_i4_f, torch.where(
        nnz_l.sum(1) > 0, 15, 0), cbp_luma).to(_i32)
    any_cac = ((uac.reshape(n, 64) != 0).sum(1)
               + (vac.reshape(n, 64) != 0).sum(1)) > 0
    any_cdc = ((udc.reshape(n, 4) != 0).sum(1)
               + (vdc.reshape(n, 4) != 0).sum(1)) > 0
    cbp_chroma = torch.where(any_cac, 2, torch.where(any_cdc, 1, 0)) \
        .to(_i32)
    part_mode, refidx = xm["part_mode"], xm["refidx"]
    mv_is_pskip = (xm["mv_field"].reshape(n, 2)
                   == xm["pskip"].reshape(n, 2)).all(1) & (part_mode == 0)
    if two_refs:
        mv_is_pskip = mv_is_pskip & (refidx == 0)   # P_Skip is ref 0
    skip = ((cbp_luma == 0) & (cbp_chroma == 0) & mv_is_pskip
            & ~is_intra_f)
    inter_f = ~is_intra_f
    return {
        "skip": skip, "mvd": xm["mvd"], "mvd2": xm["mvd2"],
        "mvd23": xm["mvd23"], "cbp_luma": cbp_luma,
        "cbp_chroma": cbp_chroma, "qp": xm["qp"], "lv": lv,
        "dc_blk": dc_blk,
        "cdc_blk": torch.stack([udc.reshape(n, 2, 2),
                                vdc.reshape(n, 2, 2)], dim=1),
        "cac_blk": torch.stack([uac.reshape(n, 4, 4, 4),
                                vac.reshape(n, 4, 4, 4)], dim=1),
        "is_intra": is_intra, "is_i4_f": is_i4_f,
        "i4_modes": xm["i4_modes"].reshape(-1, 16) if i4 else None,
        "i16_mode": xm["i16_mode"], "chroma_mode": xm["chroma_mode"],
        "refidx": refidx, "part_mode": part_mode,
        "recon_y": recon_y, "recon_u": recon_u, "recon_v": recon_v,
        "nnz_l": nnz_l, "mv_field": xm["mv_field"],
        "mv4_grid": (_rep4(xm["mv_field"]) if xm["mv4_grid"] is None
                     else xm["mv4_grid"]),
        "ref_grid": xm["ref_grid"], "nr_sums": xm["nr_sums"],
        "satd_cost": xm["satd_cost"],
        "skip_n": skip.sum(), "intra_n": is_intra_f.sum(),
        "i4_n": is_i4_f.sum(),
        "p16x8_n": ((part_mode == 1) & inter_f).sum(),
        "p8x16_n": ((part_mode == 2) & inter_f).sum(),
        "p8x8_n": ((part_mode == 3) & inter_f).sum(),
        "inter_mask": (~is_intra) & (xm["ref_grid"] == 0),
    }


def p_effqp_core(cm, slice_qp, *, mbw, mbh):
    """Decoder-carried per-MB QP for the CABAC path: MBs that parse
    mb_qp_delta update QP_prev: inter MBs with cbp > 0, every I16 MB (dqp
    always coded), and I4 MBs only with residual."""
    n = mbw * mbh
    dev = cm["qp"].device
    is_intra_f = cm["is_intra"].reshape(-1)
    has_resid = (((cm["cbp_luma"] > 0) | (cm["cbp_chroma"] > 0))
                 & ~cm["skip"]) | (is_intra_f & ~cm["is_i4_f"])
    idxs = torch.arange(n, dtype=_i32, device=dev)
    last_r = torch.cummax(torch.where(has_resid, idxs, -1), 0).values
    prev_r = torch.cat([torch.full((1,), -1, dtype=_i32, device=dev),
                        last_r[:-1]])
    prev_qp = torch.where(prev_r >= 0, cm["qp"][prev_r.clamp(min=0).long()],
                          slice_qp)
    return torch.where(has_resid, cm["qp"], prev_qp)


@trace.spanned("entropy:decisions")
def p_decisions_core(cm, slice_qp, *, mbw, mbh):
    """CABAC path: the decoder-carried QP and the narrow decision dict.
    Returns (decisions, eff_qp)."""
    eff_qp = p_effqp_core(cm, slice_qp, mbw=mbw, mbh=mbh)
    return p_decisions_dict(cm, eff_qp, mbw=mbw, mbh=mbh), eff_qp


def p_decisions_dict(cm, eff_qp, *, mbw, mbh):
    """Decision and level tensors for the host C++ CABAC writer, still on
    the frame's device. int16 / uint8 are lossless for 8-bit streams and
    halve what crosses to the host."""
    n = mbw * mbh
    dev = cm["qp"].device
    zig = const(ZIGZAG4_FRAME, dev, torch.int64)
    i4m = cm["i4_modes"]
    i16, u8 = torch.int16, torch.uint8
    return {
        "skip": cm["skip"], "mvd": cm["mvd"].to(i16),
        "cbp_luma": cm["cbp_luma"].to(u8),
        "cbp_chroma": cm["cbp_chroma"].to(u8),
        "qp": cm["qp"].to(u8),
        "luma_z": cm["lv"].reshape(n, 16, 16)[:, :, zig].to(i16),
        "cdc": cm["cdc_blk"].reshape(n, 2, 4).to(i16),
        "cac_z": cm["cac_blk"].reshape(n, 2, 4, 16)[:, :, :, zig].to(i16),
        "is_intra": cm["is_intra"].reshape(-1),
        "i16_mode": cm["i16_mode"].reshape(-1).to(u8),
        "chroma_mode": cm["chroma_mode"].reshape(-1).to(u8),
        "luma_dc_z": cm["dc_blk"].reshape(n, 16)[:, zig].to(i16),
        "part_mode": cm["part_mode"].to(u8),
        "mvd2": cm["mvd2"].to(i16),
        "mvd23": cm["mvd23"].to(i16),
        "is_i4": cm["is_i4_f"],
        "i4_modes": (i4m.to(u8) if i4m is not None
                     else torch.zeros((n, 16), dtype=u8, device=dev)),
        "refidx": cm["refidx"].to(u8),
    }


@trace.spanned("analysis:deblock")
def p_deblock_core(recon_y, recon_u, recon_v, is_intra, nnz_l, mv, eff_qp,
                   ref_grid=None, *, mbw, mbh, two_refs, a_off, b_off, cqpo):
    """In-loop deblock of a P frame: strengths, then the wavefront."""
    nnz4 = nnz_l.reshape(mbh, mbw, 4, 4).transpose(1, 2) \
        .reshape(mbh * 4, mbw * 4).to(_i32)
    bs_v, bs_h = compute_strengths(is_intra, nnz4, mv, mbw=mbw, mbh=mbh,
                                   ref_mb=ref_grid if two_refs else None)
    return deblock_frame(recon_y, recon_u, recon_v, bs_v, bs_h,
                         eff_qp.reshape(mbh, mbw), mbw=mbw, mbh=mbh,
                         a_off=a_off, b_off=b_off, chroma_qp_offset=cqpo)


# -------------------------------------------------------------- pipeline
def encode_pframe(y, u, v, refs, qp_mb, qpc_mb, slice_qp, lam, wp, *, mbw,
                  mbh, cap_words, me_range, deblock, a_off, b_off, cqpo,
                  decimate, i4, two_refs, entropy=True, p8x8=True,
                  trl_tabs=None, me_seeded=True, partitions=True, rd=True,
                  intra_in_p=True, pir_cap=None, pir_band=None,
                  nr_offset=None):
    """One P frame on the planes' device (x264_tpu inter._p_pipeline). refs:
    the live L0 references, 1 or 2 DPB entries (a second one only with
    two_refs); wp: (w, o) luma weight of reference 0 at denom 7, or None.

    x264_tpu runs a frame with one usable reference of a two-reference
    stream as ref1 := ref0 under a traced flag that pins the choice to ref 0
    and drops the te() ref_idx bits; the port searches the one reference
    and passes the same flag as a host bool, with identical results.

    entropy=True codes CAVLC on the device and returns its words and bit
    count; entropy=False (CABAC) returns the decision dict of
    `p_decisions_dict` in place of the words, and total_bits None.
    trl_tabs (frame_ctx_costs) turns the trellis on; me_seeded False takes
    the exhaustive full-pel search (me_method esa / tesa). partitions
    False searches and codes 16x16 only; rd runs the subme-7 RD tier (with
    partitions only); intra_in_p False drops the intra candidate and the
    commit. pir_cap / pir_band (periodic intra refresh): the per-MB cap on
    full-pel dx and the forced-intra column band. nr_offset [4, 4] turns
    noise reduction on. Returns (words, total_bits, recon planes, stats).

    The commit splits it in two: `p_analyse` before, `p_finish` after, so
    that one batched commit can serve the P frames of several streams
    (encoder/farm.py)."""
    xm = p_analyse(
        y, u, v, refs, qp_mb, qpc_mb, lam, wp, mbw=mbw, mbh=mbh,
        me_range=me_range, decimate=decimate, i4=i4, two_refs=two_refs,
        p8x8=p8x8, trl_tabs=trl_tabs, me_seeded=me_seeded,
        partitions=partitions, rd=rd, intra_in_p=intra_in_p, pir_cap=pir_cap,
        pir_band=pir_band, nr_offset=nr_offset)
    cm = p_merge_core(y, u, v, qp_mb, qpc_mb, xm, mbw=mbw, mbh=mbh,
                      two_refs=two_refs, i4=i4, intra_in_p=intra_in_p)
    del xm
    return p_finish(cm, slice_qp, mbw=mbw, mbh=mbh, cap_words=cap_words,
                    deblock=deblock, a_off=a_off, b_off=b_off, cqpo=cqpo,
                    i4=i4, two_refs=two_refs, ref1_valid=len(refs) == 2,
                    entropy=entropy, partitions=partitions)


def p_analyse(y, u, v, refs, qp_mb, qpc_mb, lam, wp, *, mbw, mbh, me_range,
              decimate, i4, two_refs, p8x8=True, trl_tabs=None,
              me_seeded=True, partitions=True, rd=True, intra_in_p=True,
              pir_cap=None, pir_band=None, nr_offset=None):
    """A P frame up to its commit (encode_pframe's arguments): motion,
    reference choice, the intra candidate, the RD tier and the transform.
    Returns p_xfrm_core's dict, from which `mixed_commit_inputs` takes the
    commit's inputs."""
    n = mbw * mbh
    ref1_valid = len(refs) == 2
    pir = pir_band is not None
    use_rd = rd and partitions
    # ---- motion: full-pel, sub-pel, reference choice ----
    rs = []
    for k, ref in enumerate(refs):
        w, o = wp if (k == 0 and wp is not None) else (128, 0)
        mvs, mvp_est = p_fullpel_core(y, ref["y_pad"], lam, pir_cap,
                                      me_range=me_range, me_seeded=me_seeded,
                                      shapes=partitions)
        if k == 0:
            mvp_rd = mvp_est
        rs.append(p_subpel_core(y, ref["hpel"], mvs, mvp_est, lam, w, o,
                                me_range=me_range, return_cands=use_rd,
                                p8x8=p8x8, partitions=partitions))
    if ref1_valid:
        (inter_cost, pred_y, mvq, part_mode, mv_parts, refidx,
         cands) = p_me_select(rs[0], rs[1], True)
    else:
        r0 = rs[0]
        inter_cost, pred_y, mvq, part_mode, mv_parts = (
            r0["cost"], r0["pred_y"], r0["mvq"], r0["part_mode"],
            r0["mv_parts"])
        refidx = torch.zeros((n,), dtype=_i32, device=y.device)
        cands = (r0["cand_pred"], r0["cand_mv"]) if use_rd else None
    del rs
    # ---- intra candidate, then the RD tier ----
    if intra_in_p:
        (i16_mode, chroma_mode, i4_modes, use_i4,
         best_intra) = p_intra_core(y, u, v, qp_mb, i4=i4)
    else:
        i16_mode = chroma_mode = i4_modes = use_i4 = None
        best_intra = torch.zeros((mbh, mbw), dtype=_i32, device=y.device)
    is_intra_rd = None
    if use_rd:
        part_mode, pred_y, mv_parts, is_intra_rd = p_rd_core(
            y, cands[0], cands[1], mvp_rd, qp_mb, ref1_valid, i16_mode,
            mbw=mbw, mbh=mbh, two_refs=two_refs, intra_rd=intra_in_p)
    del cands
    # ---- transform (the mixed commit and cbp / skip follow) ----
    return p_xfrm_core(
        y, u, v, refs[0]["cuv_pad"],
        refs[1]["cuv_pad"] if ref1_valid else None, inter_cost, pred_y, mvq,
        part_mode, mv_parts, refidx, i16_mode, chroma_mode, i4_modes,
        use_i4, best_intra, qp_mb, qpc_mb, is_intra_rd, trl_tabs, pir_band,
        nr_offset, mbw=mbw, mbh=mbh, two_refs=two_refs, decimate=decimate,
        p8x8=p8x8, partitions=partitions, intra_in_p=intra_in_p, pir=pir,
        nr=nr_offset is not None)


def p_finish(cm, slice_qp, *, mbw, mbh, cap_words, deblock, a_off, b_off,
             cqpo, i4, two_refs, ref1_valid, entropy=True, partitions=True):
    """A P frame after its commit (encode_pframe's arguments; cm:
    p_merge_core's or p_merge_levels' dict): entropy, then the deblock.
    Returns (words, total_bits, recon planes, stats)."""
    n = mbw * mbh
    # ---- entropy ----
    if entropy:
        words, total_bits, eff_qp = encode_pframe_entropy_dev(
            cm["skip"], cm["mvd"], cm["cbp_luma"], cm["cbp_chroma"],
            cm["qp"], slice_qp, cm["lv"].reshape(n, 16, 4, 4),
            cm["cdc_blk"], cm["cac_blk"], mbw=mbw, mbh=mbh,
            cap_words=cap_words, is_intra=cm["is_intra"].reshape(-1),
            i16_mode=cm["i16_mode"].reshape(-1),
            chroma_mode=cm["chroma_mode"].reshape(-1),
            luma_dc=cm["dc_blk"], part_mode=cm["part_mode"],
            mvd2=cm["mvd2"], mvd23=cm["mvd23"],
            is_i4=cm["is_i4_f"] if i4 else None,
            i4_modes=cm["i4_modes"] if i4 else None, refidx=cm["refidx"],
            two_refs=two_refs,
            two_refs_live=ref1_valid if two_refs else None)
    else:
        words, eff_qp = p_decisions_core(cm, slice_qp, mbw=mbw, mbh=mbh)
        total_bits = None
    # ---- deblock ----
    recon = (cm["recon_y"], cm["recon_u"], cm["recon_v"])
    if deblock:
        recon = p_deblock_core(
            *recon, cm["is_intra"], cm["nnz_l"],
            cm["mv4_grid"] if partitions else cm["mv_field"], eff_qp,
            cm["ref_grid"], mbw=mbw, mbh=mbh, two_refs=two_refs,
            a_off=a_off, b_off=b_off, cqpo=cqpo)
    stats = {"nr_sums": cm["nr_sums"], "skip": cm["skip_n"],
             "satd": cm["satd_cost"],
             "intra": cm["intra_n"], "i4": cm["i4_n"],
             "p16x8": cm["p16x8_n"], "p8x16": cm["p8x16_n"],
             "p8x8": cm["p8x8_n"],
             # co-located fields a later B frame reads (spatial direct)
             "mvf": cm["mv_field"], "mvf4": cm["mv4_grid"],
             "inter_mask": cm["inter_mask"]}
    return words, total_bits, recon, stats


# ------------------------------------------------------------ frame glue
@trace.spanned("entropy:decisions_to_host")
def decisions_to_host(decisions, qp_mb):
    """The decision and level tensors of `p_decisions_dict` (or of
    bframe.b_decisions_core) and the QP map as numpy arrays: the one
    device-to-host copy of a CABAC P or B frame."""
    d = {k: to_host(val, "decisions").numpy()
         for k, val in decisions.items()}
    return d, _host(qp_mb, np.int32, "decisions").reshape(-1)


@trace.spanned("entropy:cabac_finalize")
def cabac_finalize_pframe(enc, decisions, qp_mb, slice_qp, sh):
    """Host tail of a CABAC P frame: move the decision and level tensors
    to the host and run the C++ writer (csrc/cabac.cpp). The writer gets
    the per-MB QP the encoder chose (qp_mb), not the decoder-carried one:
    it derives mb_qp_delta itself."""
    mbw, mbh = enc.mb_w, enc.mb_h
    n = mbw * mbh
    d, qp_host = decisions_to_host(decisions, qp_mb)
    luma = d["luma_z"].astype(np.int16)[:, LUMA4x4_RASTER]  # z-scan order
    payload = encode_slice_cabac(
        False, mbw, mbh, slice_qp,
        d["skip"].astype(np.uint8), d["is_intra"].astype(np.uint8),
        d["i16_mode"].astype(np.uint8), d["chroma_mode"].astype(np.uint8),
        d["cbp_luma"], d["cbp_chroma"], qp_host,
        d["mvd"].astype(np.int16),
        d["luma_dc_z"].astype(np.int16), luma,
        d["cdc"].astype(np.int16), d["cac_z"].reshape(n, 8, 16),
        model=0, mvd1=d["mvd2"].astype(np.int16),
        part_mode=d["part_mode"].astype(np.uint8),
        is_i4=d["is_i4"].astype(np.uint8),
        i4_modes=d["i4_modes"].astype(np.uint8),
        refidx=d.get("refidx"), n_refs=sh.num_ref_idx_l0_active)
    sh.cabac_init_idc = 0
    return finalize_slice_cabac(enc, payload, sh, nal_mod.NAL_SLICE,
                                nal_mod.NAL_PRIORITY_HIGH)


def apply_ref_list_mod(enc, ref, sh):
    """Signal ref_pic_list_modification_l0 when the chosen reference is not
    the decoder's default list0[0], the most recent decoded reference."""
    last_fn = getattr(enc, "_last_ref_fn", None)
    if last_fn is None or ref.get("frame_num") == last_fn:
        return
    max_fn = 1 << enc.sps.log2_max_frame_num
    diff = (enc.frame_num - ref["frame_num"]) % max_fn
    if diff <= 0:
        return
    # op 0: subtract abs_diff_pic_num (= diff) from picNumPred
    sh.ref_pic_list_mod_l0 = [(0, diff - 1)]


def pir_maps(pir, mbw, mbh, device):
    """The periodic-intra-refresh tensors of one P frame from its geometry
    pir = (start_col, end_col, ref_end_col or None): the forced-intra
    column band [mbh, mbw] bool, and the cap on each MB's full-pel dx
    [mbh, mbw] int32, which keeps MBs left of the band (already refreshed)
    from reaching the reference's columns at or past its refreshed end
    (x264_tpu inter.dispatch_pframe)."""
    start_col, end_col, ref_end = pir
    cols = np.arange(mbw)
    band = (cols >= start_col) & (cols <= end_col)
    # stay left of the reference's refreshed boundary by the hpel taps (3
    # px), the subpel step (1 px) and rounding; no cap elsewhere, nor after
    # an I frame reference
    cap = np.full((mbw,), 1 << 20, np.int32)
    if ref_end is not None:
        lim = ref_end * 16 - cols * 16 - 16 - 5
        # no cap when the refresh bar is at or left of the MB itself; an
        # MB whose every offset is capped falls back to the forced intra
        guard = (ref_end * 16 - cols * 16 - 3) > 0
        cap = np.where((cols < start_col) & guard, lim, cap)
    band_t = to_device(np.ascontiguousarray(
        np.broadcast_to(band, (mbh, mbw))), device, "pir_maps")
    cap_t = to_device(np.ascontiguousarray(
        np.broadcast_to(cap, (mbh, mbw)).astype(np.int32)), device,
        "pir_maps")
    return band_t, cap_t


def dispatch_pframe(enc, planes, ftype, qp, ref_tag=None, tree_off=None,
                    pir=None):
    """Dispatch one P frame (CAVLC on the device, or CABAC through the
    host writer in finalize). planes: the encoder's padded planes
    (`Planes`, whose `host_luma` the weightp fit reads); pir: the periodic
    intra refresh geometry (start_col, end_col, ref_end_col or None) of
    Encoder._pir_advance, or None. Returns (finalize_fn, retry_fn(qp) ->
    (finalize, recon), recon_dev, ref_tag)."""
    if not enc._dpb:
        raise RuntimeError("P frame without reference")
    mbw, mbh = enc.mb_w, enc.mb_h
    if ref_tag is None:
        ref = enc._dpb[-1]
    else:   # re-dispatch after an overflow repair: the same reference
        ref = next(r for r in enc._dpb if r["tag"] == ref_tag)
    # the second L0 reference is the next most recent DPB entry (the
    # decoder's default list0[1]); none on the first P after an IDR, under
    # PIR, or when a ref-list modification re-points list0[0]
    ref1 = None
    two_refs = enc.n_refs >= 2 and pir is None
    if two_refs:
        ri = next(i for i, r in enumerate(enc._dpb) if r is ref)
        if ri >= 1:
            ref1 = enc._dpb[ri - 1]
    y, u, v = planes
    # the subpel windows need me_range <= PAD - 8
    me_range = min(enc.p.analyse.me_range, mc.PAD - 8)
    sh = enc._slice_header(ftype, qp, n_ref_l0=2 if ref1 is not None else 1)
    apply_ref_list_mod(enc, ref, sh)
    if sh.ref_pic_list_mod_l0 and ref1 is not None:
        ref1 = None
        sh.num_ref_idx_l0_active = 1
        sh.num_ref_idx_override = enc.pps.num_ref_idx_l0_active != 1
    ref1_valid = ref1 is not None
    # weighted prediction: fit against the reference's SOURCE luma, kept
    # on the host (a fit on the reconstruction would wait on the device)
    wp = None
    if enc.p.analyse.weighted_pred > 0:
        src_ref = getattr(enc, "_src_luma", {}).get(ref["tag"])
        if src_ref is not None:
            wp = weightp_analyse_host(planes.host_luma, src_ref)
        # reference 1 keeps implicit unity weights
        sh.weight_l0 = [wp] + ([None] if ref1_valid else [])
        if wp is not None:
            enc.stats["weightp_frames"] = \
                enc.stats.get("weightp_frames", 0) + 1
    materialize = (enc.p.analyse.psnr or enc.p.analyse.ssim
                   or enc.p.dump_yuv or enc.p.full_recon)
    refs = [ref, ref1] if ref1_valid else [ref]
    cabac = enc.p.cabac
    # trellis needs the slice-init CABAC flag / level costs, so it runs
    # under CABAC only
    use_trellis = bool(enc.p.analyse.trellis) and cabac
    partitions = bool(enc.p.analyse.inter & ANALYSE_PSUB16x16)

    def attempt(qp_try):
        qp_mb, qpc_mb = build_qp_maps(enc, y, u, v, qp_try, tree_off)
        # SAD/SATD-domain lambda
        lam = max(1, int(round(2.0 ** ((qp_try - 12) / 6.0))))
        cap_words = (mbw * mbh * cap_bytes_per_mb(qp_try)) // 4
        trl_tabs = (frame_ctx_costs(False, qp_try, cat=2) if use_trellis
                    else None)
        nr = int(getattr(enc.p.analyse, "noise_reduction", 0) or 0)
        if nr and not hasattr(enc, "_nr_state"):
            enc._nr_state = (np.zeros((4, 4), np.int64), 0,
                             np.zeros((4, 4), np.int32))
        nr_offset = (to_device(enc._nr_state[2], y.device, "nr_offset")
                     if nr else None)
        pir_band = pir_cap = None
        if pir is not None:
            pir_band, pir_cap = pir_maps(pir, mbw, mbh, y.device)
        words, total_bits, recon, stats = encode_pframe(
            y, u, v, refs, qp_mb, qpc_mb, qp_try, lam, wp, mbw=mbw, mbh=mbh,
            cap_words=cap_words, me_range=me_range,
            deblock=enc.p.deblocking_filter,
            a_off=enc.p.deblocking_filter_alphac0 * 2,
            b_off=enc.p.deblocking_filter_beta * 2,
            cqpo=enc.p.analyse.chroma_qp_offset,
            decimate=enc.p.analyse.dct_decimate,
            i4=bool(enc.p.analyse.intra & ANALYSE_I4x4), two_refs=two_refs,
            entropy=not cabac,
            # x264_tpu's CABAC writer has no sub_mb_type: no P_8x8 there
            p8x8=partitions and not cabac, trl_tabs=trl_tabs,
            me_seeded=enc.p.analyse.me_method <= 2,   # dia / hex / umh
            partitions=partitions, rd=enc.p.analyse.subpel_refine >= 7,
            pir_cap=pir_cap, pir_band=pir_band, nr_offset=nr_offset)
        enc._pending_ref_fields = {"mvf": stats["mvf"],
                                   "mvf4": stats["mvf4"],
                                   "inter_mask": stats["inter_mask"]}

        def finalize():
            sh.qp = qp_try
            if cabac:
                nals = cabac_finalize_pframe(enc, words, qp_mb, qp_try, sh)
            else:
                nals = finalize_slice(enc, words, total_bits, cap_words, sh,
                                      nal_mod.NAL_SLICE,
                                      nal_mod.NAL_PRIORITY_HIGH)
            rec = ([to_host(r, "recon").numpy() for r in recon]
                   if materialize else list(recon))
            with trace.span("encoder:ratecontrol"):
                enc.rc.end(ftype, sum(len(n.payload) * 8 for n in nals),
                           float(to_host(stats["satd"], "satd")), qp_try)
            if nr and stats["nr_sums"] is not None:
                # offset learning (x264_noise_reduction_update)
                s, c, _ = enc._nr_state
                off, s2, c2 = quant.nr_update(
                    nr, to_host(stats["nr_sums"], "nr_sums").numpy(),
                    16 * mbw * mbh, s, c)
                enc._nr_state = (s2, c2, off)
            # MB-mode histogram (encoder_close's stats block)
            mbs = enc.stats.setdefault("mb", {}).setdefault(
                "P", {"total": 0, "skip": 0, "intra": 0, "16x8": 0,
                      "8x16": 0, "8x8": 0})
            mbs["total"] += mbw * mbh
            for key, skey in (("skip", "skip"), ("intra", "intra"),
                              ("16x8", "p16x8"), ("8x16", "p8x16"),
                              ("8x8", "p8x8")):
                mbs[key] = mbs.get(key, 0) + int(to_host(stats[skey],
                                                         "mb_stats"))
            return nals, rec

        return finalize, list(recon)

    finalize, recon = attempt(qp)
    return finalize, attempt, recon, ref["tag"]


def weightp_analyse_host(y, ref_y):
    """Luma weight fit of a P frame against its reference's source plane,
    4x4 subsampled, on the host: (w, o) at denom 7, or None unless the
    weighted SAD beats the plain one by 2% (x264_tpu
    inter.weightp_analyse_host, a copy)."""
    c = y[::4, ::4].astype(np.float32)
    r = ref_y[::4, ::4].astype(np.float32)
    mcur = float(c.mean())
    mref = float(r.mean())
    cov = float(((c - mcur) * (r - mref)).mean())
    var = float(((r - mref) ** 2).mean())
    scale = cov / max(var, 1.0)
    w = int(round(scale * 128))
    o = int(round(mcur - (w / 128.0) * mref))
    if w == 128 and -1 <= o <= 1:
        return None
    w = max(-127, min(127, w))
    o = max(-128, min(127, o))
    ci = c.astype(np.int32)
    ri = r.astype(np.int32)
    rw = np.clip(((ri * w + 64) >> 7) + o, 0, 255)
    sad_u = int(np.abs(ci - ri).sum())
    sad_w = int(np.abs(ci - rw).sum())
    if sad_w * 100 >= sad_u * 98:          # demand a >=2% SAD win
        return None
    return (w, o)
