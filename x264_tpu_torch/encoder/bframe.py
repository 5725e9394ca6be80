"""B-frame encoding (x264_tpu/encoder/bframe.py): bidirectional prediction
with a per-MB list choice.

Both reference directions run the exhaustive full-pel search and the 16x16
quarter-pel refinement; the per-MB mode (L0 / L1 / BI) is the first minimum
over three SATD cost planes; B_Direct_16x16 is derived spatially from the
decided fields and adopted through a fixed-point loop (encoder/bdirect.py),
so the coded fields agree with the decoder's own derivation; B_Skip is
direct with no residual. The per-list MVP field then comes from one pass
over the final mode / MV fields.

Scope, as in x264_tpu: B_L0 / L1 / BI / Direct_16x16 and B_Skip, CAVLC on
the device or CABAC through the host writer, non-reference B frames (no
pyramid), one reference per list. A B frame has no intra MB, so it never
reaches the commit kernel.

`encode_bframe_device` is the whole per-frame pipeline on the planes'
device, in stages that are functions of this module: `motion_search` and
`subpel_refine_mc` per list, `b_direct_core`, `b_luma_core` (transform,
trellis, decimation, reconstruction), `b_chroma_core`, then
`encode_bframe_entropy_dev` or `b_decisions_core`, and `b_deblock_core`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import const
from ..entropy import nal as nal_mod
from ..entropy.cabac_host import encode_slice_cabac
from ..entropy.cavlc_dev import (LUMA4x4_RASTER, _carried_qp,
                                 encode_bframe_entropy_dev)
from ..ops import dct, mc, quant
from ..ops._cuda import to_device, to_host
from ..ops.commit import (_chroma_blocks, _chroma_merge, _luma_blocks,
                          _luma_merge)
from ..ops.deblock import compute_strengths_b, deblock_frame
from ..ops.tables import ZIGZAG4_FRAME
from ..ops.trellis import frame_ctx_costs, trellis_4x4
from ..utils import trace
from .bdirect import derive_direct, direct_pred_luma
from .encoder import TYPE_B
from .frame_encode import build_qp_maps
from .inter import (_decimate_score, _first_min, _median3, _merge_plane,
                    _satd16, _shift, chroma_mc_warp, decisions_to_host,
                    motion_search, subpel_refine_mc)
from .intra import (_mb_tiles, cap_bytes_per_mb, finalize_slice,
                    finalize_slice_cabac)

MODE_L0, MODE_L1, MODE_BI, MODE_DIRECT = 0, 1, 2, 3
_i32 = torch.int32


def implicit_weights(poc_cur: int, poc_l0: int, poc_l1: int):
    """Implicit weighted bipred (w0, w1) from POC distances (spec
    8.4.2.3.2). (32, 32) when the scale is out of range."""
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


def mv_predictors_b(mv_field, use_mask):
    """Per-list median MVP of 16x16 B partitions (spec 8.4.1.3).

    mv_field [mbh, mbw, 2]: each MB's list-X MV (anything where the list
    is unused); use_mask [mbh, mbw] bool: the MB uses list X. A neighbour
    that does not use list X counts as mv 0 / refIdx -1; when exactly one
    neighbour matches the reference, its MV is the predictor.
    Returns mvp [mbh, mbw, 2]."""
    mbh, mbw = use_mask.shape
    dev = use_mask.device
    col = torch.arange(mbw, device=dev)[None, :]
    row = torch.arange(mbh, device=dev)[:, None]
    avail_a = (col > 0).expand(mbh, mbw)
    avail_b = (row > 0).expand(mbh, mbw)
    avail_c0 = avail_b & (col < mbw - 1)
    avail_d = avail_a & avail_b

    mv_a = torch.where(avail_a[..., None], _shift(mv_field, 1, 0), 0)
    mv_b = torch.where(avail_b[..., None], _shift(mv_field, 0, 1), 0)
    use_a = avail_a & _shift(use_mask, 1, 0)
    use_b = avail_b & _shift(use_mask, 0, 1)
    # C, or D where C is unavailable (spec 8.4.1.3.2)
    mv_c = torch.where(avail_c0[..., None], _shift(mv_field, -1, 1),
                       torch.where(avail_d[..., None],
                                   _shift(mv_field, 1, 1), 0))
    use_c = torch.where(avail_c0, _shift(use_mask, -1, 1),
                        avail_d & _shift(use_mask, 1, 1))
    avail_c = avail_c0 | avail_d

    ca = torch.where(use_a[..., None], mv_a, 0)
    cb = torch.where(use_b[..., None], mv_b, 0)
    cc = torch.where(use_c[..., None], mv_c, 0)
    nmatch = use_a.to(_i32) + use_b.to(_i32) + use_c.to(_i32)
    only = torch.where(use_a[..., None], ca,
                       torch.where(use_b[..., None], cb, cc))
    mvp = torch.where((nmatch == 1)[..., None], only, _median3(ca, cb, cc))
    # only A of the three available: A's value, matching or not
    early = avail_a & ~avail_b & ~avail_c
    return torch.where(early[..., None], mv_a, mvp)


def _bipred(p0, p1, w0, w1):
    return ((p0 * w0 + p1 * w1 + 32) >> 6).clamp(0, 255)


@trace.spanned("analysis:direct")
def b_direct_core(use0_e, use1_e, mv0_e, mv1_e, col_inter, col_mv,
                  col_uniform, r0_hpel, r1_hpel, tiles, best_exp, w0, w1, *,
                  mbw, mbh, me_range):
    """Spatial direct: derive from the explicit fields, adopt where it
    costs no more, then shrink the adopted set to a fixed point, so that
    the decoder's derivation from the coded fields gives the MVs used
    here. Adoption only shrinks, so the loop ends within n rounds.
    Returns (is_dir [mbh, mbw], (use0, use1, mv0, mv1) final fields,
    pred_dir [n, 16, 16], cost_dir [n])."""
    n = mbw * mbh
    du0, du1, dm0, dm1 = derive_direct(use0_e, use1_e, mv0_e, mv1_e,
                                       col_inter, col_mv)
    bound = 4 * (me_range - 1)
    valid = ((dm0.abs().amax(-1) <= bound) & (dm1.abs().amax(-1) <= bound))
    pd0 = direct_pred_luma(r0_hpel, dm0.reshape(n, 2), mbh, mbw, me_range)
    pd1 = direct_pred_luma(r1_hpel, dm1.reshape(n, 2), mbh, mbw, me_range)
    du0f, du1f = du0.reshape(n), du1.reshape(n)
    pred_dir = torch.where((du0f & du1f)[:, None, None],
                           _bipred(pd0, pd1, w0, w1),
                           torch.where(du0f[:, None, None], pd0, pd1))
    cost_dir = _satd16(pred_dir, tiles)
    is_dir = valid & col_uniform & (cost_dir <= best_exp).reshape(mbh, mbw)

    def fields_of(isd):
        i3 = isd[..., None]
        return (torch.where(isd, du0, use0_e), torch.where(isd, du1, use1_e),
                torch.where(i3, dm0, mv0_e), torch.where(i3, dm1, mv1_e))

    for _ in range(n + 1):
        nd0, nd1, nm0, nm1 = derive_direct(*fields_of(is_dir), col_inter,
                                           col_mv)
        match = ((nd0 == du0) & (nd1 == du1) & (nm0 == dm0).all(-1)
                 & (nm1 == dm1).all(-1))
        new = is_dir & match
        changed = bool(to_host((new != is_dir).any(), "direct_converged"))
        is_dir = new
        if not changed:
            break
    return is_dir, fields_of(is_dir), pred_dir, cost_dir


@trace.spanned("analysis:luma_xfrm")
def b_luma_core(tiles, pred_y, qp, trl_tabs, *, decimate):
    """Luma transform and quant (with trl_tabs = frame_ctx_costs(False, qp,
    cat=2) the trellis), dct decimation and the reconstruction, as on the
    P path. Returns (lv [n, 16, 4, 4], recon_y_mb [n, 16, 16])."""
    n = tiles.shape[0]
    dev = tiles.device
    w = dct.dct4x4(_luma_blocks(tiles.to(_i32) - pred_y))
    lv = quant.quant4x4(w, qp[:, None], intra=False)
    if trl_tabs is not None:
        sig_c, last_c, lvl_s = trl_tabs
        out_z, _ = trellis_4x4(dct.zigzag4(lv).reshape(n * 16, 16),
                               dct.zigzag4(w).reshape(n * 16, 16),
                               qp.repeat_interleave(16), sig_c, last_c, lvl_s)
        lv = dct.izigzag4(out_z).reshape(n, 16, 4, 4)
    dec_score = (_decimate_score(dct.zigzag4(lv)) if decimate else
                 torch.full((n, 16), 99, dtype=_i32, device=dev))
    quad_of = [(r // 2) * 2 + (c // 2) for r in range(4) for c in range(4)]
    qsum = torch.stack([sum(dec_score[:, b] for b in range(16)
                            if quad_of[b] == q) for q in range(4)], dim=1)
    keep_quad = (qsum >= 4) & (qsum.sum(1) >= 6)[:, None]
    keep_blk = keep_quad[:, const(quad_of, dev, torch.int64)]
    lv = torch.where(keep_blk[:, :, None, None], lv, 0)
    dq = quant.dequant4x4(lv, qp[:, None])
    return lv, (pred_y + _luma_merge(dct.idct4x4(dq))).clamp(0, 255)


@trace.spanned("analysis:chroma")
def b_chroma_core(u, v, r0_cuv, r1_cuv, mvs, mode, fields, is_dir_flat, qpc,
                  w0, w1, *, mbw, mbh, use_direct):
    """Chroma MC per list, combined by mode, then transform, quant and
    reconstruction. Explicit MBs predict from the searched MVs `mvs`,
    direct MBs from the final fields. Returns ((udc, uac, urec), (vdc,
    vac, vrec))."""
    n = mbw * mbh
    pc0 = chroma_mc_warp(r0_cuv, mvs[0], mbh, mbw)
    pc1 = chroma_mc_warp(r1_cuv, mvs[1], mbh, mbw)

    def by_mode(m):
        return m[:, None, None, None]

    pred_c_all = torch.where(by_mode(mode == MODE_L0), pc0, torch.where(
        by_mode(mode == MODE_L1), pc1, _bipred(pc0, pc1, w0, w1)))
    if use_direct:
        use0_f, use1_f, mv0_f, mv1_f = fields
        pcd0 = chroma_mc_warp(r0_cuv, mv0_f.reshape(n, 2), mbh, mbw)
        pcd1 = chroma_mc_warp(r1_cuv, mv1_f.reshape(n, 2), mbh, mbw)
        du0f, du1f = use0_f.reshape(n), use1_f.reshape(n)
        pred_c_dir = torch.where(by_mode(du0f & du1f),
                                 _bipred(pcd0, pcd1, w0, w1),
                                 torch.where(by_mode(du0f), pcd0, pcd1))
        pred_c_all = torch.where(by_mode(is_dir_flat), pred_c_dir, pred_c_all)
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
    return out_c


@trace.spanned("entropy:decisions")
def b_decisions_core(mode, skip, mvd0, mvd1, cbp_luma, cbp_chroma, qp,
                     slice_qp, lv, cdc_blk, cac_blk):
    """CABAC path: the decoder-carried QP (the CAVLC writer's rule) and the
    decision and level tensors for the host C++ writer, still on the
    frame's device, narrowed to int16 / uint8 (lossless for 8-bit video).
    Returns (decisions, eff_qp)."""
    n = mode.shape[0]
    has_resid = ((cbp_luma > 0) | (cbp_chroma > 0)) & ~skip
    _, eff_qp = _carried_qp(has_resid, qp, slice_qp)
    zig = const(ZIGZAG4_FRAME, mode.device, torch.int64)
    i16, u8 = torch.int16, torch.uint8
    return {
        "mode": mode.to(u8), "skip": skip, "mvd0": mvd0.to(i16),
        "mvd1": mvd1.to(i16), "cbp_luma": cbp_luma.to(u8),
        "cbp_chroma": cbp_chroma.to(u8), "qp": qp.to(u8),
        "luma_z": lv.reshape(n, 16, 16)[:, :, zig].to(i16),
        "cdc": cdc_blk.reshape(n, 2, 4).to(i16),
        "cac_z": cac_blk.reshape(n, 2, 4, 16)[:, :, :, zig].to(i16),
    }, eff_qp


@trace.spanned("analysis:deblock")
def b_deblock_core(recon_y, recon_u, recon_v, nnz_l, fields, eff_qp, *, mbw,
                   mbh, a_off, b_off, cqpo):
    """In-loop deblock of a B frame: strengths from the final per-list
    fields, then the wavefront."""
    nnz4 = nnz_l.reshape(mbh, mbw, 4, 4).transpose(1, 2) \
        .reshape(mbh * 4, mbw * 4).to(_i32)
    bs_v, bs_h = compute_strengths_b(nnz4, *fields, mbw=mbw, mbh=mbh)
    return deblock_frame(recon_y, recon_u, recon_v, bs_v, bs_h,
                         eff_qp.reshape(mbh, mbw), mbw=mbw, mbh=mbh,
                         a_off=a_off, b_off=b_off, chroma_qp_offset=cqpo)


def encode_bframe_device(y, u, v, r0_y, r0_hpel, r0_cuv, r1_y, r1_hpel,
                         r1_cuv, qp_mb, qpc_mb, slice_qp, lam, w0, w1,
                         col_inter, col_mv, col_uniform, *, mbw, mbh,
                         cap_words, me_range, deblock=False, a_off=0,
                         b_off=0, cqpo=0, decimate=True, entropy=True,
                         use_direct=True, trellis=False, trl_tabs=None):
    """One B frame on the planes' device (x264_tpu
    bframe.encode_bframe_device). (w0, w1): the implicit bipred weights,
    host integers. col_inter / col_mv: the L1 anchor's co-located inter
    mask and MV field for spatial direct; col_uniform [mbh, mbw] marks the
    co-located MBs whose four 8x8-quadrant corner cells agree on
    colZeroFlag: direct and skip are chosen only there, so the whole-MB
    derivation equals the decoder's per-quadrant one.

    entropy=True codes CAVLC on the device; entropy=False (CABAC) returns
    the decision dict of `b_decisions_core` in place of the words, and
    total_bits None. Returns (words, total_bits, recon planes, stats)."""
    H, W = y.shape
    n = mbw * mbh
    dev = y.device

    preds, mvs = [], []
    for ry, rh in ((r0_y, r0_hpel), (r1_y, r1_hpel)):
        mv_c = motion_search(ry, rh, y, lam, me_range)
        mvq, pred, _ = subpel_refine_mc(rh, y, mv_c, lam, me_range)
        preds.append(pred)
        mvs.append(mvq)
    tiles = _mb_tiles(y, 16).reshape(n, 16, 16)
    pred_bi = _bipred(preds[0], preds[1], w0, w1)
    c0 = _satd16(preds[0], tiles)
    c1 = _satd16(preds[1], tiles)
    cbi = _satd16(pred_bi, tiles) + lam * 3      # a small bias for 2 MVs
    mode, best_exp = _first_min([c0, c1, cbi])
    pred_y = torch.where((mode == MODE_L0)[:, None, None], preds[0],
                         torch.where((mode == MODE_L1)[:, None, None],
                                     preds[1], pred_bi))

    # the explicit per-list fields (mv 0 where a list is unused)
    mode_f = mode.reshape(mbh, mbw)
    use0_e = mode_f != MODE_L1
    use1_e = mode_f != MODE_L0
    mv0_e = torch.where(use0_e[..., None], mvs[0].reshape(mbh, mbw, 2), 0)
    mv1_e = torch.where(use1_e[..., None], mvs[1].reshape(mbh, mbw, 2), 0)

    if use_direct:
        is_dir, fields, pred_dir, cost_dir = b_direct_core(
            use0_e, use1_e, mv0_e, mv1_e, col_inter, col_mv, col_uniform,
            r0_hpel, r1_hpel, tiles, best_exp, w0, w1, mbw=mbw, mbh=mbh,
            me_range=me_range)
        is_dir_flat = is_dir.reshape(n)
        mode = torch.where(is_dir_flat, MODE_DIRECT, mode).to(_i32)
        pred_y = torch.where(is_dir_flat[:, None, None], pred_dir, pred_y)
    else:
        fields = (use0_e, use1_e, mv0_e, mv1_e)
        is_dir_flat = torch.zeros((n,), dtype=torch.bool, device=dev)
    use0_f, use1_f, mv0_f, mv1_f = fields

    # per-list MVP over the decided fields
    mvd0 = (mv0_f - mv_predictors_b(mv0_f, use0_f)).reshape(n, 2)
    mvd1 = (mv1_f - mv_predictors_b(mv1_f, use1_f)).reshape(n, 2)

    qp = qp_mb.reshape(-1).to(_i32)
    lv, recon_y_mb = b_luma_core(tiles, pred_y, qp,
                                 trl_tabs if trellis else None,
                                 decimate=decimate)
    (udc, uac, urec), (vdc, vac, vrec) = b_chroma_core(
        u, v, r0_cuv, r1_cuv, mvs, mode, fields, is_dir_flat,
        qpc_mb.reshape(-1).to(_i32), w0, w1, mbw=mbw, mbh=mbh,
        use_direct=use_direct)

    # ---- cbp / skip ----
    nnz_l = (lv.reshape(n, 16, 16) != 0).sum(2, dtype=_i32)
    cbp_luma = torch.zeros((n,), dtype=_i32, device=dev)
    for qd in range(4):
        qy, qx = qd // 2, qd % 2
        qnnz = sum(nnz_l[:, (2 * qy + by) * 4 + (2 * qx + bx)]
                   for by in range(2) for bx in range(2))
        cbp_luma = cbp_luma + ((qnnz > 0).to(_i32) << qd)
    any_cac = ((uac.reshape(n, 64) != 0).sum(1)
               + (vac.reshape(n, 64) != 0).sum(1)) > 0
    any_cdc = ((udc.reshape(n, 4) != 0).sum(1)
               + (vdc.reshape(n, 4) != 0).sum(1)) > 0
    cbp_chroma = torch.where(any_cac, 2, torch.where(any_cdc, 1, 0)).to(_i32)
    # B_Skip: direct prediction with no residual
    skip = is_dir_flat & (cbp_luma == 0) & (cbp_chroma == 0)
    if use_direct:
        satd_cost = torch.where(is_dir_flat, cost_dir, best_exp) \
            .sum(dtype=_i32)
    else:
        satd_cost = best_exp.sum(dtype=_i32)

    u8 = torch.uint8
    recon = (_merge_plane(recon_y_mb, 16, H, W).to(u8),
             _merge_plane(urec, 8, H // 2, W // 2).to(u8),
             _merge_plane(vrec, 8, H // 2, W // 2).to(u8))
    cdc_blk = torch.stack([udc.reshape(n, 2, 2), vdc.reshape(n, 2, 2)], dim=1)
    cac_blk = torch.stack([uac.reshape(n, 4, 4, 4), vac.reshape(n, 4, 4, 4)],
                          dim=1)
    if entropy:
        words, total_bits, eff_qp = encode_bframe_entropy_dev(
            mode, mvd0, mvd1, cbp_luma, cbp_chroma, qp, slice_qp,
            lv.reshape(n, 16, 4, 4), cdc_blk, cac_blk, mbw=mbw, mbh=mbh,
            cap_words=cap_words, skip=skip)
    else:
        words, eff_qp = b_decisions_core(mode, skip, mvd0, mvd1, cbp_luma,
                                         cbp_chroma, qp, slice_qp, lv,
                                         cdc_blk, cac_blk)
        total_bits = None
    if deblock:
        recon = b_deblock_core(*recon, nnz_l, fields, eff_qp, mbw=mbw,
                               mbh=mbh, a_off=a_off, b_off=b_off, cqpo=cqpo)
    stats = {"satd": satd_cost, "skip": skip.sum(),
             "direct": is_dir_flat.sum(),
             "l0": (mode == MODE_L0).sum(), "l1": (mode == MODE_L1).sum(),
             "bi": (mode == MODE_BI).sum()}
    return words, total_bits, tuple(recon), stats


@trace.spanned("entropy:cabac_finalize")
def cabac_finalize_bframe(enc, decisions, qp_mb, slice_qp, sh):
    """Host tail of a CABAC B frame: move the decision and level tensors
    to the host (one copy, inter.decisions_to_host) and run the C++
    writer's B branch (csrc/cabac.cpp). The
    writer gets the per-MB QP the encoder chose (qp_mb): it derives
    mb_qp_delta itself."""
    mbw, mbh = enc.mb_w, enc.mb_h
    n = mbw * mbh
    d, qp_host = decisions_to_host(decisions, qp_mb)
    luma = d["luma_z"].astype(np.int16)[:, LUMA4x4_RASTER]
    payload = encode_slice_cabac(
        1, mbw, mbh, slice_qp,
        d["skip"].astype(np.uint8), np.zeros(n, np.uint8),
        np.zeros(n, np.uint8), np.zeros(n, np.uint8),
        d["cbp_luma"], d["cbp_chroma"], qp_host,
        d["mvd0"].astype(np.int16),
        np.zeros((n, 16), np.int16), luma,
        d["cdc"].astype(np.int16), d["cac_z"].reshape(n, 8, 16),
        model=0, bmode=d["mode"], mvd1=d["mvd1"].astype(np.int16))
    sh.cabac_init_idc = 0
    return finalize_slice_cabac(enc, payload, sh, nal_mod.NAL_SLICE,
                                nal_mod.NAL_PRIORITY_DISPOSABLE)


def colocated_fields(ref1, mbw, mbh, device):
    """(col_inter, col_mv, col_uniform) of the L1 anchor `ref1` (a DPB
    entry) for spatial direct. An anchor without fields gives none: no MB
    inter, zero MVs, every MB uniform. With `mvf4` (a P anchor with
    partitions) an MB is uniform when the corner cells of its four 8x8
    quadrants (direct_8x8_inference) agree on colZeroFlag."""
    col_inter, col_mv = ref1.get("inter_mask"), ref1.get("mvf")
    ones = torch.ones((mbh, mbw), dtype=torch.bool, device=device)
    if col_inter is None or col_mv is None:
        return (torch.zeros((mbh, mbw), dtype=torch.bool, device=device),
                torch.zeros((mbh, mbw, 2), dtype=_i32, device=device), ones)
    col_inter = to_device(col_inter, device, "colocated")
    col_mv = to_device(col_mv, device, "colocated")
    col_mv4 = ref1.get("mvf4")
    if col_mv4 is None:                     # 16x16 only: always uniform
        return col_inter, col_mv, ones
    c4 = to_device(col_mv4, device, "colocated").reshape(mbh, 4, mbw, 4, 2)
    corners = torch.stack([c4[:, cy, :, cx] for cy, cx in
                           ((0, 0), (0, 3), (3, 0), (3, 3))], dim=2)
    cz = (corners[..., 0].abs() <= 1) & (corners[..., 1].abs() <= 1)
    return col_inter, col_mv, (cz == cz[..., :1]).all(-1)


def dispatch_bframe(enc, planes, qp, ref_fwd_tag, ref_bwd_tag):
    """Dispatch one non-reference B frame between the DPB entries tagged
    ref_fwd_tag (list 0) and ref_bwd_tag (list 1). Returns (finalize_fn,
    retry_fn(qp) -> (finalize, None), None, ref_fwd_tag): a B frame leaves
    no reconstruction in the DPB."""
    mbw, mbh = enc.mb_w, enc.mb_h
    ref0 = next(r for r in enc._dpb if r["tag"] == ref_fwd_tag)
    ref1 = next(r for r in enc._dpb if r["tag"] == ref_bwd_tag)
    y, u, v = planes
    me_range = min(enc.p.analyse.me_range, mc.PAD - 8)
    if enc.pps.weighted_bipred_idc == 2:
        w0, w1 = implicit_weights(enc.poc, ref0["poc"], ref1["poc"])
    else:
        w0, w1 = 32, 32
    use_direct = enc.p.analyse.direct_mv_pred != 0
    col_inter, col_mv, col_uniform = colocated_fields(ref1, mbw, mbh,
                                                      y.device)
    sh = enc._slice_header(TYPE_B, qp)
    materialize = (enc.p.analyse.psnr or enc.p.analyse.ssim
                   or enc.p.dump_yuv or enc.p.full_recon)
    cabac = enc.p.cabac
    use_trellis = bool(enc.p.analyse.trellis) and cabac

    def attempt(qp_try):
        qp_mb, qpc_mb = build_qp_maps(enc, y, u, v, qp_try)
        lam = max(1, int(round(2.0 ** ((qp_try - 12) / 6.0))))
        cap_words = (mbw * mbh * cap_bytes_per_mb(qp_try)) // 4
        trl_tabs = (frame_ctx_costs(False, qp_try, cat=2) if use_trellis
                    else None)
        words, total_bits, recon, stats = encode_bframe_device(
            y, u, v, ref0["y_pad"], ref0["hpel"], ref0["cuv_pad"],
            ref1["y_pad"], ref1["hpel"], ref1["cuv_pad"], qp_mb, qpc_mb,
            qp_try, lam, w0, w1, col_inter, col_mv, col_uniform, mbw=mbw,
            mbh=mbh, cap_words=cap_words, me_range=me_range,
            decimate=enc.p.analyse.dct_decimate,
            deblock=enc.p.deblocking_filter,
            a_off=enc.p.deblocking_filter_alphac0 * 2,
            b_off=enc.p.deblocking_filter_beta * 2,
            cqpo=enc.p.analyse.chroma_qp_offset, entropy=not cabac,
            use_direct=use_direct, trellis=use_trellis, trl_tabs=trl_tabs)

        def finalize():
            sh.qp = qp_try
            if cabac:
                nals = cabac_finalize_bframe(enc, words, qp_mb, qp_try, sh)
            else:
                nals = finalize_slice(enc, words, total_bits, cap_words, sh,
                                      nal_mod.NAL_SLICE,
                                      nal_mod.NAL_PRIORITY_DISPOSABLE)
            rec = ([to_host(r, "recon").numpy() for r in recon]
                   if materialize else list(recon))
            with trace.span("encoder:ratecontrol"):
                enc.rc.end(TYPE_B, sum(len(n.payload) * 8 for n in nals),
                           float(to_host(stats["satd"], "satd")), qp_try)
            # MB-mode histogram of B frames
            mbs = enc.stats.setdefault("mb", {}).setdefault(
                "B", {"total": 0, "l0": 0, "l1": 0, "bi": 0, "direct": 0,
                      "skip": 0})
            mbs["total"] += mbw * mbh
            for key in ("l0", "l1", "bi", "direct", "skip"):
                mbs[key] += int(to_host(stats[key], "mb_stats"))
            return nals, rec

        return finalize, None            # non-reference: no DPB entry

    finalize, _ = attempt(qp)
    return finalize, attempt, None, ref_fwd_tag
