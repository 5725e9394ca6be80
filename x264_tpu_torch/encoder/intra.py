"""Intra (I) frame encoding (x264_tpu/encoder/intra.py).

One pipeline function per frame and entropy coder, on the frame's device
(`encode_iframe` for CAVLC, `analyze_iframe` for CABAC):

  1. DECIDE: per-MB I16x16 / chroma / I_4x4 mode costs against SOURCE
     neighbours (the two-phase approximation), at a per-MB lambda.
  2. COMMIT: exact reconstruction along MB anti-diagonals
     (ops/commit.commit: the CUDA kernel on a card, commit_ref on the CPU).
  3. ENTROPY: CAVLC code generation and bit packing on the device
     (entropy/cavlc_dev.encode_i16x16_frame_dev), or for CABAC the
     decoder-carried QP chain and the zigzag packing
     (`i_stage_pack_cabac`) for the host C++ writer
     (entropy/cabac_host.encode_slice_cabac, run in finalize).
  4. DEBLOCK: all-intra strengths (ops/deblock.deblock_frame).

The slice header, NAL wrapping and rate control run on the host, through
the port's copies of x264_tpu's host modules.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import const
from ..entropy import nal as nal_mod
from ..entropy.bits import BitWriter, append_bitstring
from ..entropy.cabac_host import encode_slice_cabac
from ..entropy.cavlc_dev import (LUMA4x4_RASTER, encode_i16x16_frame_dev,
                                 words_to_bytes)
from ..entropy.slice_hdr import slice_header_write
from ..ops import pixel, predict
from ..ops._cuda import to_host
from ..ops.commit import _i4_block_avail, commit
from ..ops.deblock import deblock_frame, intra_strengths
from ..ops.tables import ZIGZAG4_FRAME
from ..params import ANALYSE_I4x4
from ..utils import trace
from .encoder import TYPE_IDR
from .frame_encode import build_qp_maps


def _mb_tiles(plane, s):
    """[H, W] -> [mbh, mbw, s, s]"""
    h, w = plane.shape
    return plane.reshape(h // s, s, w // s, s).transpose(1, 2)


def mb_lambda(qp_mb):
    """Per-MB lambda max(1, round(2 ** ((qp - 12) / 6))) in float32, as
    the JAX pipeline computes it."""
    x = (qp_mb.to(torch.int32) - 12).to(torch.float32) / 6.0
    return torch.round(torch.pow(2.0, x)).clamp(min=1).to(torch.int32)


# ---------------------------------------------------------------- decision
def decide_modes_full(y, u, v, lam=None):
    """Batched I16x16 + chroma mode decision from source neighbours.

    lam: optional per-MB (or scalar) lambda; each candidate then carries
    lambda * its mode-signalling bits. Returns (i16_mode [mbh, mbw],
    chroma_mode [mbh, mbw], satd_total, luma_cost [mbh, mbw])."""
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    dev = y.device

    def neighbors(plane, s):
        t = _mb_tiles(plane, s)
        top = torch.roll(t[:, :, s - 1, :], 1, dims=0)
        left = torch.roll(t[:, :, :, s - 1], 1, dims=1)
        tl = torch.roll(torch.roll(t[:, :, s - 1, s - 1], 1, 0), 1, 1)
        return t, top, left, tl

    at = (torch.arange(mbh, device=dev)[:, None] > 0).expand(mbh, mbw)
    al = (torch.arange(mbw, device=dev)[None, :] > 0).expand(mbh, mbw)
    ue = const(np.array([1, 3, 3, 5]), dev)
    lam_t = None if lam is None else torch.as_tensor(lam, device=dev)

    ty, top_y, left_y, tl_y = neighbors(y, 16)
    preds = predict.predict_16x16_all(left_y, top_y, tl_y, al, at)
    costs = pixel.satd(preds, ty[:, :, None])                 # [mbh,mbw,4]
    if lam_t is not None:
        costs = costs + lam_t[..., None] * ue
    valid = predict.predict_16x16_mode_valid(al, at, at & al)
    costs = torch.where(valid, costs, 1 << 28)
    i16_mode = torch.argmin(costs, dim=-1).to(torch.int32)

    tu, top_u, left_u, tl_u = neighbors(u, 8)
    tv, top_v, left_v, tl_v = neighbors(v, 8)
    pu = predict.predict_chroma_all(left_u, top_u, tl_u, al, at)
    pv = predict.predict_chroma_all(left_v, top_v, tl_v, al, at)
    ccosts = pixel.satd(pu, tu[:, :, None]) + pixel.satd(pv, tv[:, :, None])
    if lam_t is not None:
        ccosts = ccosts + lam_t[..., None] * ue
    cvalid = predict.predict_chroma_mode_valid(al, at, at & al)
    ccosts = torch.where(cvalid, ccosts, 1 << 28)
    chroma_mode = torch.argmin(ccosts, dim=-1).to(torch.int32)
    best = costs.min(dim=-1).values
    satd_cost = (best.sum(dtype=torch.int32)
                 + ccosts.min(dim=-1).values.sum(dtype=torch.int32))
    return i16_mode, chroma_mode, satd_cost, best


def _kind_grid():
    kind = np.zeros((4, 4), np.int32)     # 0 none, 1 lane (at), 2 real
    for bx in range(4):
        for by in range(4):
            kind[by, bx] = {"none": 0, "lane": 1,
                            "real": 2}[_i4_block_avail(bx, by)]
    return kind


_KIND4 = _kind_grid()
_BAN4 = np.zeros((4, 4, 9), bool)
# block (3, 0) may not use DDL / VL: its real above-right pixels live in
# the above-right MB, which is on the same wavefront diagonal
_BAN4[0, 3, 3] = _BAN4[0, 3, 7] = True


def decide_modes_i4(y, lam=None):
    """Batched I4x4 mode decision from SOURCE neighbours.

    lam: optional per-MB [mbh, mbw] (or scalar) lambda; when given, modes
    other than the most probable one (from first-pass neighbour winners)
    cost +3 lambda, and the MB cost gains the lambda * 40 I_4x4 base.
    Returns (modes [mbh, mbw, 16] raster-block spec modes, cost [mbh, mbw])."""
    H, W = y.shape
    dev = y.device
    mbh, mbw = H // 16, W // 16
    H4, W4 = mbh * 4, mbw * 4
    yi = y.to(torch.int32)
    blocks = _mb_tiles(yi, 4)                            # [H4, W4, 4, 4]
    r4 = torch.arange(4, device=dev)
    by4 = torch.arange(H4, device=dev)[:, None]
    bx4 = torch.arange(W4, device=dev)[None, :]
    # edge-replicated neighbours: clamped-index gathers
    row_above = (by4 * 4 - 1).clamp(0, H - 1)                       # [H4,1]
    col_left = (bx4 * 4 - 1).clamp(0, W - 1)                        # [1,W4]
    top8 = yi[row_above[..., None],
              (bx4[..., None] * 4 + torch.arange(8, device=dev))
              .clamp(0, W - 1)]                                     # [H4,W4,8]
    left4 = yi[by4[..., None] * 4 + r4, col_left[..., None]]        # [H4,W4,4]
    tl = yi[row_above, col_left]
    al = (bx4 > 0).expand(H4, W4)
    at = (by4 > 0).expand(H4, W4)
    kind_g = const(np.tile(_KIND4, (mbh, mbw)), dev)
    tr_ok = torch.where(kind_g == 2, True, torch.where(kind_g == 1, at, False))
    top8 = torch.cat([top8[..., :4], torch.where(
        tr_ok[..., None], top8[..., 4:], top8[..., 3:4])], dim=-1)
    preds = predict.predict_4x4_all(left4, top8, tl, al, at)  # [H4,W4,9,4,4]
    costs = pixel.satd(preds, blocks[:, :, None])             # [H4,W4,9]
    valid = predict.predict_4x4_mode_valid(al, at, al & at)
    valid = valid & ~const(np.tile(_BAN4, (mbh, mbw, 1)), dev, torch.bool)
    costs = torch.where(valid, costs, 1 << 28)
    if lam is not None:
        lam_mb = torch.as_tensor(lam, device=dev) * torch.ones(
            (mbh, mbw), dtype=torch.int32, device=dev)
        lam4 = lam_mb.repeat_interleave(4, 0).repeat_interleave(4, 1)
        modes0 = torch.argmin(costs, dim=-1).to(torch.int32)
        lm = torch.where(al, torch.roll(modes0, 1, dims=1), 2)
        tm = torch.where(at, torch.roll(modes0, 1, dims=0), 2)
        mpm = torch.where(al & at, torch.minimum(lm, tm), 2)
        ar9 = torch.arange(9, device=dev)
        costs = costs + torch.where(ar9 == mpm[..., None], 0,
                                    3 * lam4[..., None])
    modes = torch.argmin(costs, dim=-1).to(torch.int32)
    best = costs.min(dim=-1).values
    modes_mb = modes.reshape(mbh, 4, mbw, 4).permute(0, 2, 1, 3) \
        .reshape(mbh, mbw, 16)
    cost_mb = best.reshape(mbh, 4, mbw, 4).permute(0, 2, 1, 3) \
        .reshape(mbh, mbw, 16).sum(-1, dtype=torch.int32)
    if lam is not None:
        cost_mb = cost_mb + 40 * lam_mb
    return modes_mb, cost_mb


# ---------------------------------------------------------------- pipeline
def decide_iframe(y, u, v, qp_mb, *, i4):
    """Mode decision at the per-MB lambda. Returns (i16_mode, chroma_mode,
    satd_cost, i4_mask, i4_modes); i4_mask / i4_modes are None without
    i4."""
    lam = mb_lambda(qp_mb)
    i16_mode, chroma_mode, satd_cost, i16_cost = decide_modes_full(
        y, u, v, lam=lam)
    i4_mask = i4_modes = None
    if i4:
        i4_modes, i4_cost = decide_modes_i4(y, lam=lam)
        i4_mask = i4_cost < i16_cost
    return i16_mode, chroma_mode, satd_cost, i4_mask, i4_modes


def iframe_commit_inputs(y, u, v, qp_mb, qpc_mb, modes, *, mbw, mbh):
    """(args, kwargs) of an I frame's commit (ops/commit.commit) from
    `decide_iframe`'s modes."""
    i16_mode, chroma_mode, _, i4_mask, i4_modes = modes
    return ((y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh),
            dict(i4_mask=i4_mask, i4_modes=i4_modes))


def _decide_commit(y, u, v, qp_mb, qpc_mb, *, mbw, mbh, i4):
    """Mode decision at the per-MB lambda, then the wavefront commit.
    Returns (i16_mode, chroma_mode, satd_cost, i4_mask, i4_modes, coeffs,
    recon); i4_mask / i4_modes are None without i4."""
    modes = decide_iframe(y, u, v, qp_mb, i4=i4)
    args, kw = iframe_commit_inputs(y, u, v, qp_mb, qpc_mb, modes, mbw=mbw,
                                    mbh=mbh)
    coeffs, recon = commit(*args, **kw)
    return (*modes, coeffs, recon)


def _deblock_intra(recon, eff_qp, *, mbw, mbh, a_off, b_off, cqpo):
    """All-intra in-loop deblock (MB edges strong) at the decoder's QPs."""
    bs_v, bs_h = intra_strengths(mbw, mbh, recon[0].device)
    return deblock_frame(*recon, bs_v, bs_h, eff_qp.reshape(mbh, mbw),
                         mbw=mbw, mbh=mbh, a_off=a_off, b_off=b_off,
                         chroma_qp_offset=cqpo)


def encode_iframe(y, u, v, qp_mb, qpc_mb, slice_qp, *, mbw, mbh, cap_words,
                  deblock=False, a_off=0, b_off=0, cqpo=0, i4=False):
    """One CAVLC I frame on the planes' device: decide -> commit -> CAVLC
    -> deblock. i4 adds the per-MB I_4x4 candidate (I16x16 vs I_4x4 by SATD
    plus mode-bit costs at the per-MB lambda).
    Returns (words, total_bits, recon planes, satd_cost)."""
    (*modes, coeffs, recon) = _decide_commit(y, u, v, qp_mb, qpc_mb,
                                             mbw=mbw, mbh=mbh, i4=i4)
    return iframe_cavlc_tail(modes, coeffs, recon, qp_mb, slice_qp, mbw=mbw,
                             mbh=mbh, cap_words=cap_words, deblock=deblock,
                             a_off=a_off, b_off=b_off, cqpo=cqpo)


def iframe_cavlc_tail(modes, coeffs, recon, qp_mb, slice_qp, *, mbw, mbh,
                      cap_words, deblock=False, a_off=0, b_off=0, cqpo=0):
    """What follows an I frame's commit on the CAVLC path: the device
    CAVLC, then the deblock. modes: `decide_iframe`'s; coeffs, recon: the
    commit's. Returns (words, total_bits, recon planes, satd_cost)."""
    i16_mode, chroma_mode, satd_cost, i4_mask, i4_modes = modes
    words, total_bits, eff_qp = encode_i16x16_frame_dev(
        i16_mode.reshape(-1), chroma_mode.reshape(-1), qp_mb.reshape(-1),
        slice_qp, coeffs["dc"], coeffs["ac"],
        torch.stack([coeffs["udc"], coeffs["vdc"]], dim=1),
        torch.stack([coeffs["uac"], coeffs["vac"]], dim=1),
        mbw=mbw, mbh=mbh, cap_words=cap_words,
        is_i4=None if i4_mask is None else i4_mask.reshape(-1),
        i4_modes=None if i4_modes is None else i4_modes.reshape(-1, 16))
    if deblock:
        recon = _deblock_intra(recon, eff_qp, mbw=mbw, mbh=mbh, a_off=a_off,
                               b_off=b_off, cqpo=cqpo)
    return words, total_bits, recon, satd_cost


def i_stage_pack_cabac(coeffs, i4_mask, qp_mb, slice_qp, *, mbw, mbh):
    """Decoder-carried QP chain and zigzag packing for the host CABAC
    writer: mb_qp_delta is always coded for I16x16 MBs and only with
    residual for I_4x4 MBs, so an I_4x4 MB without residual keeps the QP
    of the last MB that coded one.
    Returns (dc_z [n,16], ac_z [n,16,16], cdc [n,2,4], cac [n,2,4,16],
    eff_qp [n])."""
    n = mbw * mbh
    dev = qp_mb.device
    qp_flat = qp_mb.reshape(-1)
    luma_any = (coeffs["ac"].reshape(n, -1) != 0).any(1)
    chroma_any = ((coeffs["udc"].reshape(n, -1) != 0).any(1)
                  | (coeffs["vdc"].reshape(n, -1) != 0).any(1)
                  | (coeffs["uac"].reshape(n, -1) != 0).any(1)
                  | (coeffs["vac"].reshape(n, -1) != 0).any(1))
    has_dqp = (~i4_mask.reshape(-1)) | luma_any | chroma_any
    idxs = torch.arange(n, dtype=torch.int32, device=dev)
    last_d = torch.cummax(torch.where(has_dqp, idxs, -1), 0).values
    prev_d = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev),
                        last_d[:-1]])
    prev_qp = torch.where(prev_d >= 0, qp_flat[prev_d.clamp(min=0).long()],
                          slice_qp)
    eff_qp = torch.where(has_dqp, qp_flat, prev_qp)
    zig = const(ZIGZAG4_FRAME, dev, torch.int64)
    dc_z = coeffs["dc"].reshape(n, 16)[:, zig]
    ac_z = coeffs["ac"].reshape(n, 16, 16)[:, :, zig]
    cdc = torch.stack([coeffs["udc"], coeffs["vdc"]], dim=1).reshape(n, 2, 4)
    cac = torch.stack([coeffs["uac"], coeffs["vac"]],
                      dim=1).reshape(n, 2, 4, 16)[:, :, :, zig]
    return dc_z, ac_z, cdc, cac, eff_qp


def analyze_iframe(y, u, v, qp_mb, qpc_mb, slice_qp, *, mbw, mbh,
                   deblock=False, a_off=0, b_off=0, cqpo=0, i4=False):
    """One CABAC I frame on the planes' device: decide -> commit -> QP
    chain and level packing -> deblock (x264_tpu
    intra.analyze_iframe_staged). Returns (i16_mode [n], chroma_mode [n],
    dc_z, ac_z, cdc, cac, recon planes, satd_cost, is_i4 [n],
    i4_modes [n, 16])."""
    n = mbw * mbh
    (i16_mode, chroma_mode, satd_cost, i4_mask, i4_modes, coeffs,
     recon) = _decide_commit(y, u, v, qp_mb, qpc_mb, mbw=mbw, mbh=mbh, i4=i4)
    if not i4:
        i4_mask = torch.zeros((mbh, mbw), dtype=torch.bool, device=y.device)
        i4_modes = torch.zeros((mbh, mbw, 16), dtype=torch.int32,
                               device=y.device)
    dc_z, ac_z, cdc, cac, eff_qp = i_stage_pack_cabac(
        coeffs, i4_mask, qp_mb, slice_qp, mbw=mbw, mbh=mbh)
    if deblock:
        recon = _deblock_intra(recon, eff_qp, mbw=mbw, mbh=mbh, a_off=a_off,
                               b_off=b_off, cqpo=cqpo)
    return (i16_mode.reshape(-1), chroma_mode.reshape(-1), dc_z, ac_z, cdc,
            cac, recon, satd_cost, i4_mask.reshape(-1),
            i4_modes.reshape(n, 16))


# ------------------------------------------------------------- frame entry
CAP_BYTES_PER_MB = 450    # device payload buffer budget (checked on host)


def cap_bytes_per_mb(qp: int) -> int:
    """Per-MB payload budget by QP (noise frames at low QP run to ~3700
    bits/MB; the budget must exceed that or every frame would take the
    overflow re-encode path)."""
    if qp >= 16:
        return CAP_BYTES_PER_MB
    if qp >= 8:
        return 2 * CAP_BYTES_PER_MB
    return 3 * CAP_BYTES_PER_MB


def aud_nal(ftype):
    """Access unit delimiter (spec 7.3.1)."""
    bw = BitWriter()
    # primary_pic_type: 0 = I only, 1 = I+P
    bw.write(3, 0 if ftype in (TYPE_IDR,) else 1)
    bw.rbsp_trailing()
    return nal_mod.nal_encode(nal_mod.NAL_AUD,
                              nal_mod.NAL_PRIORITY_DISPOSABLE,
                              bw.getvalue())


class PayloadOverflow(Exception):
    """Device CAVLC buffer overflow: the caller re-encodes at a higher QP
    (reference encoder.c:2893-2902)."""


@trace.spanned("entropy:finalize_slice")
def finalize_slice(enc, words, total_bits, cap_words, sh, nal_type,
                   ref_idc):
    """Host tail of a frame: fetch the payload, append it to the slice
    header, wrap it in a NAL. `words` and `total_bits` are the device's
    (tensors, read here) or already on the host (numpy, an int)."""
    if isinstance(total_bits, torch.Tensor):
        total_bits = to_host(total_bits, "slice_bits")
    total_bits = int(total_bits)
    if total_bits > cap_words * 32 - 32:
        raise PayloadOverflow(f"{total_bits} bits > cap")
    n_words = (total_bits + 31) // 32
    words = words[:n_words]
    if isinstance(words, torch.Tensor):
        words = to_host(words, "slice_words").numpy()
    payload, nbits = words_to_bytes(words, total_bits)
    bw = slice_header_write(sh, ref_idc)
    append_bitstring(bw, payload, nbits)
    bw.rbsp_trailing()
    return [nal_mod.nal_encode(nal_type, ref_idc, bw.getvalue())]


def finalize_slice_cabac(enc, payload: bytes, sh, nal_type, ref_idc):
    """Slice header + cabac_alignment_one_bits + CABAC payload -> NAL."""
    bw = slice_header_write(sh, ref_idc)
    bw.byte_align_one()
    bw.extend_bytes(payload)
    return [nal_mod.nal_encode(nal_type, ref_idc, bw.getvalue())]


def _host(t, dtype, site):
    """A device tensor as a numpy array of `dtype` (one copy to the host,
    the wait traced as "sync:<site>")."""
    return to_host(t, site).numpy().astype(dtype, copy=False)


@trace.spanned("entropy:cabac_finalize")
def cabac_finalize_iframe(enc, mode_m, mode_c, dc_z, ac_z, cdc, cac,
                          qp_mb, slice_qp, sh, nal_type, ref_idc, is_i4,
                          i4_modes):
    """Host tail of a CABAC I frame: move the levels to the host, run the
    C++ writer. The writer gets the per-MB QP the encoder chose (qp_mb),
    not the decoder-carried one: it derives mb_qp_delta itself."""
    mbw, mbh = enc.mb_w, enc.mb_h
    n = mbw * mbh
    site = "cabac_levels"
    # blocks raster in tensors -> z-scan coding order for the writer
    ac = _host(ac_z, np.int16, site)[:, LUMA4x4_RASTER]
    cacn = _host(cac, np.int16, site)
    cdcn = _host(cdc, np.int16, site)
    cbp_luma = np.where((ac[:, :, 1:] != 0).any(axis=(1, 2)), 15, 0)
    is_i4 = _host(is_i4, np.uint8, site)
    # I4 MBs: per-8x8-quad cbp over the full 16-coeff blocks
    # (z-scan groups 4 consecutive blocks per quad)
    quad_nz = (ac != 0).any(axis=2).reshape(n, 4, 4).any(axis=2)
    cbp_i4 = (quad_nz.astype(np.int32) << np.arange(4)[None, :]).sum(axis=1)
    cbp_luma = np.where(is_i4 > 0, cbp_i4, cbp_luma)
    any_cac = (cacn[:, :, :, 1:] != 0).any(axis=(1, 2, 3))
    any_cdc = (cdcn != 0).any(axis=(1, 2))
    cbp_chroma = np.where(any_cac, 2, np.where(any_cdc, 1, 0))
    payload = encode_slice_cabac(
        True, mbw, mbh, slice_qp,
        np.zeros(n, np.uint8), np.ones(n, np.uint8),
        _host(mode_m, np.int32, site), _host(mode_c, np.int32, site),
        cbp_luma, cbp_chroma, _host(qp_mb, np.int32, site).reshape(-1),
        np.zeros((n, 2), np.int16),
        _host(dc_z, np.int16, site), ac, cdcn,
        cacn.reshape(n, 8, 16),
        is_i4=is_i4, i4_modes=_host(i4_modes, np.uint8, site))
    return finalize_slice_cabac(enc, payload, sh, nal_type, ref_idc)


def dispatch_iframe(enc, planes, ftype, qp, tree_off=None):
    """Dispatch a full I frame: the device pipeline now, the host tail
    (CAVLC payload fetch, or the C++ CABAC writer) in finalize. Returns
    (finalize_fn, retry_fn(qp) -> (finalize_fn, recon), recon_device,
    None)."""
    mbw, mbh = enc.mb_w, enc.mb_h
    y, u, v = planes
    sh = enc._slice_header(ftype, qp)
    nal_type = (nal_mod.NAL_SLICE_IDR if ftype == TYPE_IDR
                else nal_mod.NAL_SLICE)
    materialize = (enc.p.analyse.psnr or enc.p.analyse.ssim
                   or enc.p.dump_yuv or enc.p.full_recon)
    cabac = enc.p.cabac

    def attempt(qp_try):
        qp_mb, qpc_mb = build_qp_maps(enc, y, u, v, qp_try, tree_off)
        kw = dict(mbw=mbw, mbh=mbh, deblock=enc.p.deblocking_filter,
                  a_off=enc.p.deblocking_filter_alphac0 * 2,
                  b_off=enc.p.deblocking_filter_beta * 2,
                  cqpo=enc.p.analyse.chroma_qp_offset,
                  i4=bool(enc.p.analyse.intra & ANALYSE_I4x4))
        if cabac:
            (mode_m, mode_c, dc_z, ac_z, cdc, cac, recon, satd_cost, is_i4,
             i4_modes) = analyze_iframe(y, u, v, qp_mb, qpc_mb, qp_try, **kw)
        else:
            cap_words = (mbw * mbh * cap_bytes_per_mb(qp_try)) // 4
            words, total_bits, recon, satd_cost = encode_iframe(
                y, u, v, qp_mb, qpc_mb, qp_try, cap_words=cap_words, **kw)
        enc._pending_ref_fields = {
            "mvf": np.zeros((mbh, mbw, 2), np.int32),
            "inter_mask": np.zeros((mbh, mbw), bool)}

        def finalize():
            sh.qp = qp_try
            if cabac:
                nals = cabac_finalize_iframe(
                    enc, mode_m, mode_c, dc_z, ac_z, cdc, cac, qp_mb, qp_try,
                    sh, nal_type, nal_mod.NAL_PRIORITY_HIGHEST, is_i4,
                    i4_modes)
            else:
                nals = finalize_slice(enc, words, total_bits, cap_words, sh,
                                      nal_type, nal_mod.NAL_PRIORITY_HIGHEST)
            rec = ([to_host(r, "recon").numpy() for r in recon]
                   if materialize else list(recon))
            with trace.span("encoder:ratecontrol"):
                enc.rc.end(ftype, sum(len(n.payload) * 8 for n in nals),
                           float(to_host(satd_cost, "satd")), qp_try)
            return nals, rec

        return finalize, list(recon)

    finalize, recon = attempt(qp)
    return finalize, attempt, recon, None
