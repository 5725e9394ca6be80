"""CAVLC code generation and bit packing on the device, I, P and B slices
(x264_tpu/entropy/cavlc_jax.py).

Per-block (code, length) syntax elements come from vectorized table
lookups; a two-phase packer then places every element (at most 32 bits,
so it touches at most two consecutive 32-bit words) into per-MB buffers
and the MB buffers into the frame's big-endian word stream.

Bit math runs in int64 with every left shift masked to 32 bits, which is
what uint32 arithmetic gives (torch has no uint32 shifts on the CPU);
shifts by 32 give 0 as they do in XLA. Words leave as numpy uint32 only in
`words_to_bytes`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import const
from ..ops._cuda import to_device
from ..ops.cavlc import cavlc_residual_launch
from ..ops.tables import ZIGZAG4_FRAME
from ..utils import trace
from . import vlc_tables as V

BLOCK_SLOTS = 36
# luma 4x4 block coding order (z-scan) -> raster position in the MB 4x4
# grid, as x264_tpu/entropy/cavlc.py has it
LUMA4x4_RASTER = np.array(
    [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15])
_M32 = 0xFFFFFFFF
_i64 = torch.int64


def lut(table, idx):
    """table (numpy, any rank, indexed flat) at integer tensor idx; 0 where
    idx is out of range (the JAX one-hot lookup's semantics)."""
    t = const(np.asarray(table).reshape(-1), idx.device, _i64)
    n = t.shape[0]
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, t[idx.long().clamp(0, n - 1)], 0)


def _ue_len(v):
    """Bit length of ue(v) for v < 2^16."""
    vp1 = v.to(torch.int32) + 1
    nbits = torch.zeros_like(vp1)
    for k in range(1, 18):
        nbits = nbits + (vp1 >= (1 << k)).to(torch.int32)
    return 2 * nbits + 1


def ue_dev(v):
    """(code, len) of unsigned Exp-Golomb."""
    return (v.to(_i64) + 1) & _M32, _ue_len(v)


def se_dev(v):
    return ue_dev(torch.where(v <= 0, -2 * v, 2 * v - 1))


def _reverse_nonzeros_dev(coeffs):
    """[B, L] zig-zag coeffs -> (levels_rev, pos_rev, total): nonzero
    levels from the last to the first (0 past total), their positions (-1
    past total), and the count."""
    B, L = coeffs.shape
    nz = coeffs != 0
    nzi = nz.to(torch.int32)
    total = nzi.sum(1, dtype=torch.int32)
    rank = total[:, None] - torch.cumsum(nzi, 1, dtype=torch.int32)
    slot = torch.where(nz, rank, L).long()                   # L = discard
    levels = torch.zeros((B, L + 1), dtype=coeffs.dtype, device=coeffs.device)
    pos = torch.full((B, L + 1), -1, dtype=torch.int32, device=coeffs.device)
    levels.scatter_(1, slot, coeffs)
    ar = torch.arange(L, dtype=torch.int32, device=coeffs.device)
    pos.scatter_(1, slot, ar.expand(B, L).contiguous())
    return levels[:, :L].contiguous(), pos[:, :L].contiguous(), total


def residual_blocks_dev(coeffs, nc, chroma_dc: bool = False):
    """CAVLC for a batch of blocks: coeffs [B, L] int32 zig-zag, nc [B].
    Returns (codes [B, 36] int64, lens [B, 36] int32, total [B],
    over [B] bool: a level escape not representable at its suffix length).
    CUDA tensors go to the hand-written kernel (ops/cavlc.py, one launch),
    CPU tensors to residual_blocks_plain."""
    if coeffs.device.type == "cuda":
        return cavlc_residual_launch(
            coeffs.contiguous(), None if chroma_dc else nc.contiguous(),
            chroma_dc)
    return residual_blocks_plain(coeffs, nc, chroma_dc)


def residual_blocks_plain(coeffs, nc, chroma_dc: bool = False):
    """residual_blocks_dev on any device, as torch ops: the CPU path and
    the specification of the CUDA kernel (csrc/cavlc.cu)."""
    B, L = coeffs.shape
    dev = coeffs.device
    code_cols = [None] * BLOCK_SLOTS
    len_cols = [None] * BLOCK_SLOTS
    zero_c = torch.zeros((B,), dtype=_i64, device=dev)
    zero_i = torch.zeros((B,), dtype=torch.int32, device=dev)
    levels_rev, pos_rev, total = _reverse_nonzeros_dev(coeffs)

    lead = torch.cumprod((levels_rev[:, :3].abs() == 1).to(torch.int32), 1)
    t1 = torch.minimum(lead.sum(1, dtype=torch.int32), total)

    if chroma_dc:
        cls = torch.full((B,), 4 if L == 4 else 5, dtype=torch.int32,
                         device=dev)
    else:
        ncv = torch.as_tensor(nc, device=dev).to(torch.int32)
        cls = torch.where(ncv < 2, 0, torch.where(
            ncv < 4, 1, torch.where(ncv < 8, 2, 3))).to(torch.int32)
    ct_shape = V.COEFF_TOKEN_CODE.shape
    ti = (total - 1).clamp(min=0)
    ct_idx = (cls * ct_shape[1] + ti) * ct_shape[2] + t1
    code_cols[0] = torch.where(total == 0, lut(V.COEFF0_TOKEN_CODE, cls),
                               lut(V.COEFF_TOKEN_CODE, ct_idx))
    len_cols[0] = torch.where(total == 0, lut(V.COEFF0_TOKEN_LEN, cls),
                              lut(V.COEFF_TOKEN_LEN, ct_idx)).to(torch.int32)

    for k in range(3):
        active = k < t1
        code_cols[1 + k] = torch.where(active, (levels_rev[:, k] < 0)
                                       .to(_i64), zero_c)
        len_cols[1 + k] = torch.where(active, 1, zero_i)

    sl = torch.where((total > 10) & (t1 < 3), 1, 0).to(torch.int32)
    over = torch.zeros((B,), dtype=torch.bool, device=dev)
    maxk = min(L, 16)
    for k in range(maxk):
        lv = levels_rev[:, k].to(torch.int32)
        active = (k >= t1) & (k < total)
        lc = torch.where(lv > 0, 2 * lv - 2, -2 * lv - 1)
        lc = torch.where((k == t1) & (t1 < 3), lc - 2, lc).clamp(min=0)
        # suffixLength == 0
        c0v = torch.where(lc < 14, 1, torch.where(
            lc < 30, (1 << 4) | (lc - 14).to(_i64),
            (1 << 12) | (lc - 30).clamp(max=4095).to(_i64))).to(_i64)
        l0v = torch.where(lc < 14, lc + 1, torch.where(lc < 30, 19, 28))
        over0 = lc > 30 + 4095
        # suffixLength > 0
        slp = sl.clamp(min=1)
        prefix = lc >> slp
        mask = (1 << slp) - 1
        cpv = ((1 << slp.to(_i64)) | (lc & mask).to(_i64)) & _M32
        lpv = prefix + 1 + slp
        esc = prefix >= 15
        cpv = torch.where(esc, (1 << 12) | (lc - (15 << slp)).clamp(
            0, 4095).to(_i64), cpv)
        lpv = torch.where(esc, 28, lpv)
        overp = esc & (lc - (15 << slp) > 4095)
        use0 = sl == 0
        over = over | (active & torch.where(use0, over0, overp))
        code_cols[4 + k] = torch.where(active, torch.where(use0, c0v, cpv),
                                       zero_c)
        len_cols[4 + k] = torch.where(active, torch.where(use0, l0v, lpv),
                                      zero_i)
        new_sl = sl.clamp(min=1)
        new_sl = new_sl + ((lv.abs() > (3 << (new_sl - 1)))
                           & (new_sl < 6)).to(torch.int32)
        sl = torch.where(active, new_sl, sl)

    tz = torch.where(total > 0, pos_rev[:, 0] + 1 - total, 0)
    write_tz = (total > 0) & (total < L)
    if chroma_dc and L == 4:
        tzc, tzl = V.TOTAL_ZEROS_2x2_CODE, V.TOTAL_ZEROS_2x2_LEN
        trow, tcol = ti.clamp(max=2), tz.clamp(0, 3)
    elif chroma_dc:
        tzc, tzl = V.TOTAL_ZEROS_2x4_CODE, V.TOTAL_ZEROS_2x4_LEN
        trow, tcol = ti.clamp(max=6), tz.clamp(0, 7)
    else:
        tzc, tzl = V.TOTAL_ZEROS_CODE, V.TOTAL_ZEROS_LEN
        trow, tcol = ti.clamp(max=14), tz.clamp(0, 15)
    tz_idx = trow * tzc.shape[1] + tcol
    code_cols[20] = torch.where(write_tz, lut(tzc, tz_idx), zero_c)
    len_cols[20] = torch.where(write_tz, lut(tzl, tz_idx).to(torch.int32),
                               zero_i)

    rb_w = V.RUN_BEFORE_CODE.shape[1]
    zleft = torch.where(write_tz, tz, 0)
    for k in range(maxk - 1):
        run = pos_rev[:, k] - pos_rev[:, k + 1] - 1
        active = (k < total - 1) & (zleft > 0)
        run = torch.where(active, run, 0)
        rb_idx = (zleft - 1).clamp(0, 6) * rb_w + run.clamp(0, 15)
        code_cols[21 + k] = torch.where(active, lut(V.RUN_BEFORE_CODE,
                                                    rb_idx), zero_c)
        len_cols[21 + k] = torch.where(
            active, lut(V.RUN_BEFORE_LEN, rb_idx).to(torch.int32), zero_i)
        zleft = torch.where(active, zleft - run, zleft)

    for k in range(BLOCK_SLOTS):
        if code_cols[k] is None:
            code_cols[k], len_cols[k] = zero_c, zero_i
    codes = torch.stack(code_cols, dim=1)
    lens = torch.stack(len_cols, dim=1).to(torch.int32)
    return codes, lens, total, over


def pack_mb_stream(codes, lens, mb_cap_words: int, cap_words: int,
                   force_over=False):
    """Pack grouped (code, len <= 32) elements MSB-first into big-endian
    32-bit words. codes/lens [M, S]: M groups (MBs) of S slots, stream order
    row-major.

    A. elements -> per-MB buffers [M, mb_cap_words + 1] by scatter-add (bit
       ranges are disjoint, so a sum is an OR; words past the buffer drop);
    B. MB buffers -> frame stream: bit-align each buffer and scatter-add it
       at its word offset; words past cap_words drop.
    An MB whose bits exceed mb_cap_words * 32 forces total_bits to
    cap_words * 32 so the host takes the overflow / re-encode path.
    Returns (words [cap_words] int64 holding uint32 values, total_bits)."""
    M, S = codes.shape
    dev = codes.device
    lens = lens.to(torch.int32).clamp(0, 32)
    codes = torch.where(lens > 0, codes.to(_i64) & _M32, 0)
    Wm = mb_cap_words + 1

    ends = torch.cumsum(lens, 1, dtype=torch.int32)
    mb_bits = ends[:, -1]
    starts = ends - lens
    w0 = (starts >> 5).long()
    end = ((starts & 31) + lens).to(_i64)                # 0..63
    t0 = codes >> (end - 32).clamp(min=0)
    v0 = (t0 << (32 - end.clamp(max=32))) & _M32
    low_n = (end - 32).clamp(min=0)
    low = codes & ((1 << low_n) - 1)
    v1 = torch.where(low_n > 0, (low << (64 - end).clamp(max=63)) & _M32, 0)

    # phase A
    rows = torch.arange(M, device=dev)[:, None] * Wm
    acc = torch.zeros(M * Wm, dtype=_i64, device=dev)
    for w, val in ((w0, v0), (w0 + 1, v1)):
        keep = w < Wm
        with trace.waits("cavlc_pack"):         # a boolean-mask read
            at = (rows + w)[keep]
        with trace.waits("cavlc_pack"):
            add = val[keep]
        acc.index_add_(0, at, add)
    acc = (acc & _M32).reshape(M, Wm)
    mb_over = ((mb_bits > mb_cap_words * 32).any()
               | to_device(force_over, dev, "cavlc_pack"))

    # phase B
    mb_end = torch.cumsum(mb_bits.to(_i64), 0)
    total_bits = mb_end[-1]
    mb_start = mb_end - mb_bits
    r = (mb_start & 31)[:, None]
    prev = torch.cat([torch.zeros((M, 1), dtype=_i64, device=dev),
                      acc[:, :-1]], dim=1)
    shifted = torch.where(r > 0, (acc >> r) | ((prev << ((32 - r) & 31))
                                                & _M32), acc)
    spill = torch.where(r > 0, (acc[:, -1:] << ((32 - r) & 31)) & _M32, 0)
    shifted = torch.cat([shifted, spill], dim=1)            # [M, Wm + 1]
    word_idx = (mb_start >> 5)[:, None] + torch.arange(Wm + 1, device=dev)
    keep = (word_idx >= 0) & (word_idx < cap_words)
    words = torch.zeros(cap_words, dtype=_i64, device=dev)
    with trace.waits("cavlc_pack"):
        at = word_idx[keep]
    with trace.waits("cavlc_pack"):
        add = shifted[keep]
    words.index_add_(0, at, add)
    words = words & _M32
    total_bits = torch.where(mb_over, cap_words * 32, total_bits)
    return words, total_bits


def _nc_grid_dev(nnz_tiles, mbh: int, mbw: int, bs: int):
    """nnz_tiles [N, bs*bs] raster-in-MB -> nC [N, bs*bs]."""
    n = mbh * mbw
    grid = nnz_tiles.reshape(mbh, mbw, bs, bs).permute(0, 2, 1, 3) \
        .reshape(mbh * bs, mbw * bs)
    z_col = torch.zeros_like(grid[:, :1])
    z_row = torch.zeros_like(grid[:1, :])
    na = torch.cat([z_col, grid[:, :-1]], dim=1)
    nb = torch.cat([z_row, grid[:-1, :]], dim=0)
    has_a = torch.arange(mbw * bs, device=grid.device)[None, :] > 0
    has_b = torch.arange(mbh * bs, device=grid.device)[:, None] > 0
    nc = torch.where(has_a & has_b, (na + nb + 1) >> 1,
                     torch.where(has_a, na, torch.where(has_b, nb, 0)))
    return nc.reshape(mbh, bs, mbw, bs).permute(0, 2, 1, 3).reshape(
        n, bs * bs)


def _quad_of_raster():
    blk_r = np.arange(16)
    return (blk_r // 4 // 2) * 2 + (blk_r % 4) // 2      # raster -> 8x8 id


@trace.spanned("entropy:cavlc")
def encode_i16x16_frame_dev(i16_mode, chroma_mode, qp_flat, slice_qp,
                            dc_blk, ac_blk, cdc_blk, cac_blk, *, mbw: int,
                            mbh: int, cap_words: int, is_i4=None,
                            i4_modes=None):
    """Full I-slice MB-layer CAVLC (I16x16 + I_4x4).

    dc_blk [N,4,4] (Hadamard-domain levels, raster), ac_blk [N,16,4,4]
    (raster blocks; I16 rows AC with position 0 zero, I4 rows full
    16-coeff levels), cdc_blk [N,2,2,2], cac_blk [N,2,4,4,4]. is_i4 [N] +
    i4_modes [N,16] enable I_4x4 MBs.
    Returns (words, total_bits, eff_qp): eff_qp is the decoder-carried
    per-MB QP (I4 MBs without residual inherit it), for the deblock."""
    n = mbw * mbh
    dev = dc_blk.device
    if is_i4 is None:
        is_i4 = torch.zeros((n,), dtype=torch.bool, device=dev)
        i4_modes = torch.zeros((n, 16), dtype=torch.int32, device=dev)
    is_i4 = is_i4.bool()
    zig = const(ZIGZAG4_FRAME, dev, _i64)
    dc_z = dc_blk.reshape(n, 16)[:, zig]
    ac_z = ac_blk.reshape(n, 16, 16)[:, :, zig]
    cdc = cdc_blk.reshape(n, 2, 4)
    cac_z = cac_blk.reshape(n, 2, 4, 16)[:, :, :, zig]

    def count(x, dim):
        return (x != 0).sum(dim, dtype=torch.int32)

    # nnz grid: I16 rows count the 15 AC coeffs, I4 rows all 16
    nnz_ac = count(ac_z[:, :, 1:], 2)
    nnz_full = count(ac_z, 2)
    nc_l = _nc_grid_dev(torch.where(is_i4[:, None], nnz_full, nnz_ac),
                        mbh, mbw, 4)
    dc_codes, dc_lens, _, dc_ov = residual_blocks_dev(dc_z, nc_l[:, 0])
    ac_codes, ac_lens, _, ac_ov = residual_blocks_dev(
        ac_z[:, :, 1:].reshape(n * 16, 15), nc_l.reshape(-1))
    l16_codes, l16_lens, _, l16_ov = residual_blocks_dev(
        ac_z.reshape(n * 16, 16), nc_l.reshape(-1))
    i43 = is_i4[:, None, None]
    ac_codes = torch.where(i43, l16_codes.reshape(n, 16, BLOCK_SLOTS),
                           ac_codes.reshape(n, 16, BLOCK_SLOTS))
    ac_lens = torch.where(i43, l16_lens.reshape(n, 16, BLOCK_SLOTS),
                          ac_lens.reshape(n, 16, BLOCK_SLOTS))
    ac_ov = torch.where(is_i4[:, None], l16_ov.reshape(n, 16),
                        ac_ov.reshape(n, 16))
    cdc_codes, cdc_lens, _, cdc_ov = residual_blocks_dev(
        cdc.reshape(n * 2, 4), torch.zeros(n * 2, dtype=torch.int32,
                                           device=dev), chroma_dc=True)
    cdc_codes = cdc_codes.reshape(n, 2, BLOCK_SLOTS)
    cdc_lens = cdc_lens.reshape(n, 2, BLOCK_SLOTS)
    nnz_cac = count(cac_z[:, :, :, 1:], 3)
    nc_c = torch.stack([_nc_grid_dev(nnz_cac[:, 0], mbh, mbw, 2),
                        _nc_grid_dev(nnz_cac[:, 1], mbh, mbw, 2)], dim=1)
    cac_codes, cac_lens, _, cac_ov = residual_blocks_dev(
        cac_z[:, :, :, 1:].reshape(n * 8, 15), nc_c.reshape(-1))
    cac_codes = cac_codes.reshape(n, 8, BLOCK_SLOTS)
    cac_lens = cac_lens.reshape(n, 8, BLOCK_SLOTS)
    # the JAX twin broadcasts dc_ov [N] against ~is_i4 [N, 1]: any DC
    # overflow counts as soon as any MB is I16
    lvl_over = ((dc_ov.any() & (~is_i4).any()) | ac_ov.any() | cdc_ov.any()
                | cac_ov.any())

    cbp_luma16 = nnz_ac.sum(1) > 0
    quad = const(_quad_of_raster(), dev)
    cbp4 = torch.zeros((n,), dtype=torch.int32, device=dev)
    for qd in range(4):
        qnnz = torch.where(quad == qd, nnz_full, 0).sum(1)
        cbp4 = cbp4 | torch.where(qnnz > 0, 1 << qd, 0).to(torch.int32)
    any_cac = nnz_cac.reshape(n, 8).sum(1) > 0
    any_cdc = count(cdc, (1, 2)) > 0
    cbp_chroma = torch.where(any_cac, 2, torch.where(any_cdc, 1, 0)) \
        .to(torch.int32)
    mb_type = torch.where(is_i4, 0, 1 + i16_mode.to(torch.int32)
                          + 4 * cbp_chroma + 12 * cbp_luma16.to(torch.int32))

    m_codes, m_lens = _i4_mode_codes_dev(is_i4, i4_modes, mbh, mbw)

    # ---- header slots: mb_type, 16 modes, chroma_mode, cbp, dqp ----
    h_codes = torch.zeros((n, 20), dtype=_i64, device=dev)
    h_lens = torch.zeros((n, 20), dtype=torch.int32, device=dev)
    h_codes[:, 0], h_lens[:, 0] = ue_dev(mb_type)
    h_codes[:, 1:17], h_lens[:, 1:17] = m_codes, m_lens
    h_codes[:, 17], h_lens[:, 17] = ue_dev(chroma_mode)
    c, ln = ue_dev(lut(V.CBP_TO_GOLOMB_INTRA, cbp_chroma * 16 + cbp4))
    h_codes[:, 18] = c
    h_lens[:, 18] = torch.where(is_i4, ln, 0)
    # dqp: always for I16; only with residual for I4 (dqp-less MBs keep the
    # decoder-carried qp)
    has_dqp = (~is_i4) | (cbp4 > 0) | (cbp_chroma > 0)
    qp_flat = qp_flat.to(torch.int32)
    idxs = torch.arange(n, dtype=torch.int32, device=dev)
    last_d = torch.cummax(torch.where(has_dqp, idxs, -1), 0).values
    prev_d = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev),
                        last_d[:-1]])
    prev_qp = torch.where(prev_d >= 0, qp_flat[prev_d.clamp(min=0).long()],
                          int(slice_qp))
    eff_qp = torch.where(has_dqp, qp_flat, prev_qp)
    c, ln = se_dev(torch.where(has_dqp, qp_flat - prev_qp, 0))
    h_codes[:, 19] = c
    h_lens[:, 19] = torch.where(has_dqp, ln, 0)

    # ---- gating ----
    dc_lens = torch.where(is_i4[:, None], 0, dc_lens)
    qbit = (cbp4[:, None] >> quad[None, :]) & 1
    luma_on = torch.where(is_i4[:, None], qbit > 0, cbp_luma16[:, None])
    ac_lens = torch.where(luma_on[:, :, None], ac_lens, 0)
    cdc_lens = torch.where((cbp_chroma > 0)[:, None, None], cdc_lens, 0)
    cac_lens = torch.where((cbp_chroma == 2)[:, None, None], cac_lens, 0)

    order = const(LUMA4x4_RASTER, dev, _i64)
    ac_codes = ac_codes[:, order]
    ac_lens = ac_lens[:, order]
    codes = torch.cat([h_codes, dc_codes, ac_codes.reshape(n, -1),
                       cdc_codes.reshape(n, -1), cac_codes.reshape(n, -1)],
                      dim=1)
    lens = torch.cat([h_lens, dc_lens, ac_lens.reshape(n, -1),
                      cdc_lens.reshape(n, -1), cac_lens.reshape(n, -1)],
                     dim=1)
    words, total_bits = pack_mb_stream(codes, lens, cap_words // n,
                                       cap_words, force_over=lvl_over)
    return words, total_bits, eff_qp


def _i4_mode_codes_dev(is_i4, i4_modes, mbh, mbw):
    """(codes, lens) [N, 16] in z-scan emission order for the 16
    prev_intra4x4_pred_mode_flag / rem elements (spec 8.3.1.1 MPM)."""
    n = mbh * mbw
    dev = i4_modes.device
    i4_modes = i4_modes.to(torch.int32)
    mode_grid = i4_modes.reshape(mbh, mbw, 4, 4).permute(0, 2, 1, 3) \
        .reshape(mbh * 4, mbw * 4)
    i4_grid = is_i4.reshape(mbh, mbw).repeat_interleave(4, 0) \
        .repeat_interleave(4, 1)
    mode_grid = torch.where(i4_grid, mode_grid, 2)
    mA = torch.cat([torch.full_like(mode_grid[:, :1], 2), mode_grid[:, :-1]],
                   dim=1)
    mB = torch.cat([torch.full_like(mode_grid[:1, :], 2), mode_grid[:-1, :]],
                   dim=0)
    av_a = torch.arange(mbw * 4, device=dev)[None, :] > 0
    av_b = torch.arange(mbh * 4, device=dev)[:, None] > 0
    mpm_grid = torch.where(av_a & av_b, torch.minimum(mA, mB), 2)
    mpm = mpm_grid.reshape(mbh, 4, mbw, 4).permute(0, 2, 1, 3).reshape(n, 16)
    m = i4_modes
    flag = m == mpm
    rem = m - (m > mpm).to(torch.int32)
    m_codes = torch.where(flag, 1, rem).to(_i64)
    m_lens = torch.where(is_i4[:, None], torch.where(flag, 1, 4), 0) \
        .to(torch.int32)
    zorder = const(LUMA4x4_RASTER, dev, _i64)
    return m_codes[:, zorder], m_lens[:, zorder]


def _carried_qp(has, qp_flat, slice_qp):
    """(prev_qp, eff_qp) [N]: the QP the decoder carries into each MB (the
    last MB with `has` before it, else the slice QP) and after it."""
    n = qp_flat.shape[0]
    idxs = torch.arange(n, dtype=torch.int32, device=qp_flat.device)
    last = torch.cummax(torch.where(has, idxs, -1), 0).values
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int32,
                                 device=qp_flat.device), last[:-1]])
    prev_qp = torch.where(prev >= 0, qp_flat[prev.clamp(min=0).long()],
                          to_device(slice_qp, qp_flat.device, "slice_qp",
                                    dtype=torch.int32))
    return prev_qp, torch.where(has, qp_flat, prev_qp)


def _pframe_mb_codes(skip, mvd, cbp_luma, cbp_chroma, qp_flat, slice_qp,
                     luma_lv, cdc_blk, cac_blk, *, mbw: int, mbh: int,
                     is_intra=None, i16_mode=None, chroma_mode=None,
                     luma_dc=None, part_mode=None, mvd2=None, mvd23=None,
                     is_i4=None, i4_modes=None, refidx=None,
                     two_refs: bool = False, two_refs_live=None):
    """P-slice MB-layer element table (x264_tpu cavlc_jax._pframe_mb_codes):
    (codes [N, S] int64, lens [N, S], eff_qp [N], lvl_over, trailing)."""
    n = mbw * mbh
    dev = skip.device
    i32 = dict(dtype=torch.int32, device=dev)
    if part_mode is None:
        part_mode = torch.zeros((n,), **i32)
        mvd2 = torch.zeros((n, 2), **i32)
    if mvd23 is None:
        mvd23 = torch.zeros((n, 2, 2), **i32)
    if is_i4 is None:
        is_i4 = torch.zeros((n,), dtype=torch.bool, device=dev)
        i4_modes = torch.zeros((n, 16), **i32)
    if is_intra is None:
        is_intra = torch.zeros((n,), dtype=torch.bool, device=dev)
        i16_mode = torch.zeros((n,), **i32)
        chroma_mode = torch.zeros((n,), **i32)
        luma_dc = torch.zeros((n, 4, 4), **i32)
    skip, is_intra, is_i4 = skip.bool(), is_intra.bool(), is_i4.bool()
    qp_flat = qp_flat.to(torch.int32)
    cbp_luma = cbp_luma.to(torch.int32)
    cbp_chroma = cbp_chroma.to(torch.int32)
    zig = const(ZIGZAG4_FRAME, dev, _i64)
    luma_z = luma_lv.reshape(n, 16, 16)[:, :, zig]
    cdc = cdc_blk.reshape(n, 2, 4)
    cac_z = cac_blk.reshape(n, 2, 4, 16)[:, :, :, zig]

    # ---- skip runs ----
    idx = torch.arange(n, **i32)
    coded = ~skip
    last_coded = torch.cummax(torch.where(coded, idx, -1), 0).values
    prev_coded = torch.cat([torch.full((1,), -1, **i32), last_coded[:-1]])
    run = torch.where(coded, idx - prev_coded - 1, 0)
    trailing = n - 1 - last_coded[-1]

    def count(x, dim):
        return (x != 0).sum(dim, dtype=torch.int32)

    # ---- residual blocks: inter rows code 16 coeffs; I16 rows 15 AC plus
    # the 16-coeff DC block ----
    nnz_l = count(luma_z, 2)
    nc_l = _nc_grid_dev(nnz_l, mbh, mbw, 4)
    l_codes, l_lens, _, l_ov = residual_blocks_dev(
        luma_z.reshape(n * 16, 16), nc_l.reshape(-1))
    l_codes = l_codes.reshape(n, 16, BLOCK_SLOTS)
    l_lens = l_lens.reshape(n, 16, BLOCK_SLOTS)
    dc_z = luma_dc.reshape(n, 16)[:, zig]
    dc_codes, dc_lens, _, dc_ov = residual_blocks_dev(dc_z, nc_l[:, 0])
    l15_codes, l15_lens, _, l15_ov = residual_blocks_dev(
        luma_z[:, :, 1:].reshape(n * 16, 15), nc_l.reshape(-1))
    is_i16 = is_intra & ~is_i4
    ii3 = is_i16[:, None, None]
    l_codes = torch.where(ii3, l15_codes.reshape(n, 16, BLOCK_SLOTS),
                          l_codes)
    l_lens = torch.where(ii3, l15_lens.reshape(n, 16, BLOCK_SLOTS), l_lens)
    l_ov = torch.where(is_i16[:, None], l15_ov.reshape(n, 16),
                       l_ov.reshape(n, 16))
    dc_lens = torch.where(is_i16[:, None], dc_lens, 0)
    cdc_codes, cdc_lens, _, cdc_ov = residual_blocks_dev(
        cdc.reshape(n * 2, 4), torch.zeros(n * 2, **i32), chroma_dc=True)
    cdc_codes = cdc_codes.reshape(n, 2, BLOCK_SLOTS)
    cdc_lens = cdc_lens.reshape(n, 2, BLOCK_SLOTS)
    nnz_cac = count(cac_z[:, :, :, 1:], 3)
    nc_c = torch.stack([_nc_grid_dev(nnz_cac[:, 0], mbh, mbw, 2),
                        _nc_grid_dev(nnz_cac[:, 1], mbh, mbw, 2)], dim=1)
    cac_codes, cac_lens, _, cac_ov = residual_blocks_dev(
        cac_z[:, :, :, 1:].reshape(n * 8, 15), nc_c.reshape(-1))
    cac_codes = cac_codes.reshape(n, 8, BLOCK_SLOTS)
    cac_lens = cac_lens.reshape(n, 8, BLOCK_SLOTS)

    # ---- header slots: 0 run, 1 mb_type, 2-17 I4 modes (z-scan), 18
    # sub_mb_types, 19-22 te() ref_idx, 23 mvd0_x | chroma_mode, 24 mvd0_y |
    # dqp (I16), 25-26 mvd1, 27-30 mvd2/mvd3 (P_8x8), 31 cbp, 32 dqp ----
    h_codes = torch.zeros((n, 33), dtype=_i64, device=dev)
    h_lens = torch.zeros((n, 33), **i32)
    h_codes[:, 0], h_lens[:, 0] = ue_dev(run)
    # carried-QP chain: inter / I4 MBs with residual and every I16 MB
    has_resid = ((((cbp_luma > 0) | (cbp_chroma > 0)) & coded)
                 | (is_i16 & coded))
    prev_qp, eff_qp = _carried_qp(has_resid, qp_flat, slice_qp)
    dqp = qp_flat - prev_qp
    i16_code = (6 + i16_mode.to(torch.int32) + 4 * cbp_chroma
                + 12 * (cbp_luma > 0).to(torch.int32))
    c_i, l_i = ue_dev(torch.where(is_i4, 5, i16_code))
    c, ln = ue_dev(part_mode)
    h_codes[:, 1] = torch.where(is_intra, c_i, c)
    h_lens[:, 1] = torch.where(is_intra, l_i, ln)
    m_codes, m_lens = _i4_mode_codes_dev(is_i4, i4_modes, mbh, mbw)
    h_codes[:, 2:18] = m_codes
    h_lens[:, 2:18] = torch.where(coded[:, None], m_lens, 0)
    part2 = (part_mode > 0) & ~is_intra
    p88 = (part_mode == 3) & ~is_intra
    h_codes[:, 18] = 0b1111
    h_lens[:, 18] = torch.where(p88, 4, 0)
    if two_refs:
        live = (torch.ones((), dtype=torch.bool, device=dev)
                if two_refs_live is None
                else to_device(two_refs_live, dev, "ref1_valid"))
        ref_bit = (1 - refidx.to(_i64))
        gates = (~is_intra & live, part2 & live, p88 & live, p88 & live)
        for pi, gate in enumerate(gates):
            h_codes[:, 19 + pi] = ref_bit
            h_lens[:, 19 + pi] = torch.where(gate, 1, 0)
    c_cm, l_cm = ue_dev(chroma_mode)
    c, ln = se_dev(mvd[:, 0])
    h_codes[:, 23] = torch.where(is_intra, c_cm, c)
    h_lens[:, 23] = torch.where(is_intra, l_cm, ln)
    c_dq, l_dq = se_dev(torch.where(has_resid, dqp, 0))
    c, ln = se_dev(mvd[:, 1])
    h_codes[:, 24] = torch.where(is_intra, c_dq, c)
    h_lens[:, 24] = torch.where(is_i4, 0, torch.where(is_intra, l_dq, ln))
    for comp, slot in ((0, 25), (1, 26)):
        c, ln = se_dev(mvd2[:, comp])
        h_codes[:, slot] = c
        h_lens[:, slot] = torch.where(part2, ln, 0)
    for pi, base in ((0, 27), (1, 29)):
        for comp in range(2):
            c, ln = se_dev(mvd23[:, pi, comp])
            h_codes[:, base + comp] = c
            h_lens[:, base + comp] = torch.where(p88, ln, 0)
    cbp_idx = cbp_chroma * 16 + cbp_luma
    c, ln = ue_dev(lut(V.CBP_TO_GOLOMB_INTER, cbp_idx))
    c4, l4 = ue_dev(lut(V.CBP_TO_GOLOMB_INTRA, cbp_idx))
    h_codes[:, 31] = torch.where(is_i4, c4, c)
    h_lens[:, 31] = torch.where(is_i4, l4, torch.where(is_intra, 0, ln))
    h_codes[:, 32] = c_dq
    h_lens[:, 32] = torch.where(is_i16, 0, torch.where(has_resid, l_dq, 0))

    # ---- gating ----
    coded3 = coded[:, None, None]
    h_lens = torch.where(coded[:, None], h_lens, 0)
    quad = const(_quad_of_raster(), dev)
    qbit = (cbp_luma[:, None] >> quad[None, :]) & 1
    l_lens = torch.where((qbit > 0)[:, :, None] & coded3, l_lens, 0)
    dc_lens = torch.where(coded[:, None], dc_lens, 0)
    cdc_lens = torch.where((cbp_chroma > 0)[:, None, None] & coded3,
                           cdc_lens, 0)
    cac_lens = torch.where((cbp_chroma == 2)[:, None, None] & coded3,
                           cac_lens, 0)
    order = const(LUMA4x4_RASTER, dev, _i64)
    l_codes = l_codes[:, order]
    l_lens = l_lens[:, order]
    codes = torch.cat([h_codes, dc_codes, l_codes.reshape(n, -1),
                       cdc_codes.reshape(n, -1), cac_codes.reshape(n, -1)],
                      dim=1)
    lens = torch.cat([h_lens, dc_lens, l_lens.reshape(n, -1),
                      cdc_lens.reshape(n, -1), cac_lens.reshape(n, -1)],
                     dim=1)
    # level overflow counts only in blocks that are written; as in the JAX
    # twin, the luma overflow flags (raster) meet the written-block test
    # taken after the reorder to coding order
    lvl_over = ((l_ov & (l_lens.sum(2) > 0)).any()
                | (dc_ov & (dc_lens.sum(1) > 0)).any()
                | (cdc_ov.reshape(n, 2) & (cdc_lens.sum(2) > 0)).any()
                | (cac_ov.reshape(n, 8) & (cac_lens.sum(2) > 0)).any())
    return codes, lens, eff_qp, lvl_over, trailing


@trace.spanned("entropy:cavlc")
def encode_pframe_entropy_dev(skip, mvd, cbp_luma, cbp_chroma, qp_flat,
                              slice_qp, luma_lv, cdc_blk, cac_blk, *,
                              mbw: int, mbh: int, cap_words: int, **kw):
    """P-slice MB layer (x264_tpu cavlc_jax.encode_pframe_entropy_dev):
    P_L0_16x16/16x8/8x16/P_8x8 and P_Skip runs, I16 and I_4x4 in P, one or
    two references (keywords as `_pframe_mb_codes`; `two_refs_live` gates
    the te() ref_idx bits). Returns (words, total_bits, eff_qp)."""
    n = mbw * mbh
    codes, lens, eff_qp, lvl_over, trailing = _pframe_mb_codes(
        skip, mvd, cbp_luma, cbp_chroma, qp_flat, slice_qp, luma_lv,
        cdc_blk, cac_blk, mbw=mbw, mbh=mbh, **kw)
    codes, lens = _trailing_run_row(codes, lens, trailing)
    words, total_bits = pack_mb_stream(codes, lens, cap_words // n,
                                       cap_words, force_over=lvl_over)
    return words, total_bits, eff_qp


def _trailing_run_row(codes, lens, trailing):
    """codes / lens with one more group row: the slice's trailing skip run
    (nothing when the last MB is coded)."""
    tc, tl = ue_dev(trailing.clamp(min=0))
    trow_c = torch.zeros((1, codes.shape[1]), dtype=_i64, device=codes.device)
    trow_l = torch.zeros((1, codes.shape[1]), dtype=torch.int32,
                         device=codes.device)
    trow_c[0, 0] = tc
    trow_l[0, 0] = torch.where(trailing > 0, tl, 0)
    return torch.cat([codes, trow_c]), torch.cat([lens, trow_l])


@trace.spanned("entropy:cavlc")
def encode_bframe_entropy_dev(mode, mvd0, mvd1, cbp_luma, cbp_chroma, qp_flat,
                              slice_qp, luma_lv, cdc_blk, cac_blk, *,
                              mbw: int, mbh: int, cap_words: int, skip=None):
    """B-slice MB layer (x264_tpu cavlc_jax.encode_bframe_entropy_dev):
    B_Skip runs and B_L0 / L1 / Bi / Direct_16x16, one reference per list.

    mode [N] 0=L0 1=L1 2=BI 3=Direct; mvd0 / mvd1 [N, 2]; skip [N] bool
    (B_Skip: direct with no residual, coded through mb_skip_run); the rest
    as in the P writer. The stream has N + 1 group rows, the last for the
    trailing skip run. Returns (words, total_bits, eff_qp)."""
    n = mbw * mbh
    dev = mode.device
    i32 = dict(dtype=torch.int32, device=dev)
    skip = (torch.zeros((n,), dtype=torch.bool, device=dev) if skip is None
            else skip.bool())
    mode = mode.to(torch.int32)
    qp_flat = qp_flat.to(torch.int32)
    cbp_luma = cbp_luma.to(torch.int32)
    cbp_chroma = cbp_chroma.to(torch.int32)
    zig = const(ZIGZAG4_FRAME, dev, _i64)
    luma_z = luma_lv.reshape(n, 16, 16)[:, :, zig]
    cdc = cdc_blk.reshape(n, 2, 4)
    cac_z = cac_blk.reshape(n, 2, 4, 16)[:, :, :, zig]

    def count(x, dim):
        return (x != 0).sum(dim, dtype=torch.int32)

    # ---- residual blocks, as in the P writer ----
    nc_l = _nc_grid_dev(count(luma_z, 2), mbh, mbw, 4)
    l_codes, l_lens, _, l_ov = residual_blocks_dev(
        luma_z.reshape(n * 16, 16), nc_l.reshape(-1))
    l_codes = l_codes.reshape(n, 16, BLOCK_SLOTS)
    l_lens = l_lens.reshape(n, 16, BLOCK_SLOTS)
    cdc_codes, cdc_lens, _, cdc_ov = residual_blocks_dev(
        cdc.reshape(n * 2, 4), torch.zeros(n * 2, **i32), chroma_dc=True)
    cdc_codes = cdc_codes.reshape(n, 2, BLOCK_SLOTS)
    cdc_lens = cdc_lens.reshape(n, 2, BLOCK_SLOTS)
    nnz_cac = count(cac_z[:, :, :, 1:], 3)
    nc_c = torch.stack([_nc_grid_dev(nnz_cac[:, 0], mbh, mbw, 2),
                        _nc_grid_dev(nnz_cac[:, 1], mbh, mbw, 2)], dim=1)
    cac_codes, cac_lens, _, cac_ov = residual_blocks_dev(
        cac_z[:, :, :, 1:].reshape(n * 8, 15), nc_c.reshape(-1))
    cac_codes = cac_codes.reshape(n, 8, BLOCK_SLOTS)
    cac_lens = cac_lens.reshape(n, 8, BLOCK_SLOTS)

    # ---- skip runs ----
    idx = torch.arange(n, **i32)
    coded = ~skip
    last_coded = torch.cummax(torch.where(coded, idx, -1), 0).values
    prev_coded = torch.cat([torch.full((1,), -1, **i32), last_coded[:-1]])
    run = torch.where(coded, idx - prev_coded - 1, 0)
    trailing = n - 1 - last_coded[-1]

    # ---- header slots: 0 run, 1 mb_type (B_Direct_16x16 ue(0), explicit
    # ue(mode + 1)), 2-3 mvd l0, 4-5 mvd l1, 6 cbp, 7 dqp ----
    h_codes = torch.zeros((n, 8), dtype=_i64, device=dev)
    h_lens = torch.zeros((n, 8), **i32)
    h_codes[:, 0], h_lens[:, 0] = ue_dev(run)
    h_codes[:, 1], h_lens[:, 1] = ue_dev(torch.where(mode == 3, 0, mode + 1))
    use0 = (mode == 0) | (mode == 2)
    use1 = (mode == 1) | (mode == 2)
    for slot, (mvd, use, comp) in enumerate(
            [(mvd0, use0, 0), (mvd0, use0, 1), (mvd1, use1, 0),
             (mvd1, use1, 1)]):
        c, ln = se_dev(mvd[:, comp])
        h_codes[:, 2 + slot] = c
        h_lens[:, 2 + slot] = torch.where(use, ln, 0)
    h_codes[:, 6], h_lens[:, 6] = ue_dev(lut(V.CBP_TO_GOLOMB_INTER,
                                             cbp_chroma * 16 + cbp_luma))
    has_resid = ((cbp_luma > 0) | (cbp_chroma > 0)) & coded
    prev_qp, eff_qp = _carried_qp(has_resid, qp_flat, slice_qp)
    c, ln = se_dev(torch.where(has_resid, qp_flat - prev_qp, 0))
    h_codes[:, 7] = c
    h_lens[:, 7] = torch.where(has_resid, ln, 0)

    # ---- gating ----
    coded3 = coded[:, None, None]
    h_lens = torch.where(coded[:, None], h_lens, 0)
    quad = const(_quad_of_raster(), dev)
    qbit = (cbp_luma[:, None] >> quad[None, :]) & 1
    l_lens = torch.where((qbit > 0)[:, :, None] & coded3, l_lens, 0)
    cdc_lens = torch.where((cbp_chroma > 0)[:, None, None] & coded3,
                           cdc_lens, 0)
    cac_lens = torch.where((cbp_chroma == 2)[:, None, None] & coded3,
                           cac_lens, 0)
    order = const(LUMA4x4_RASTER, dev, _i64)
    l_codes = l_codes[:, order]
    l_lens = l_lens[:, order]
    codes = torch.cat([h_codes, l_codes.reshape(n, -1),
                       cdc_codes.reshape(n, -1), cac_codes.reshape(n, -1)],
                      dim=1)
    lens = torch.cat([h_lens, l_lens.reshape(n, -1),
                      cdc_lens.reshape(n, -1), cac_lens.reshape(n, -1)],
                     dim=1)
    # as in the P writer and the JAX twin: the luma overflow flags (raster)
    # meet the written-block test taken after the reorder to coding order
    lvl_over = ((l_ov.reshape(n, 16) & (l_lens.sum(2) > 0)).any()
                | (cdc_ov.reshape(n, 2) & (cdc_lens.sum(2) > 0)).any()
                | (cac_ov.reshape(n, 8) & (cac_lens.sum(2) > 0)).any())
    codes, lens = _trailing_run_row(codes, lens, trailing)
    words, total_bits = pack_mb_stream(codes, lens, cap_words // n,
                                       cap_words, force_over=lvl_over)
    return words, total_bits, eff_qp


def words_to_bytes(words: np.ndarray, total_bits: int) -> tuple[bytes, int]:
    """Host: big-endian words -> byte string truncated to ceil(total_bits/8).
    Returns (payload, total_bits)."""
    nbytes = (int(total_bits) + 7) // 8
    by = np.asarray(words).astype(">u4").tobytes()[:nbytes]
    return by, int(total_bits)
