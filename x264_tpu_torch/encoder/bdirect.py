"""B_Direct_16x16 / B_Skip: spatial direct motion derivation
(x264_tpu/encoder/bdirect.py; reference mb_predict_mv_direct16x16_spatial,
mvpred.c:290).

The derivation reads only neighbour fields that are already decided, so
it runs as one pass over shifted fields. A direct MB's own MV feeds later
MBs' derivations, so the caller (encoder/bframe.py) adopts direct through a
fixed-point loop: derive, adopt where cheaper, derive again, and drop every
MB whose derivation changed, until a decoder that derives from the coded
fields gets exactly the MVs the encoder predicted with.
"""

from __future__ import annotations

import torch

from ..ops import mc
from ..ops.warp import mb_windows_ref
from .inter import _median3, _shift

MODE_L0, MODE_L1, MODE_BI, MODE_DIRECT = 0, 1, 2, 3
_i32 = torch.int32


def derive_direct(use0, use1, mv0, mv1, col_inter, col_mv):
    """Spatial direct derivation for every MB (16x16, one reference per
    list, progressive).

    use0 / use1 [mbh, mbw] bool: the MB's refIdxLX == 0; mv0 / mv1
    [mbh, mbw, 2]: the per-list MVs (0 where unused); col_inter [mbh, mbw]:
    the L1 anchor's co-located MB is inter on ref 0; col_mv: its MV.
    Returns (d_use0, d_use1, d_mv0, d_mv1)."""
    mbh, mbw = use0.shape
    dev = use0.device
    col = torch.arange(mbw, device=dev)[None, :]
    row = torch.arange(mbh, device=dev)[:, None]
    avail_a = (col > 0).expand(mbh, mbw)
    avail_b = (row > 0).expand(mbh, mbw)
    avail_c = avail_b & (col < mbw - 1)
    avail_d = avail_a & avail_b

    outs = []
    for use, mv in ((use0, mv0), (use1, mv1)):
        mvm = torch.where(use[..., None], mv, 0)
        mv_a = torch.where(avail_a[..., None], _shift(mvm, 1, 0), 0)
        mv_b = torch.where(avail_b[..., None], _shift(mvm, 0, 1), 0)
        ref_a = avail_a & _shift(use, 1, 0)
        ref_b = avail_b & _shift(use, 0, 1)
        # C, or D where C lies outside the frame
        mv_c = torch.where(avail_c[..., None], _shift(mvm, -1, 1),
                           torch.where(avail_d[..., None],
                                       _shift(mvm, 1, 1), 0))
        ref_c = torch.where(avail_c, _shift(use, -1, 1),
                            avail_d & _shift(use, 1, 1))
        has_ref = ref_a | ref_b | ref_c
        count = ref_a.to(_i32) + ref_b.to(_i32) + ref_c.to(_i32)
        only = torch.where(ref_a[..., None], mv_a,
                           torch.where(ref_b[..., None], mv_b, mv_c))
        dmv = torch.where((count > 1)[..., None], _median3(mv_a, mv_b, mv_c),
                          only)
        outs.append((has_ref, torch.where(has_ref[..., None], dmv, 0)))
    (u0, m0), (u1, m1) = outs

    # no neighbour has a reference in either list: both lists ref 0, zero MVs
    none_ref = ~u0 & ~u1
    u0 = u0 | none_ref
    u1 = u1 | none_ref
    m0 = torch.where(none_ref[..., None], 0, m0)
    m1 = torch.where(none_ref[..., None], 0, m1)

    # colZeroFlag: the co-located MB is inter on ref 0 with |mv| <= 1
    colzero = (col_inter & (col_mv[..., 0].abs() <= 1)
               & (col_mv[..., 1].abs() <= 1) & ~none_ref)
    apply_cz = colzero & ((m0 != 0).any(-1) | (m1 != 0).any(-1))
    m0 = torch.where((apply_cz & u0)[..., None], 0, m0)
    m1 = torch.where((apply_cz & u1)[..., None], 0, m1)
    return u0, u1, m0, m1


def direct_pred_luma(hpel, dmv, mbh, mbw, me_range):
    """Luma MC at a per-MB quarter-pel MV dmv [n, 2]: one window per MB at
    the MV's full-pel part (floor), then the prediction of the MB's own
    phase among the 16. Returns pred [n, 16, 16] int32.

    The caller discards MBs whose MV leaves the search range; their windows
    clamp to the plane's edge (ops/warp.mb_windows_ref)."""
    n = mbh * mbw
    M = 2
    WW = 16 + 2 * M + 1
    fp = (dmv >> 2).reshape(mbh, mbw, 2)
    win = mb_windows_ref(hpel, fp - M, bs=16, win=WW, pad=mc.PAD) \
        .reshape(n, 4, WW, WW).to(_i32)
    phase = (dmv[:, 1] & 3) * 4 + (dmv[:, 0] & 3)
    pred = torch.zeros((n, 16, 16), dtype=_i32, device=dmv.device)
    for q in range(16):
        pfx, pfy = q & 3, q >> 2
        oy0 = 1 if pfy == 3 else 0
        pq = win[:, int(mc.HPEL_REF0[q]), M + oy0:M + oy0 + 16, M:M + 16]
        if q & 5:
            ox1 = 1 if pfx == 3 else 0
            s1 = win[:, int(mc.HPEL_REF1[q]), M:M + 16,
                     M + ox1:M + ox1 + 16]
            pq = (pq + s1 + 1) >> 1
        pred = torch.where((phase == q)[:, None, None], pq, pred)
    return pred
