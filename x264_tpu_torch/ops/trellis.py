"""Trellis (RD-optimal) quantization: batched Viterbi over CABAC states
(x264_tpu/ops/trellis.py; reference encoder/rdo.c:642 quant_trellis_cabac).

The dynamic program is the reference's 8-node Viterbi per 4x4 block, run
for ALL blocks of a frame at once: 16 steps in reverse zigzag order, each
relaxing 8 node-contexts x 2 candidate levels (q-1, q) with per-lane
costs. x264_tpu runs the steps as one lax.scan; here they are a Python
loop over the same positions in the same order, with the float32
operations in the same order (and the one fused multiply-add XLA makes of
them), so that the argmin over float32 scores picks the same levels.

Cost model (same units as the reference):
  score = sum(d^2 * w2[pos]) + lambda2 * bits
where d is the transform-domain reconstruction error, w2 converts
transform-domain SSD to pixel-domain SSD (w2 = 50/(ni*nj) with ni the
squared norms {4,10} of the forward-transform rows), and lambda2 follows
tables.c:133: inter 0.85^2 * 2^(qp/3+2), intra 0.65^2 * 2^(qp/3+2).

The 8 node-contexts summarize the spec's coeff_abs_level_minus1 context
increment rules (9.3.3.1.3): node 0 = nothing nonzero yet, nodes 1-3 =
1/2/3+ trailing ones seen, nodes 4-7 = 1/2/3/4+ levels >1 seen. Contexts
{0, 4, 8, 9} of the abs-level family can repeat along a path and are
tracked per node (4 packed states); contexts 1,2,3,5,6,7 are one-shot
and read from the slice-init states.

Bit costs derive from the CABAC engine's design probability model
(Marpe et al., IEEE CSVT 2003): p_LPS(s) = 0.5 * alpha^s with
alpha = (0.01875/0.5)^(1/63); cost of a bin = -log2(p(bin)).
State packing: s = (pStateIdx << 1) | valMPS, so s ^ bin has its low
bit = "is LPS" and high bits = pStateIdx.

The tables below are the numpy expressions of the original, unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import const
from ..entropy import cabac_tables as CT
from ..entropy.cabac_host import init_states
from ..utils import trace
from . import tables
from ._cuda import to_device

# --------------------------------------------------------------- tables
_ALPHA = (0.01875 / 0.5) ** (1.0 / 63.0)
_P_LPS = 0.5 * _ALPHA ** np.arange(64)

# ENT[(pstate<<1) | is_lps] = bits to code that bin
ENT = np.empty(128, np.float32)
ENT[0::2] = -np.log2(1.0 - _P_LPS)
ENT[1::2] = -np.log2(_P_LPS)

# NEXT[s, b] = state after coding bin b in state s = (pstate<<1)|mps
NEXT = np.empty((128, 2), np.int32)
for _s in range(128):
    _ps, _mps = _s >> 1, _s & 1
    for _b in (0, 1):
        if _b == _mps:
            NEXT[_s, _b] = (int(CT.TRANS_IDX_MPS[_ps]) << 1) | _mps
        else:
            _nm = (1 - _mps) if _ps == 0 else _mps
            NEXT[_s, _b] = (int(CT.TRANS_IDX_LPS[_ps]) << 1) | _nm


def _cost_bin(s, b):
    return float(ENT[s ^ b])


# UNARY_COST[prefix][s]: bits for the abs_level>1 unary part — (prefix-1)
# ones + terminating 0 (if prefix<14) in one adapting context + 1 sign
# bypass bit (reference x264_rdo_init, rdo.c:384). Row 0 unused.
UNARY_COST = np.zeros((15, 128), np.float32)
UNARY_TRANS = np.zeros((15, 128), np.int32)
for _p in range(15):
    for _s0 in range(128):
        _s, _bits = _s0, 0.0
        for _i in range(1, _p):
            _bits += _cost_bin(_s, 1)
            _s = int(NEXT[_s, 1])
        if 0 < _p < 14:
            _bits += _cost_bin(_s, 0)
            _s = int(NEXT[_s, 0])
        UNARY_COST[_p, _s0] = _bits + 1.0
        UNARY_TRANS[_p, _s0] = _s

# pixel-domain SSD weights per zigzag position of a 4x4 block: rows of
# the forward transform have squared norms {4,10,4,10}; w2 = 50/(ni*nj)
# (matches x264_dct4_weight2_tab's FIX8(3.125/1.25/0.5) pattern)
_N2 = np.array([4.0, 10.0, 4.0, 10.0])
_W2_RASTER = 50.0 / (_N2[:, None] * _N2[None, :])          # [4,4]
W2_ZIG4 = _W2_RASTER.reshape(16)[tables.ZIGZAG4_FRAME].astype(np.float32)

# unquant_mf: direct .8 fixed-point inverse of the forward quant scale
# (NOT the spec dequant — reference set.c unquant4_mf), per qp, per
# zigzag position
UNQ4_ZIG = np.empty((64, 16), np.int32)
for _qp in range(64):
    _mf = tables.QUANT4_MF[_qp % 6].reshape(16).astype(np.int64)
    _unq = ((1 << (_qp // 6 + 15 + 8)) + _mf // 2) // _mf
    UNQ4_ZIG[_qp] = _unq[tables.ZIGZAG4_FRAME]

# trellis lambda2 in our float units. Reference units: score =
# d^2 * FIX8(w) + bits*256 * lam2_tab >> 4 with lam2_tab =
# c^2 * 2^(qp/3 + 10 - LAMBDA_BITS=4). Dividing the whole score by 256
# (our w2 = FIX8(w)/256): bits term = bits * c^2 * 2^(qp/3+10) / 256 =
# bits * c^2 * 2^(qp/3 + 2).
LAM2_INTER = (0.85 ** 2 * 2.0 ** (np.arange(64) / 3.0 + 2.0)
              ).astype(np.float32)
LAM2_INTRA = (0.65 ** 2 * 2.0 ** (np.arange(64) / 3.0 + 2.0)
              ).astype(np.float32)

# node machine (8-state summary of spec 9.3.3.1.3 ctxIdxInc rules for
# coeff_abs_level_minus1; same layout as rdo.c trellis_coef1_*/coefn_*)
_T1 = np.array([1, 2, 3, 3, 4, 5, 6, 7], np.int32)     # target after L==1
_TN = np.array([4, 4, 4, 4, 5, 6, 7, 7], np.int32)     # target after L>1
_L1CTX = np.array([1, 2, 3, 4, 0, 0, 0, 0], np.int32)  # bin0 ctx per node
# gt1 ctx per source node (9 = luma levelgt1; chroma-dc passes 8)
_GT1CTX_LUMA = np.array([5, 5, 5, 5, 6, 7, 8, 9], np.int32)

_INF = np.float32(1e30)

# context family bases (clause 9.3.3.1.3 / Table 9-40), as in
# native/cabac.cpp:157-159
SIG_OFF = [105 + 0, 105 + 15, 105 + 29, 105 + 44, 105 + 47]
LAST_OFF = [166 + 0, 166 + 15, 166 + 29, 166 + 44, 166 + 47]
LVL_OFF = [227 + 0, 227 + 10, 227 + 20, 227 + 30, 227 + 39]


def frame_ctx_costs(slice_type_i: bool, slice_qp: int, cat: int,
                    model: int = 0):
    """Host-side per-frame constants: sig/last flag costs per position
    (from slice-init states; flags use one fixed context per position in
    4x4 blocks so no adaptation is needed — rdo.c comment at :757) and
    the 10 packed init states of the abs-level context family.

    Returns (sig_cost [16,2] f32, last_cost [16,2] f32,
             lvl_states [10] int32)."""
    pstate, mps = init_states(slice_type_i, slice_qp, model)
    packed = (pstate.astype(np.int32) << 1) | mps.astype(np.int32)
    sig = np.zeros((16, 2), np.float32)
    last = np.zeros((16, 2), np.float32)
    for i in range(15):                      # position 15 has no flags
        s = packed[SIG_OFF[cat] + i]
        sl = packed[LAST_OFF[cat] + i]
        sig[i] = (ENT[s ^ 0], ENT[s ^ 1])
        last[i] = (ENT[sl ^ 0], ENT[sl ^ 1])
    lvl = packed[LVL_OFF[cat]:LVL_OFF[cat] + 10].astype(np.int32)
    return sig, last, lvl


@trace.spanned("entropy:trellis")
def trellis_4x4(lv_z, w_z, qp, sig_cost, last_cost, lvl_states,
                intra: bool = False, b_ac: int = 0,
                dc_block: bool = False):
    """RD-optimal requantization of deadzone levels (rdo.c:642 as one
    Viterbi over all blocks).

    lv_z    [N,16] int32 signed deadzone levels, zigzag order
    w_z     [N,16] int32 original transform coefficients, zigzag order
    qp      [N]    int32 per-block QP (per-MB AQ aware)
    sig_cost/last_cost [16,2] f32, lvl_states [10] int32 (numpy, from
            frame_ctx_costs; they are host constants of the frame)
    Returns ([N,16] int32 re-quantized signed levels in zigzag order,
             [N] f32 winning RD score).
    """
    N = lv_z.shape[0]
    dev = lv_z.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    sig_cost = np.asarray(sig_cost, np.float32)
    last_cost = np.asarray(last_cost, np.float32)
    frozen = [int(s) for s in np.asarray(lvl_states)]
    q_abs = lv_z.abs().to(i32)
    c_abs = w_z.abs().to(f32)
    sgn = torch.sign(w_z).to(i32)
    qpl = qp.to(i64)

    unq = const(UNQ4_ZIG, dev)[qpl]                           # [N,16]
    lam2 = const(LAM2_INTRA if intra else LAM2_INTER, dev, f32)[qpl]
    ent = const(ENT, dev, f32)
    nxt = const(NEXT, dev)
    ucost = const(UNARY_COST, dev, f32)
    utrans = const(UNARY_TRANS, dev)
    t1 = const(_T1, dev)
    tn = const(_TN, dev)
    ar8 = torch.arange(8, device=dev)
    j0 = ar8 == 0                                             # [8]
    jj = ar8.to(i32)[None, None, :]
    slots = torch.arange(4, device=dev)[None, None, :]
    node_is7 = ar8[None, :] == 7
    inf = to_device(_INF, dev, "trellis_init", dtype=f32)

    def full(v):
        return torch.full((N,), v, dtype=i32, device=dev)

    # init: node 0 alive; tracked abs-level states = init of ctx
    # {0,4,8,9} for every node
    score = torch.full((N, 8), float(_INF), dtype=f32, device=dev)
    score[:, 0] = 0.0
    levels = torch.zeros((N, 8, 16), dtype=i32, device=dev)
    lst = to_device([frozen[0], frozen[4], frozen[8], frozen[9]], dev,
                    "trellis_init", dtype=i32).expand(N, 8, 4)

    for i in range(15, b_ac - 1, -1):
        q = q_abs[:, i]                                       # [N]
        c = c_abs[:, i]
        u = unq[:, i]                                         # [N] int32
        wgt = float(W2_ZIG4[i])
        sc0, sc1 = float(sig_cost[i, 0]), float(sig_cost[i, 1])
        lc0, lc1 = float(last_cost[i, 0]), float(last_cost[i, 1])

        cand_L = torch.stack([(q - 1).clamp(min=0), q], dim=1)    # [N,2]
        dq_i = (u[:, None] * cand_L + 128) >> 8
        dq = dq_i.to(f32)                                         # [N,2]
        d = c[:, None] - dq
        ssd = d * d * wgt                                         # [N,2]
        if not dc_block and b_ac == 0 and i == 0:
            # DC rounding optimization for DC-only blocks
            # (rdo.c:838: recon rounds DC to a multiple of 16)
            dqr = (((dq_i + 8) >> 4) << 4).to(f32)
            d0 = c[:, None] - dqr
            ssd_n0 = d0 * d0 * wgt
        else:
            ssd_n0 = ssd
        is_zero = cand_L == 0                                     # [N,2]
        gt1 = (cand_L > 1).to(i32)                                # [N,2]
        prefix = (cand_L - 1).clamp(max=14)                       # [N,2]
        # EG0 suffix for abs_level >= 15: 2*floor(log2(L-14)) + 1 bits.
        # frexp gives the exact floor(log2) on the CPU and on the card
        lm = (cand_L - 14).clamp(min=1).to(f32)
        flog = (torch.frexp(lm).exponent - 1).to(f32)
        suffix = torch.where(cand_L >= 15, 2.0 * flog + 1.0, 0.0)

        # per source node j: bin0 state and gt1 state  [N,8]
        bin0_st = torch.stack(
            [full(frozen[1]), full(frozen[2]), full(frozen[3]),
             lst[:, 3, 1], lst[:, 4, 0], lst[:, 5, 0], lst[:, 6, 0],
             lst[:, 7, 0]], dim=1)
        gt1_st = torch.stack(
            [full(frozen[5]), full(frozen[5]), full(frozen[5]),
             full(frozen[5]), full(frozen[6]), full(frozen[7]),
             lst[:, 6, 2], lst[:, 7, 3]], dim=1)

        # bits for each (k candidate, j source): [N,2,8]
        bits_bin0 = ent[(bin0_st[:, None, :] ^ gt1[:, :, None]).long()]
        # prefix is -1 where the candidate is 0: that entry is never used
        bits_un = (ucost[prefix.clamp(min=0)[:, :, None].long(),
                         gt1_st[:, None, :].long()] + suffix[:, :, None])
        bits_lvl = bits_bin0 + torch.where(gt1[:, :, None] == 1,
                                           bits_un, 1.0)
        bits_nz = (sc1 + torch.where(j0, lc1, lc0)[None, None, :]
                   + bits_lvl)
        bits_z = torch.where(j0, 0.0, sc0)[None, None, :]
        bits = torch.where(is_zero[:, :, None], bits_z, bits_nz)

        ssd_jk = torch.where(j0[None, None, :], ssd_n0[:, :, None],
                             ssd[:, :, None])                     # [N,2,8]
        # XLA contracts `(score + ssd) + lam2 * bits` into one fused
        # multiply-add on the CPU: the product is not rounded before the
        # add. float64 holds the float32 product exactly, so rounding the
        # float64 sum once gives the fused result, on the CPU and on the
        # card alike (two float32 roundings move 1 score in 4 by an ulp)
        cand_sc = ((score[:, None, :] + ssd_jk).double()
                   + lam2[:, None, None].double() * bits.double()
                   ).to(f32)                                      # [N,2,8]

        # transition targets [N,2,8]
        tgt = torch.where(is_zero[:, :, None], jj,
                          torch.where((cand_L == 1)[:, :, None],
                                      t1[None, None, :], tn[None, None, :]))

        flat_sc = cand_sc.reshape(N, 16)
        flat_tgt = tgt.reshape(N, 16)
        onehot = flat_tgt[:, :, None] == jj
        masked = torch.where(onehot, flat_sc[:, :, None], inf)
        # ties go to the first (candidate, source node) in flat order
        score, kstar = masked.min(dim=1)                          # [N,8]
        src_j = kstar % 8
        ck = kstar // 8                                           # cand idx
        Lwin = torch.gather(cand_L, 1, ck)                        # [N,8]

        levels = torch.gather(levels, 1,
                              src_j[:, :, None].expand(N, 8, 16))
        levels[:, :, i] = Lwin

        new_lst = torch.gather(lst, 1, src_j[:, :, None].expand(N, 8, 4))
        # adaptive writes (rdo.c trellis_coef state updates):
        # bin0 transition when src node >= 3 and a level was coded
        b0s = torch.gather(bin0_st, 1, src_j)                     # [N,8]
        g1w = (Lwin > 1).long()
        b0n = nxt[b0s.long(), g1w]
        slot_l1 = torch.where(src_j == 3, 1, 0)
        do_l1 = (src_j >= 3) & (Lwin > 0)
        new_lst = torch.where(
            do_l1[:, :, None] & (slots == slot_l1[:, :, None]),
            b0n[:, :, None], new_lst)
        # gt1 unary transition when landing on node 7 with L > 1
        g1s = torch.gather(gt1_st, 1, src_j)
        pwin = torch.gather(prefix, 1, ck).clamp(min=0)
        g1n = utrans[pwin.long(), g1s.long()]
        do_g1 = node_is7 & (Lwin > 1)
        slot_g1 = torch.where(src_j == 6, 2, 3)
        lst = torch.where(
            do_g1[:, :, None] & (slots == slot_g1[:, :, None]),
            g1n[:, :, None], new_lst)
        # dead targets keep dead scores; their levels/states are junk
        # but never read (score stays INF)

    best_sc, best = score.min(dim=1)                              # [N]
    out = torch.gather(levels, 1, best[:, None, None].expand(N, 1, 16))[:, 0]
    # node 0 = empty block
    out = torch.where((best == 0)[:, None], 0, out)
    return out * sgn, best_sc
