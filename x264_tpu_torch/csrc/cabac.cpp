// CABAC engine + MB-layer slice writer (host side).
//
// The arithmetic coder below is a direct implementation of the normative
// H.264 encoding process, clause 9.3.4: EncodeDecision (9.3.4.2, Figure
// 9-7), renormalization + PutBit with firstBitFlag / bitsOutstanding
// (9.3.4.3, Figures 9-8/9-9), EncodeBypass (9.3.4.4, Figure 9-10),
// EncodeTerminate + EncodeFlush (9.3.4.5/9.3.4.6, Figures 9-11/9-12).
// Output is produced bit-by-bit through PutBit and packed MSB-first into
// bytes; carries resolve through the outstanding-bit counter exactly as
// in the spec flowcharts. Tables (rangeTabLPS, transIdxMPS/LPS) are
// passed in from Python in the spec's own [pStateIdx] layout
// (x264_tpu/entropy/cabac_tables.py, spec tables 9-44/9-45).
//
// The MB-layer syntax writer plays the role of the reference's
// encoder/cabac.c:1088 x264_macroblock_write_cabac: the TPU design keeps
// analysis/transform/reconstruction on device and ships per-MB decision +
// residual tensors to this serial writer (SURVEY §7.1: "C++ host code for
// the serial entropy stage").
//
// Coverage: I slices with I16x16 and I_4x4 MBs; P slices with P_Skip,
// P_L0_16x16, P_L0_L0_16x8/8x16, I16x16 and I_4x4 MBs (intra-in-P);
// B slices with B_Skip, B_Direct/L0/L1/BI 16x16. Grows with the
// encoder's mode set.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Cabac {
    uint32_t low = 0;        // codILow
    uint32_t range = 510;    // codIRange
    int bits_outstanding = 0;
    bool first_bit = true;   // firstBitFlag (9.3.4.3: first bit skipped)
    uint32_t cur = 0;        // byte under construction, MSB-first
    int nbits = 0;           // bits filled in `cur` (0..7)
    bool of = false;         // output buffer overflow latch
    uint8_t *p = nullptr, *start = nullptr, *end = nullptr;
    uint8_t pstate[1024];    // pStateIdx per context
    uint8_t mps[1024];       // valMPS per context
    const uint8_t *lps_tab;    // rangeTabLPS, [64][4]
    const uint8_t *trans_lps;  // transIdxLPS, [64]
    const uint8_t *trans_mps;  // transIdxMPS, [64]

    bool overflow() const { return of; }

    void write_bit(uint32_t b) {
        cur = (cur << 1) | b;
        if (++nbits == 8) {
            if (p < end)
                *p++ = (uint8_t)cur;
            else
                of = true;
            nbits = 0;
            cur = 0;
        }
    }

    // PutBit(B), Figure 9-9
    void put_bit(uint32_t b) {
        if (first_bit)
            first_bit = false;
        else
            write_bit(b);
        while (bits_outstanding > 0) {
            write_bit(1 - b);
            bits_outstanding--;
        }
    }

    // RenormE, Figure 9-8
    void renorm() {
        while (range < 256) {
            if (low < 256) {
                put_bit(0);
            } else if (low >= 512) {
                low -= 512;
                put_bit(1);
            } else {
                low -= 256;
                bits_outstanding++;
            }
            range <<= 1;
            low <<= 1;
        }
    }

    // EncodeDecision, Figure 9-7
    void decision(int ctx, int b) {
        int ps = pstate[ctx];
        uint32_t rlps = lps_tab[ps * 4 + ((range >> 6) & 3)];
        range -= rlps;
        if ((uint32_t)b != mps[ctx]) {
            low += range;
            range = rlps;
            if (ps == 0) mps[ctx] ^= 1;
            pstate[ctx] = trans_lps[ps];
        } else {
            pstate[ctx] = trans_mps[ps];
        }
        renorm();
    }

    // EncodeBypass, Figure 9-10
    void bypass(int b) {
        low <<= 1;
        if (b) low += range;
        if (low >= 1024) {
            put_bit(1);
            low -= 1024;
        } else if (low < 512) {
            put_bit(0);
        } else {
            low -= 512;
            bits_outstanding++;
        }
    }

    // Exp-Golomb suffix in bypass mode (k-th order)
    void ue_bypass(int exp_bits, int val) {
        int k = exp_bits;
        while (val >= (1 << k)) {
            bypass(1);
            val -= 1 << k;
            k++;
        }
        bypass(0);
        while (k--) bypass((val >> k) & 1);
    }

    // EncodeTerminate, Figure 9-11 (b = end_of_slice_flag)
    void terminal(int b) {
        range -= 2;
        if (b) {
            low += range;
            flush();
        } else {
            renorm();
        }
    }

    // EncodeFlush, Figure 9-12, then zero-pad to the byte boundary
    // (the stop bit written by the flush is the rbsp_stop_one_bit).
    void flush() {
        range = 2;
        renorm();
        put_bit((low >> 9) & 1);
        uint32_t tail = ((low >> 7) & 3) | 1;
        write_bit((tail >> 1) & 1);
        write_bit(tail & 1);
        while (nbits != 0) write_bit(0);
    }
};

// residual context layout (spec table 9-40 via common/tables.c:1778-1791)
const int SIG_OFF[5] = {105 + 0, 105 + 15, 105 + 29, 105 + 44, 105 + 47};
const int LAST_OFF[5] = {166 + 0, 166 + 15, 166 + 29, 166 + 44, 166 + 47};
const int LVL_OFF[5] = {227 + 0, 227 + 10, 227 + 20, 227 + 30, 227 + 39};
const int CBF_BASE[5] = {85, 89, 93, 97, 101};
const int COUNT_M1[5] = {15, 14, 15, 3, 14};

const uint8_t LVL1_CTX[8] = {1, 2, 3, 4, 0, 0, 0, 0};
const uint8_t LVLGT1_CTX[8] = {5, 5, 5, 5, 6, 7, 8, 9};
const uint8_t LVL_TRANS[2][8] = {{1, 2, 3, 3, 4, 5, 6, 7},
                                 {4, 4, 4, 4, 5, 6, 7, 7}};

// residual block: sigmap + levels (reference cabac_block_residual_internal)
void block_residual(Cabac &cb, int cat, const int16_t *l, int n) {
    int count_m1 = COUNT_M1[cat];
    int last = -1;
    for (int i = 0; i < n; i++)
        if (l[i]) last = i;
    // caller guarantees cbf was 1 => last >= 0
    int16_t coeffs[16];
    int ci = -1;
    int sig = SIG_OFF[cat], lst = LAST_OFF[cat];
    for (int i = 0;; i++) {
        if (i == count_m1) {        // significance inferred at max pos
            coeffs[++ci] = l[i];
            break;
        }
        if (l[i]) {
            coeffs[++ci] = l[i];
            cb.decision(sig + i, 1);
            if (i == last) {
                cb.decision(lst + i, 1);
                break;
            }
            cb.decision(lst + i, 0);
        } else {
            cb.decision(sig + i, 0);
        }
    }
    int node = 0;
    int lvl = LVL_OFF[cat];
    for (; ci >= 0; ci--) {
        int c = coeffs[ci];
        int a = c < 0 ? -c : c;
        int ctx = LVL1_CTX[node] + lvl;
        if (a > 1) {
            cb.decision(ctx, 1);
            ctx = LVLGT1_CTX[node] + lvl;
            int m = a < 15 ? a : 15;
            for (int i = m - 2; i > 0; i--) cb.decision(ctx, 1);
            if (a < 15)
                cb.decision(ctx, 0);
            else
                cb.ue_bypass(0, a - 15);
            node = LVL_TRANS[1][node];
        } else {
            cb.decision(ctx, 0);
            node = LVL_TRANS[0][node];
        }
        cb.bypass(c < 0);
    }
}

struct MBInfo {           // per-MB state for neighbor contexts
    uint8_t coded = 0;        // inside current slice
    uint8_t intra = 0;
    uint8_t i16 = 0;          // is I16x16 (luma DC present)
    uint8_t skip = 0;
    uint8_t direct = 0;       // B_Direct (excluded from B mb_type ctx)
    uint8_t not_i4x4 = 1;     // mb_type != I_4x4 (for I mb_type ctx)
    uint8_t cpm = 0;          // chroma pred mode
    uint8_t cbp_l = 0, cbp_c = 0;
    uint8_t dc_nnz[3] = {0, 0, 0};   // luma DC, chroma U DC, chroma V DC
};

struct Slice {
    Cabac cb;
    int mbw, mbh, n;
    int slice_type;          // 0=P, 2=I
    int slice_qp;
    int last_qp, last_dqp;
    MBInfo *mbs;
    uint8_t *nnz_l;          // [mbh*4][mbw*4]
    uint8_t *nnz_c;          // [2][mbh*2][mbw*2]
    // capped |mvd| at 4x4 granularity per list/component — the mvd ctx
    // neighbors (spec 9.3.3.1.1.7) are the 4x4 blocks left/above the
    // current *partition*, which with 16x8/8x16 may be the other
    // partition of the same MB. [list][comp][mbh*4 * mbw*4]
    uint8_t *amvd4[2][2];
    // per-4x4 Intra_4x4 pred mode grid for MPM derivation (spec 8.3.1.1);
    // blocks of non-I4 MBs hold DC (2), matching the device twin
    // (entropy/cavlc_jax.py _i4_mode_codes_dev)
    uint8_t *i4m;
    // per-4x4 condTermFlag source for ref_idx ctx (spec 9.3.3.1.1.6):
    // 1 iff the cell's MB is coded inter non-skip with refIdxL0 > 0
    uint8_t *refgt0;
    int n_refs = 1;          // active L0 refs (ref_idx coded when > 1)
    int intra_in_p_base = 17;

    MBInfo &mb(int x, int y) { return mbs[y * mbw + x]; }

    int nzl(int gx, int gy, int intra_cur) {
        // luma 4x4 nnz with availability default (spec 9.3.3.1.1.9)
        if (gx < 0 || gy < 0) return intra_cur;
        return nnz_l[gy * mbw * 4 + gx] > 0;
    }
    int nzc(int pl, int gx, int gy, int intra_cur) {
        if (gx < 0 || gy < 0) return intra_cur;
        return nnz_c[(pl * mbh * 2 + gy) * mbw * 2 + gx] > 0;
    }
    int amvd(int list, int comp, int gx, int gy) {
        if (gx < 0 || gy < 0) return 0;   // out of slice -> 0
        return amvd4[list][comp][gy * mbw * 4 + gx];
    }
};

void write_cbf_and_residual(Slice &S, int x, int y, int cat,
                            const int16_t *l, int n, int nza, int nzb,
                            uint8_t *set_nnz) {
    int nnz = 0;
    for (int i = 0; i < n; i++) nnz += l[i] != 0;
    int ctx = CBF_BASE[cat] + 2 * (nzb != 0) + (nza != 0);
    S.cb.decision(ctx, nnz > 0);
    if (set_nnz) *set_nnz = (uint8_t)nnz;
    if (nnz > 0) block_residual(S.cb, cat, l, n);
}

void write_qp_delta(Slice &S, int qp, int has_residual, int i16) {
    int dqp = qp - S.last_qp;
    if (i16 && !has_residual && dqp > 0) dqp = 0;   // reference quirk
    int ctx = S.last_dqp != 0;
    S.last_dqp = dqp;
    S.last_qp += dqp;
    if (dqp != 0) {
        int val = dqp <= 0 ? -2 * dqp : 2 * dqp - 1;
        // dqp is interpreted modulo QP_MAX_SPEC+1 = 52
        if (val >= 51 && val != 52) val = 103 - val;
        int first = 1;
        while (val-- > 0) {
            S.cb.decision(60 + ctx, 1);
            ctx = first ? 2 : 3;
            first = 0;
        }
    }
    S.cb.decision(60 + ctx, 0);
}

// z-scan order of 4x4 luma blocks within an MB (coding order)
const int ZX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
const int ZY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};

void write_i16x16(Slice &S, int x, int y, int in_p, int i16_mode,
                  int chroma_mode, int cbp_l, int cbp_c, int qp,
                  const int16_t *ldc, const int16_t *lac,
                  const int16_t *cdc, const int16_t *cac) {
    Cabac &cb = S.cb;
    MBInfo &me = S.mb(x, y);
    // ---- mb_type ----
    if (in_p) {
        cb.decision(14, 1);
        int b = S.intra_in_p_base;
        cb.decision(b + 0, 1);
        cb.terminal(0);
        cb.decision(b + 1, cbp_l != 0);
        if (cbp_c == 0)
            cb.decision(b + 2, 0);
        else {
            cb.decision(b + 2, 1);
            cb.decision(b + 2, cbp_c >> 1);
        }
        cb.decision(b + 3, i16_mode >> 1);
        cb.decision(b + 3, i16_mode & 1);
    } else {
        int ctx = 0;
        if (x > 0 && S.mb(x - 1, y).coded && S.mb(x - 1, y).not_i4x4) ctx++;
        if (y > 0 && S.mb(x, y - 1).coded && S.mb(x, y - 1).not_i4x4) ctx++;
        cb.decision(3 + ctx, 1);
        cb.terminal(0);
        cb.decision(3 + 3, cbp_l != 0);
        if (cbp_c == 0)
            cb.decision(3 + 4, 0);
        else {
            cb.decision(3 + 4, 1);
            cb.decision(3 + 5, cbp_c >> 1);
        }
        cb.decision(3 + 6, i16_mode >> 1);
        cb.decision(3 + 7, i16_mode & 1);
    }
    // ---- intra_chroma_pred_mode ----
    {
        int ctx = 0;
        if (x > 0 && S.mb(x - 1, y).coded && S.mb(x - 1, y).cpm != 0) ctx++;
        if (y > 0 && S.mb(x, y - 1).coded && S.mb(x, y - 1).cpm != 0) ctx++;
        cb.decision(64 + ctx, chroma_mode > 0);
        if (chroma_mode > 0) {
            cb.decision(64 + 3, chroma_mode > 1);
            if (chroma_mode > 1) cb.decision(64 + 3, chroma_mode > 2);
        }
    }
    // ---- mb_qp_delta (always present for I16x16). The reference's
    // empty-I16 dqp suppression (encoder/cabac.c:150) is NOT applied: the
    // device deblock uses the per-MB qp map, so the signaled QP must
    // follow it even for empty MBs ----
    write_qp_delta(S, qp, 1, 1);

    // ---- luma DC (cat 0): neighbors are the I16 DC flags ----
    {
        int nza = x > 0 ? (S.mb(x - 1, y).coded ? S.mb(x - 1, y).dc_nnz[0]
                                                : 0)
                        : 1;   // unavailable + intra -> 1
        int nzb = y > 0 ? (S.mb(x, y - 1).coded ? S.mb(x, y - 1).dc_nnz[0]
                                                : 0)
                        : 1;
        if (x == 0) nza = 1;
        if (y == 0) nzb = 1;
        // available neighbor that has no luma DC block -> 0
        write_cbf_and_residual(S, x, y, 0, ldc, 16, nza, nzb,
                               &me.dc_nnz[0]);
    }
    // ---- luma AC (cat 1) if cbp_l, z-scan ----
    for (int b = 0; b < 16 && cbp_l; b++) {
        int bx = ZX[b], by = ZY[b];
        int gx = x * 4 + bx, gy = y * 4 + by;
        int nza = S.nzl(gx - 1, gy, 1);
        int nzb = S.nzl(gx, gy - 1, 1);
        uint8_t nnz;
        write_cbf_and_residual(S, x, y, 1, lac + b * 16 + 1, 15, nza, nzb,
                               &nnz);
        S.nnz_l[gy * S.mbw * 4 + gx] = nnz;
    }
    // ---- chroma DC (cat 3) if cbp_c ----
    for (int pl = 0; pl < 2 && cbp_c; pl++) {
        int nza = x > 0 ? (S.mb(x - 1, y).coded
                               ? S.mb(x - 1, y).dc_nnz[1 + pl] : 1)
                        : 1;
        int nzb = y > 0 ? (S.mb(x, y - 1).coded
                               ? S.mb(x, y - 1).dc_nnz[1 + pl] : 1)
                        : 1;
        write_cbf_and_residual(S, x, y, 3, cdc + pl * 4, 4, nza, nzb,
                               &me.dc_nnz[1 + pl]);
    }
    // ---- chroma AC (cat 4) if cbp_c == 2 ----
    for (int pl = 0; pl < 2 && cbp_c == 2; pl++)
        for (int b = 0; b < 4; b++) {
            int gx = x * 2 + (b & 1), gy = y * 2 + (b >> 1);
            int nza = S.nzc(pl, gx - 1, gy, 1);
            int nzb = S.nzc(pl, gx, gy - 1, 1);
            uint8_t nnz;
            write_cbf_and_residual(S, x, y, 4,
                                   cac + (pl * 4 + b) * 16 + 1, 15,
                                   nza, nzb, &nnz);
            S.nnz_c[(pl * S.mbh * 2 + gy) * S.mbw * 2 + gx] = nnz;
        }
    me.intra = 1;
    me.i16 = 1;
    me.not_i4x4 = 1;
    me.cpm = (uint8_t)chroma_mode;
    me.cbp_l = (uint8_t)cbp_l;
    me.cbp_c = (uint8_t)cbp_c;
    me.coded = 1;
}

void write_cbp_dqp_residual(Slice &S, int x, int y, MBInfo &me, int cbp_l,
                            int cbp_c, int qp, const int16_t *lraw,
                            const int16_t *cdc, const int16_t *cac,
                            int intra = 0);

void write_chroma_pred_mode(Slice &S, int x, int y, int chroma_mode) {
    int ctx = 0;
    if (x > 0 && S.mb(x - 1, y).coded && S.mb(x - 1, y).cpm != 0) ctx++;
    if (y > 0 && S.mb(x, y - 1).coded && S.mb(x, y - 1).cpm != 0) ctx++;
    S.cb.decision(64 + ctx, chroma_mode > 0);
    if (chroma_mode > 0) {
        S.cb.decision(64 + 3, chroma_mode > 1);
        if (chroma_mode > 1) S.cb.decision(64 + 3, chroma_mode > 2);
    }
}

void write_i4x4(Slice &S, int x, int y, int in_p, const uint8_t *modes,
                int chroma_mode, int cbp_l, int cbp_c, int qp,
                const int16_t *lraw, const int16_t *cdc,
                const int16_t *cac) {
    // I_4x4 MB: mb_type, 16 prev/rem pred modes (spec 8.3.1.1 MPM,
    // 9.3.3.1.1.10 ctx 68/69), chroma mode, cbp-coded residual (cat 2
    // LumaLevel4x4 with intra availability defaults). `modes` is raster
    // block order within the MB; `lraw` z-scan zigzagged blocks.
    Cabac &cb = S.cb;
    MBInfo &me = S.mb(x, y);
    if (in_p) {
        cb.decision(14, 1);                  // intra prefix in P
        cb.decision(S.intra_in_p_base + 0, 0);   // I_NxN suffix '0'
    } else {
        int ctx = 0;
        if (x > 0 && S.mb(x - 1, y).coded && S.mb(x - 1, y).not_i4x4) ctx++;
        if (y > 0 && S.mb(x, y - 1).coded && S.mb(x, y - 1).not_i4x4) ctx++;
        cb.decision(3 + ctx, 0);             // I_NxN
    }
    // (transform_size_8x8_flag absent: high profile not signaled)
    int gw = S.mbw * 4;
    for (int b = 0; b < 16; b++) {           // z-scan coding order
        int gx = x * 4 + ZX[b], gy = y * 4 + ZY[b];
        int mode = modes[ZY[b] * 4 + ZX[b]];
        int mpm = 2;                         // edge -> DC (8.3.1.1)
        if (gx > 0 && gy > 0) {
            int a = S.i4m[gy * gw + gx - 1];
            int bb = S.i4m[(gy - 1) * gw + gx];
            mpm = a < bb ? a : bb;
        }
        if (mode == mpm) {
            cb.decision(68, 1);              // prev_intra4x4_pred_mode
        } else {
            cb.decision(68, 0);
            int rem = mode - (mode > mpm);
            cb.decision(69, rem & 1);        // FL, LSB first (9.3.2.5)
            cb.decision(69, (rem >> 1) & 1);
            cb.decision(69, (rem >> 2) & 1);
        }
        S.i4m[gy * gw + gx] = (uint8_t)mode;
    }
    write_chroma_pred_mode(S, x, y, chroma_mode);
    me.cpm = (uint8_t)chroma_mode;
    write_cbp_dqp_residual(S, x, y, me, cbp_l, cbp_c, qp, lraw, cdc, cac,
                           /*intra=*/1);
    me.dc_nnz[0] = 0;                        // no luma DC block
}

void write_ref_idx_part(Slice &S, int x, int y, int ref, int px, int py,
                        int pw, int ph) {
    // ref_idx_l0 for one partition: U binarization, bin0 ctx 54 +
    // condTermFlagA + 2*condTermFlagB (spec 9.3.3.1.1.6, table 9-39:
    // binIdx1 -> ctx 58, binIdx>=2 -> ctx 59). (px,py,pw,ph) in 4x4
    // units within the MB; the neighbors are the blocks left/above the
    // partition's top-left block (the top 16x8 partition's B neighbor
    // can be the same MB's other partition, already written below).
    Cabac &cb = S.cb;
    int gw = S.mbw * 4;
    int gx = x * 4 + px, gy = y * 4 + py;
    int condA = gx > 0 ? S.refgt0[gy * gw + gx - 1] : 0;
    int condB = gy > 0 ? S.refgt0[(gy - 1) * gw + gx] : 0;
    int ctx = 54 + condA + 2 * condB;
    if (ref == 0) {
        cb.decision(ctx, 0);
    } else {
        cb.decision(ctx, 1);
        int b = 1;
        for (; b < ref; b++) cb.decision(b == 1 ? 58 : 59, 1);
        cb.decision(b == 1 ? 58 : 59, 0);
    }
    for (int by = py; by < py + ph; by++)
        for (int bx = px; bx < px + pw; bx++)
            S.refgt0[(y * 4 + by) * gw + x * 4 + bx] = ref > 0;
}

void write_mvd_part(Slice &S, int x, int y, int list, const int16_t *mvd,
                    int px, int py, int pw, int ph) {
    // mvd components for one partition: ctxIdxInc from the |mvd| sum of
    // the 4x4 blocks left/above the partition's top-left block (spec
    // 9.3.3.1.1.7; with sub-MB partitions the neighbor can be the other
    // partition of the same MB). (px,py,pw,ph) in 4x4 units within MB.
    Cabac &cb = S.cb;
    int gx = x * 4 + px, gy = y * 4 + py;
    for (int c = 0; c < 2; c++) {
        int amvd = S.amvd(list, c, gx - 1, gy) + S.amvd(list, c, gx, gy - 1);
        int ctx = (amvd > 2) + (amvd > 32);
        int base = c ? 47 : 40;
        int v = mvd[c];
        int a = v < 0 ? -v : v;
        if (a == 0) {
            cb.decision(base + ctx, 0);
        } else {
            static const uint8_t ctxes[8] = {3, 4, 5, 6, 6, 6, 6, 6};
            cb.decision(base + ctx, 1);
            if (a < 9) {
                for (int i = 1; i < a; i++)
                    cb.decision(base + ctxes[i - 1], 1);
                cb.decision(base + ctxes[a - 1], 0);
            } else {
                for (int i = 1; i < 9; i++)
                    cb.decision(base + ctxes[i - 1], 1);
                cb.ue_bypass(3, a - 9);
            }
            cb.bypass(v < 0);
        }
        uint8_t cap = (uint8_t)(a < 66 ? a : 66);
        for (int by = py; by < py + ph; by++)
            for (int bx = px; bx < px + pw; bx++)
                S.amvd4[list][c][(y * 4 + by) * S.mbw * 4 + x * 4 + bx]
                    = cap;
    }
}

void write_mvd_list(Slice &S, MBInfo &, int x, int y, int list,
                    const int16_t *mvd) {
    write_mvd_part(S, x, y, list, mvd, 0, 0, 4, 4);
}

void write_cbp_dqp_residual(Slice &S, int x, int y, MBInfo &me, int cbp_l,
                            int cbp_c, int qp, const int16_t *lraw,
                            const int16_t *cdc, const int16_t *cac,
                            int intra) {
    Cabac &cb = S.cb;
    // ---- cbp ----
    {
        int cl = x > 0 && S.mb(x - 1, y).coded
                     ? (S.mb(x - 1, y).cbp_l | (S.mb(x - 1, y).cbp_c << 4))
                     : -1;
        int ct = y > 0 && S.mb(x, y - 1).coded
                     ? (S.mb(x, y - 1).cbp_l | (S.mb(x, y - 1).cbp_c << 4))
                     : -1;
        int cbp = cbp_l;
        cb.decision(76 - ((cl >> 1) & 1) - ((ct >> 1) & 2), (cbp >> 0) & 1);
        cb.decision(76 - ((cbp >> 0) & 1) - ((ct >> 2) & 2), (cbp >> 1) & 1);
        cb.decision(76 - ((cl >> 3) & 1) - ((cbp << 1) & 2), (cbp >> 2) & 1);
        cb.decision(76 - ((cbp >> 2) & 1) - ((cbp >> 0) & 2), (cbp >> 3) & 1);
        int ca = cl == -1 ? 0 : (cl & 0x30);
        int cbb = ct == -1 ? 0 : (ct & 0x30);
        int ctx = (ca != 0) + 2 * (cbb != 0);
        if (cbp_c == 0) {
            cb.decision(77 + ctx, 0);
        } else {
            cb.decision(77 + ctx, 1);
            ctx = 4 + (ca == 0x20) + 2 * (cbb == 0x20);
            cb.decision(77 + ctx, cbp_c >> 1);
        }
    }
    if (cbp_l || cbp_c)
        write_qp_delta(S, qp, 1, 0);
    else
        S.last_dqp = 0;

    for (int b = 0; b < 16; b++) {
        int bx = ZX[b], by = ZY[b];
        int quad = (by >> 1) * 2 + (bx >> 1);
        int gx = x * 4 + bx, gy = y * 4 + by;
        if (cbp_l & (1 << quad)) {
            int nza = S.nzl(gx - 1, gy, intra);
            int nzb = S.nzl(gx, gy - 1, intra);
            uint8_t nnz;
            write_cbf_and_residual(S, x, y, 2, lraw + b * 16, 16, nza, nzb,
                                   &nnz);
            S.nnz_l[gy * S.mbw * 4 + gx] = nnz;
        } else {
            S.nnz_l[gy * S.mbw * 4 + gx] = 0;
        }
    }
    for (int pl = 0; pl < 2 && cbp_c; pl++) {
        int nza = x > 0 ? (S.mb(x - 1, y).coded
                               ? S.mb(x - 1, y).dc_nnz[1 + pl] : intra)
                        : intra;
        int nzb = y > 0 ? (S.mb(x, y - 1).coded
                               ? S.mb(x, y - 1).dc_nnz[1 + pl] : intra)
                        : intra;
        write_cbf_and_residual(S, x, y, 3, cdc + pl * 4, 4, nza, nzb,
                               &me.dc_nnz[1 + pl]);
    }
    for (int pl = 0; pl < 2 && cbp_c == 2; pl++)
        for (int b = 0; b < 4; b++) {
            int gx = x * 2 + (b & 1), gy = y * 2 + (b >> 1);
            int nza = S.nzc(pl, gx - 1, gy, intra);
            int nzb = S.nzc(pl, gx, gy - 1, intra);
            uint8_t nnz;
            write_cbf_and_residual(S, x, y, 4,
                                   cac + (pl * 4 + b) * 16 + 1, 15,
                                   nza, nzb, &nnz);
            S.nnz_c[(pl * S.mbh * 2 + gy) * S.mbw * 2 + gx] = nnz;
        }
    me.intra = (uint8_t)intra;
    me.i16 = 0;
    me.not_i4x4 = (uint8_t)!intra;
    if (!intra) me.cpm = 0;
    me.cbp_l = (uint8_t)cbp_l;
    me.cbp_c = (uint8_t)cbp_c;
    me.coded = 1;
}

void write_p_inter(Slice &S, int x, int y, int part, int refidx,
                   const int16_t *mvd, const int16_t *mvd2, int cbp_l,
                   int cbp_c, int qp, const int16_t *lraw,
                   const int16_t *cdc, const int16_t *cac) {
    // part: 0=P_L0_16x16 '000', 1=P_L0_L0_16x8 '011', 2=P_L0_L0_8x16
    // '010' (spec table 9-34 P binarization; ctxIdx 14/15/16|17).
    // With n_refs > 1, ref_idx_l0 is coded once per partition (both
    // partitions share one reference here), all ref_idx before all mvd
    // (spec 7.3.5.1 mb_pred order).
    Cabac &cb = S.cb;
    MBInfo &me = S.mb(x, y);
    int two = S.n_refs > 1;
    cb.decision(14, 0);
    if (part == 0) {
        cb.decision(15, 0);
        cb.decision(16, 0);
        if (two) write_ref_idx_part(S, x, y, refidx, 0, 0, 4, 4);
        write_mvd_part(S, x, y, 0, mvd, 0, 0, 4, 4);
    } else if (part == 1) {          // 16x8: two stacked partitions
        cb.decision(15, 1);
        cb.decision(17, 1);
        if (two) {
            write_ref_idx_part(S, x, y, refidx, 0, 0, 4, 2);
            write_ref_idx_part(S, x, y, refidx, 0, 2, 4, 2);
        }
        write_mvd_part(S, x, y, 0, mvd, 0, 0, 4, 2);
        write_mvd_part(S, x, y, 0, mvd2, 0, 2, 4, 2);
    } else {                         // 8x16: two side-by-side partitions
        cb.decision(15, 1);
        cb.decision(17, 0);
        if (two) {
            write_ref_idx_part(S, x, y, refidx, 0, 0, 2, 4);
            write_ref_idx_part(S, x, y, refidx, 2, 0, 2, 4);
        }
        write_mvd_part(S, x, y, 0, mvd, 0, 0, 2, 4);
        write_mvd_part(S, x, y, 0, mvd2, 2, 0, 2, 4);
    }
    write_cbp_dqp_residual(S, x, y, me, cbp_l, cbp_c, qp, lraw, cdc, cac);
}

void write_b16x16(Slice &S, int x, int y, int bmode, const int16_t *mvd0,
                  const int16_t *mvd1, int cbp_l, int cbp_c, int qp,
                  const int16_t *lraw, const int16_t *cdc,
                  const int16_t *cac) {
    // bmode: 0=L0, 1=L1, 2=BI, 3=DIRECT (reference cabac_mb_header_b
    // with partition D_16x16; ctx excludes B_SKIP/B_DIRECT neighbors,
    // encoder/cabac.c:502)
    Cabac &cb = S.cb;
    MBInfo &me = S.mb(x, y);
    int ctx = 0;
    if (x > 0 && S.mb(x - 1, y).coded && !S.mb(x - 1, y).skip
        && !S.mb(x - 1, y).direct)
        ctx++;
    if (y > 0 && S.mb(x, y - 1).coded && !S.mb(x, y - 1).skip
        && !S.mb(x, y - 1).direct)
        ctx++;
    if (bmode == 3) {                    // B_Direct_16x16
        cb.decision(27 + ctx, 0);
        me.direct = 1;
        write_cbp_dqp_residual(S, x, y, me, cbp_l, cbp_c, qp, lraw, cdc,
                               cac);
        return;
    }
    cb.decision(27 + ctx, 1);            // not B_Direct
    if (bmode == 0) {                    // B_L0_16x16: '100'
        cb.decision(27 + 3, 0);
        cb.decision(27 + 5, 0);
    } else if (bmode == 1) {             // B_L1_16x16: '101'
        cb.decision(27 + 3, 0);
        cb.decision(27 + 5, 1);
    } else {                             // B_Bi_16x16: '110000'
        cb.decision(27 + 3, 1);
        cb.decision(27 + 4, 0);
        cb.decision(27 + 5, 0);
        cb.decision(27 + 5, 0);
        cb.decision(27 + 5, 0);
    }
    // (single ref per list: no ref_idx)
    if (bmode != 1) write_mvd_list(S, me, x, y, 0, mvd0);
    if (bmode != 0) write_mvd_list(S, me, x, y, 1, mvd1);
    write_cbp_dqp_residual(S, x, y, me, cbp_l, cbp_c, qp, lraw, cdc, cac);
}

}  // namespace

extern "C" {

// Returns bytes written, or -1 on buffer overflow.
// All arrays are length n = mbw*mbh in raster order unless noted.
int cabac_encode_slice(
    const uint8_t *init_pstate,   // [1024] initial pStateIdx (9.3.1.1)
    const uint8_t *init_mps,      // [1024] initial valMPS
    const uint8_t *range_lps,     // [64*4] rangeTabLPS (table 9-44)
    const uint8_t *trans_mps,     // [64] transIdxMPS (table 9-45)
    const uint8_t *trans_lps,     // [64] transIdxLPS (table 9-45)
    int slice_type,               // 0=P, 1=B, 2=I
    int mbw, int mbh, int slice_qp,
    const uint8_t *skip,          // [n] P_Skip flags
    const uint8_t *is_intra,      // [n] intra flag (1 in I slices)
    const uint8_t *is_i4,         // [n] intra MB is I_4x4 (else I16x16)
    const uint8_t *i4_modes,      // [n*16] I4 pred modes, raster blocks
    const uint8_t *i16_mode,      // [n]
    const uint8_t *chroma_mode,   // [n]
    const uint8_t *cbp_luma,      // [n] 0..15
    const uint8_t *cbp_chroma,    // [n] 0..2
    const int8_t *qp,             // [n] per-MB qp
    const uint8_t *bmode,         // [n] B: 0=L0 1=L1 2=BI
    const uint8_t *part_mode,     // [n] P: 0=16x16 1=16x8 2=8x16
    const uint8_t *refidx,        // [n] P L0 refIdx per MB (or NULL)
    int n_refs,                   // active L0 refs (te ref_idx if > 1)
    const int16_t *mvd,           // [n*2] (list0 / P partition 0)
    const int16_t *mvd1,          // [n*2] (list1, B / P partition 1)
    const int16_t *luma_dc,       // [n*16]    zigzag (I16 MBs)
    const int16_t *luma_ac,       // [n*16*16] zigzag, z-scan blocks
    const int16_t *chroma_dc,     // [n*2*4]
    const int16_t *chroma_ac,     // [n*8*16]  zigzag, (pl,blk) raster
    uint8_t *out, int out_cap)
{
    int n = mbw * mbh;
    Slice S;
    S.mbw = mbw;
    S.mbh = mbh;
    S.n = n;
    S.slice_type = slice_type;
    S.slice_qp = slice_qp;
    S.last_qp = slice_qp;
    S.last_dqp = 0;
    S.cb.lps_tab = range_lps;
    S.cb.trans_mps = trans_mps;
    S.cb.trans_lps = trans_lps;
    std::memcpy(S.cb.pstate, init_pstate, 1024);
    std::memcpy(S.cb.mps, init_mps, 1024);
    S.cb.start = S.cb.p = out;
    S.cb.end = out + out_cap;
    S.mbs = (MBInfo *)std::calloc(n, sizeof(MBInfo));
    S.nnz_l = (uint8_t *)std::calloc(mbh * 4 * mbw * 4, 1);
    S.nnz_c = (uint8_t *)std::calloc(2 * mbh * 2 * mbw * 2, 1);
    S.i4m = (uint8_t *)std::malloc(mbh * 4 * mbw * 4);
    std::memset(S.i4m, 2, mbh * 4 * mbw * 4);   // non-I4 blocks -> DC
    S.refgt0 = (uint8_t *)std::calloc(mbh * 4 * mbw * 4, 1);
    S.n_refs = n_refs > 0 ? n_refs : 1;
    uint8_t *amvd_buf = (uint8_t *)std::calloc(4 * mbh * 4 * mbw * 4, 1);
    for (int li = 0; li < 2; li++)
        for (int ci = 0; ci < 2; ci++)
            S.amvd4[li][ci] = amvd_buf + (li * 2 + ci) * mbh * 4 * mbw * 4;

    for (int y = 0; y < mbh; y++) {
        for (int x = 0; x < mbw; x++) {
            int i = y * mbw + x;
            if (S.cb.overflow()) goto overflow;
            if (slice_type != 2) {
                // mb_skip_flag (ctx 11.. for P, 24.. for B)
                int ctx = slice_type == 1 ? 24 : 11;
                if (x > 0 && S.mb(x - 1, y).coded && !S.mb(x - 1, y).skip)
                    ctx++;
                if (y > 0 && S.mb(x, y - 1).coded && !S.mb(x, y - 1).skip)
                    ctx++;
                S.cb.decision(ctx, skip[i]);
                if (skip[i]) {
                    MBInfo &me = S.mb(x, y);
                    me = MBInfo();
                    me.coded = 1;
                    me.skip = 1;
                    me.not_i4x4 = 1;
                    S.last_dqp = 0;
                    // zero nnz for neighbors
                    for (int b = 0; b < 16; b++)
                        S.nnz_l[(y * 4 + ZY[b]) * mbw * 4 + x * 4 + ZX[b]]
                            = 0;
                    for (int pl = 0; pl < 2; pl++)
                        for (int b = 0; b < 4; b++)
                            S.nnz_c[(pl * mbh * 2 + y * 2 + (b >> 1))
                                        * mbw * 2 + x * 2 + (b & 1)] = 0;
                    S.cb.terminal(i == n - 1);
                    continue;
                }
            }
            if (is_intra[i] && is_i4 && is_i4[i]) {
                write_i4x4(S, x, y, slice_type == 0, i4_modes + i * 16,
                           chroma_mode[i], cbp_luma[i], cbp_chroma[i],
                           qp[i], luma_ac + i * 16 * 16,
                           chroma_dc + i * 8, chroma_ac + i * 8 * 16);
            } else if (is_intra[i]) {
                write_i16x16(S, x, y, slice_type == 0, i16_mode[i],
                             chroma_mode[i], cbp_luma[i], cbp_chroma[i],
                             qp[i], luma_dc + i * 16,
                             luma_ac + i * 16 * 16, chroma_dc + i * 8,
                             chroma_ac + i * 8 * 16);
            } else if (slice_type == 1) {
                write_b16x16(S, x, y, bmode[i], mvd + i * 2,
                             mvd1 + i * 2, cbp_luma[i], cbp_chroma[i],
                             qp[i], luma_ac + i * 16 * 16,
                             chroma_dc + i * 8, chroma_ac + i * 8 * 16);
            } else {
                write_p_inter(S, x, y, part_mode[i],
                              refidx ? refidx[i] : 0, mvd + i * 2,
                              mvd1 + i * 2, cbp_luma[i],
                              cbp_chroma[i], qp[i], luma_ac + i * 16 * 16,
                              chroma_dc + i * 8, chroma_ac + i * 8 * 16);
            }
            // end_of_slice_flag: 1 on the last MB triggers EncodeFlush
            S.cb.terminal(i == n - 1);
        }
    }
    if (S.cb.overflow()) goto overflow;
    {
        int written = (int)(S.cb.p - out);
        std::free(S.mbs);
        std::free(S.nnz_l);
        std::free(S.nnz_c);
        std::free(S.i4m);
        std::free(S.refgt0);
        std::free(amvd_buf);
        return written;
    }
overflow:
    std::free(S.mbs);
    std::free(S.nnz_l);
    std::free(S.nnz_c);
    std::free(S.i4m);
    std::free(S.refgt0);
    std::free(amvd_buf);
    return -1;
}

}  // extern "C"
