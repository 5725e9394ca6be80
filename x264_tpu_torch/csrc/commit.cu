// Wavefront intra commit for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel x264_tpu/ops/pallas/commit.py ::
// commit_i16_pallas (kernel body _make_kernel). Bit-exact twin of
// x264_tpu/encoder/intra.py::_commit_scan and of the plain PyTorch
// version x264_tpu_torch/ops/commit.py::commit_ref.
//
// What it computes: the exact intra reconstruction of a frame, MB by MB
// in an order where each MB's left, top and top-left neighbours come
// first. Per MB: I16x16 prediction from the reconstructed neighbours,
// sixteen 4x4 forward integer DCTs, the 4x4 luma-DC Hadamard, deadzone
// quant, spec 8.5.10-12 dequant, inverse transform and clip; 4:2:0 chroma
// with the 2x2 DC Hadamard; optional I_4x4 lanes (each 4x4 block predicted
// from its reconstructed neighbours, levels in the "ac" slot with dc = 0);
// optional mixed lanes (intra-in-P) that copy the inter reconstruction and
// write zero levels.
//
// What bounds it on this card: the dependency chain, not bytes or
// operations. A 1080p frame moves about 20 MB (sources, reconstruction,
// levels, per-MB modes: 6 us at 3.35 TB/s) and does about 8 x 10^7
// integer operations, but MB (x, y) needs its left, top and top-left
// neighbours reconstructed first, so at least mbw + mbh - 1 = 187 MB
// steps run one after another, and inside an I_4x4 MB the sixteen 4x4
// blocks form a chain of their own.
//
// commit_frame_kernel, the main path: one persistent cooperative launch
// per batch of B items of one shape (B frames of B streams, or the
// slice bands of frames, each band committed as a frame of its own: its
// row 0 reads no row above). The blocks walk the B * mbh global rows
// r = item * mbh + row; each row waits only on row r - 1 of its own item,
// a lower global row, so the walk cannot deadlock. B = 1 launches the
// kernel's single-frame instance, which has no item arithmetic (the
// batched one does it once per row). Each block walks whole MB rows left
// to right and waits,
// before MB x, on a progress word that the row above publishes after each
// MB (release store / acquire load; the top edge is then read past L1),
// so one slow I_4x4 MB delays only what depends on it. A waiter warp does
// the polling and loads the top edge, and a releaser warp publishes,
// while the compute warps work. The left neighbour is the block's own
// previous MB and stays in shared memory; the next MB's source tile,
// inter tile, modes and QPs are copied in with cp.async while the current
// MB computes. Inside the MB, luma (warps 0-7) and chroma (warps 8-11)
// run side by side on named barriers; the 4x4 transforms, Hadamards and
// prediction sums are warp shuffles; I_4x4 runs as a wavefront over
// bx + 2 by, 10 steps of two blocks in one warp, with __syncwarp between
// steps. A wait that runs past its bound sets an error word and the
// blocks leave, so nothing hangs.
//
// Tensor cores do not fit: the 4x4 transforms are exact integer
// butterflies of 16 values. The f32 matmul form of the Pallas kernel
// (x264_tpu/ops/pallas/commit.py:76-86) exists only because Mosaic has
// no int32 matmul.
//
// commit_diag_kernel, kept from the first port only so that a run on the
// card can time the two designs side by side: one launch per
// anti-diagonal, one 256-thread block per MB, neighbours read from the
// planes that earlier launches finished.
//
// Unavailable neighbour pixels read as 0, matching the zero-initialised
// planes of the JAX scan. The kernels allocate nothing.

#include <cstdint>
#include <cuda_runtime.h>

struct CommitArgs {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
  const int32_t* i16_mode;     // [mbh*mbw]
  const int32_t* chroma_mode;  // [mbh*mbw]
  const int32_t* qp;           // [mbh*mbw]
  const int32_t* qpc;          // [mbh*mbw]
  const uint8_t* i4_mask;      // [mbh*mbw] or null
  const int32_t* i4_modes;     // [mbh*mbw*16] raster blocks, or null
  const uint8_t* is_intra;     // [mbh*mbw] or null (all intra)
  const uint8_t* iy;           // inter reconstruction (with is_intra)
  const uint8_t* iu;
  const uint8_t* iv;
  const int32_t* tab;          // QUANT4_MF[6][16], DEQUANT4_MF[6][16],
                               // QUANT4_SCALE[6][0], DEQUANT4_SCALE[6][0]
  uint8_t* ry;
  uint8_t* ru;
  uint8_t* rv;
  int32_t* dc;   // [n][4][4]
  int32_t* ac;   // [n][16][4][4]
  int32_t* udc;  // [n][2][2]
  int32_t* uac;  // [n][4][4][4]
  int32_t* vdc;
  int32_t* vac;
  // item strides in elements, for items stacked along a leading axis
  int64_t s_luma;    // y, iy, ry
  int64_t s_chroma;  // u, v, iu, iv, ru, rv
  int64_t s_map;     // i16_mode, chroma_mode, qp, qpc, i4_mask, is_intra
  int64_t s_i4m;     // i4_modes
  int64_t s_dc;
  int64_t s_ac;
  int64_t s_cdc;     // udc, vdc
  int64_t s_cac;     // uac, vac
  int32_t mbw;
  int32_t mbh;
  int32_t items;     // B; commit_diag_kernel takes item 0 only
};

namespace {

__constant__ int kCF[4][4] = {
    {1, 1, 1, 1}, {2, 1, -1, -2}, {1, -1, -1, 1}, {1, -2, 2, -1}};
__constant__ int kH4[4][4] = {
    {1, 1, 1, 1}, {1, 1, -1, -1}, {1, -1, -1, 1}, {1, -1, 1, -1}};
__constant__ int kZX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
__constant__ int kZY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
// above-right kind per raster block: 0 none (substitute t[3]), 1 lane
// (available iff the MB's top is), 2 real
__constant__ int kKind[16] = {1, 1, 1, 0, 2, 0, 2, 0,
                              2, 2, 2, 0, 2, 0, 2, 0};

__device__ __forceinline__ int clip255(int x) { return min(max(x, 0), 255); }
__device__ __forceinline__ int sgn(int x) { return (x > 0) - (x < 0); }

// deadzone quant: sign(w) * ((|w| * mf + f) >> qbits)
__device__ __forceinline__ int quant(int w, int mf, int qbits, int f) {
  return sgn(w) * ((abs(w) * mf + f) >> qbits);
}

// spec 8.5.12.1: (lv * mf16) << shift, or rounded >> -shift
__device__ __forceinline__ int dequant(int lv, int mf16, int shift) {
  int l32 = lv * mf16;
  if (shift >= 0) return l32 * (1 << shift);
  return (l32 + (1 << (-shift - 1))) >> (-shift);
}

__device__ __forceinline__ int sel4(int k, int v0, int v1, int v2, int v3) {
  return k == 0 ? v0 : k == 1 ? v1 : k == 2 ? v2 : v3;
}

// one stage of the spec inverse core: output k of inputs a0..a3
__device__ __forceinline__ int inv1d(int a0, int a1, int a2, int a3, int k) {
  int e0 = a0 + a2, e1 = a0 - a2;
  int e2 = (a1 >> 1) - a3, e3 = a1 + (a3 >> 1);
  switch (k) {
    case 0: return e0 + e3;
    case 1: return e1 + e2;
    case 2: return e1 - e2;
    default: return e0 - e3;
  }
}

// the same, without branches (the frame kernel's lanes differ in k)
__device__ __forceinline__ int inv1d_sel(int a0, int a1, int a2, int a3,
                                         int k) {
  const int e0 = a0 + a2, e1 = a0 - a2;
  const int e2 = (a1 >> 1) - a3, e3 = a1 + (a3 >> 1);
  return sel4(k, e0 + e3, e1 + e2, e1 - e2, e0 - e3);
}

// forward core transform of the 4x4 block at (r0, c0) of a row-major
// plane with row stride `ld`: coefficient (i, j)
__device__ __forceinline__ int fdct(const int* x, int ld, int r0, int c0,
                                    int i, int j) {
  int acc = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    int row = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) row += x[(r0 + p) * ld + c0 + q] * kCF[j][q];
    acc += kCF[i][p] * row;
  }
  return acc;
}

// 4x4 directional / DC prediction at (x, y) of mode m from the edge vector
// e = [l3,l2,l1,l0, tl, t0..t7, t7] and its filtered f3 / h2 (mirrors
// ops/predict.predict_4x4_all)
__device__ int pred4(int m, int x, int y, const int* e, const int* f3,
                     const int* h2, int dcv) {
  switch (m) {
    case 0: return e[5 + x];
    case 1: return e[3 - y];
    case 2: return dcv;
    case 3: return f3[6 + x + y];
    case 4: return f3[4 + x - y];
    case 5: {
      int zvr = 2 * x - y, i = 4 + x - (y >> 1);
      if (zvr == -3) return f3[2];
      if (zvr >= 0 && (zvr & 1) == 0) return h2[i];
      return f3[i];
    }
    case 6: {
      int zhd = 2 * y - x;
      if (zhd < -1) return f3[3 + x];
      if ((zhd & 1) == 0) return h2[max(3 - (y - (x >> 1)), 0)];
      return f3[max(4 - y + (x >> 1), 1)];
    }
    case 7:
      if ((y & 1) == 0) return h2[5 + x + (y >> 1)];
      return f3[6 + x + (y >> 1)];
    default: {
      int zhu = x + 2 * y, ilow = 2 - y - (x >> 1);
      if (zhu > 5) return e[0];
      if (zhu == 5) return (e[1] + 3 * e[0] + 2) >> 2;
      if ((zhu & 1) == 0) return h2[max(ilow, 0)];
      return f3[max(ilow, 1)];
    }
  }
}

__global__ void __launch_bounds__(256)
commit_diag_kernel(CommitArgs a, int d, int y0) {
  const int t = threadIdx.x;
  const int mby = y0 + blockIdx.x;
  const int mbx = d - mby;
  const int W = 16 * a.mbw, Wc = 8 * a.mbw;
  const int mb = mby * a.mbw + mbx;
  const bool al = mbx > 0, at = mby > 0;
  const int* qmf = a.tab;            // [6][16]
  const int* dmf = a.tab + 96;       // [6][16]
  const int* qsc = a.tab + 192;      // [6]
  const int* dsc = a.tab + 198;      // [6]

  const int luma_base = (16 * mby) * W + 16 * mbx;
  const int chroma_base = (8 * mby) * Wc + 8 * mbx;

  if (a.is_intra != nullptr && a.is_intra[mb] == 0) {
    // mixed lane: copy the inter reconstruction, zero levels
    const int py = t >> 4, px = t & 15;
    a.ry[luma_base + py * W + px] = a.iy[luma_base + py * W + px];
    a.ac[mb * 256 + t] = 0;
    if (t < 16) a.dc[mb * 16 + t] = 0;
    if (t < 128) {
      const int c = t >> 6, p = t & 63;
      const int off = chroma_base + (p >> 3) * Wc + (p & 7);
      (c ? a.rv : a.ru)[off] = (c ? a.iv : a.iu)[off];
      (c ? a.vac : a.uac)[mb * 64 + p] = 0;
      if (p < 4) (c ? a.vdc : a.udc)[mb * 4 + p] = 0;
    }
    return;
  }

  __shared__ int s_top[16], s_left[16], s_tl;
  __shared__ int s_src[256], s_pred[256], s_buf[256], s_buf2[256];
  __shared__ int s_dc[16], s_par[4];
  __shared__ int s_ext[17 * 21], s_e[14], s_f3[14], s_h2[14];

  const int qp = a.qp[mb];
  const int qrem = qp % 6, qper = qp / 6;

  // ------------------------------------------------------------- luma
  {
    const int py = t >> 4, px = t & 15;
    s_src[t] = a.y[luma_base + py * W + px];
    if (t < 16)
      s_top[t] = at ? a.ry[luma_base - W + t] : 0;
    else if (t < 32)
      s_left[t - 16] = al ? a.ry[luma_base + (t - 16) * W - 1] : 0;
    else if (t == 32)
      s_tl = (al && at) ? a.ry[luma_base - W - 1] : 0;
  }
  __syncthreads();

  const bool i4 = a.i4_mask != nullptr && a.i4_mask[mb] != 0;
  if (!i4) {
    // ---- I16x16 ----
    const int mode = a.i16_mode[mb];
    if (t == 0) {
      int sum_t = 0, sum_l = 0, hg = 0, vg = 0;
      for (int k = 0; k < 16; ++k) {
        sum_t += s_top[k];
        sum_l += s_left[k];
      }
      for (int x = 1; x <= 8; ++x) {
        hg += x * (s_top[7 + x] - (x < 8 ? s_top[7 - x] : s_tl));
        vg += x * (s_left[7 + x] - (x < 8 ? s_left[7 - x] : s_tl));
      }
      s_par[0] = (at && al) ? (sum_t + sum_l + 16) >> 5
                 : at       ? (sum_t + 8) >> 4
                 : al       ? (sum_l + 8) >> 4
                            : 128;
      s_par[1] = 16 * (s_left[15] + s_top[15]);
      s_par[2] = (5 * hg + 32) >> 6;
      s_par[3] = (5 * vg + 32) >> 6;
    }
    __syncthreads();
    {
      const int py = t >> 4, px = t & 15;
      int p;
      switch (mode) {
        case 0: p = s_top[px]; break;
        case 1: p = s_left[py]; break;
        case 2: p = s_par[0]; break;
        default:
          p = clip255((s_par[1] + s_par[2] * (px - 7) + s_par[3] * (py - 7)
                       + 16) >> 5);
      }
      s_pred[t] = p;
      s_buf[t] = s_src[t] - p;          // residual, pixel layout
    }
    __syncthreads();
    // thread t -> raster block b, coefficient (i, j)
    const int b = t >> 4, k = t & 15, i = k >> 2, j = k & 3;
    const int bx = b & 3, by = b >> 2;
    const int w = fdct(s_buf, 16, 4 * by, 4 * bx, i, j);
    s_buf2[t] = w;                      // coefficient layout [b][k]
    __syncthreads();
    if (t < 16) {
      // luma DC: Hadamard of the raster DC grid, >> 1, quant (qbits + 1)
      const int r = t >> 2, c = t & 3;
      int acc = 0;
      for (int p = 0; p < 4; ++p) {
        int row = 0;
        for (int q = 0; q < 4; ++q)
          row += s_buf2[(p * 4 + q) * 16] * kH4[c][q];
        acc += kH4[r][p] * row;
      }
      const int had = acc >> 1;
      const int qb = 16 + qper;
      const int lv = quant(had, qsc[qrem], qb, (21 << qb) >> 6);
      a.dc[mb * 16 + t] = lv;
      s_dc[t] = lv;
    }
    {
      const int qb = 15 + qper;
      const int lv = k == 0 ? 0 : quant(w, qmf[qrem * 16 + k], qb,
                                        (21 << qb) >> 6);
      a.ac[mb * 256 + t] = lv;
      s_buf[t] = dequant(lv, dmf[qrem * 16 + k] << 4, qper - 4);
    }
    __syncthreads();
    if (t < 16) {
      // inverse Hadamard + spec 8.5.10 DC dequant
      const int r = t >> 2, c = t & 3;
      int acc = 0;
      for (int p = 0; p < 4; ++p) {
        int row = 0;
        for (int q = 0; q < 4; ++q) row += s_dc[p * 4 + q] * kH4[c][q];
        acc += kH4[r][p] * row;
      }
      const int l32 = acc * (dsc[qrem] << 4);
      s_buf2[t] = qper >= 6 ? l32 * (1 << (qper - 6))
                            : (l32 + (1 << (5 - qper))) >> (6 - qper);
    }
    __syncthreads();
    if (k == 0) s_buf[t] = s_buf2[b];   // block b's DC = dc_vals[by][bx]
    __syncthreads();
    // inverse transform: stage along rows-of-coefficients first (axis -2)
    {
      const int* dd = s_buf + b * 16;
      s_buf2[t] = inv1d(dd[j], dd[4 + j], dd[8 + j], dd[12 + j], i);
    }
    __syncthreads();
    {
      const int* hh = s_buf2 + b * 16 + i * 4;
      const int r = (inv1d(hh[0], hh[1], hh[2], hh[3], j) + 32) >> 6;
      const int py = 4 * by + i, px = 4 * bx + j;
      a.ry[luma_base + py * W + px] =
          (uint8_t)clip255(s_pred[py * 16 + px] + r);
    }
  } else {
    // ---- I_4x4: 16 z-scan block steps on the [17][21] edge buffer ----
    for (int idx = t; idx < 17 * 21; idx += 256) s_ext[idx] = 0;
    __syncthreads();
    if (t < 16) {
      s_ext[1 + t] = s_top[t];
      s_ext[(1 + t) * 21] = s_left[t];
    } else if (t == 16) {
      s_ext[0] = s_tl;
    }
    if (t < 16) a.dc[mb * 16 + t] = 0;
    __syncthreads();
    const int qb = 15 + qper;
    const int fq = (21 << qb) >> 6;
    for (int z = 0; z < 16; ++z) {
      const int bx = kZX[z], by = kZY[z];
      const int r = 4 * by + bx, r4 = 4 * by, c4 = 4 * bx;
      if (t < 14) {
        int val;
        if (t < 4) {
          val = s_ext[(r4 + 1 + (3 - t)) * 21 + c4];
        } else if (t == 4) {
          val = s_ext[r4 * 21 + c4];
        } else {
          const int kk0 = t == 13 ? 7 : t - 5;
          const int kind = kKind[r];
          const bool tr_ok = kind == 2 || (kind == 1 && at);
          const int kk = (kk0 < 4 || tr_ok) ? kk0 : 3;
          val = s_ext[r4 * 21 + c4 + 1 + kk];
        }
        s_e[t] = val;
      }
      __syncthreads();
      if (t < 14) {
        s_f3[t] = (t == 0 || t == 13)
                      ? 0 : (s_e[t - 1] + 2 * s_e[t] + s_e[t + 1] + 2) >> 2;
        s_h2[t] = t == 13 ? 0 : (s_e[t] + s_e[t + 1] + 1) >> 1;
      }
      __syncthreads();
      if (t < 16) {
        const int x = t & 3, yy = t >> 2;
        const bool al_b = bx > 0 || al, at_b = by > 0 || at;
        const int sum_t = s_e[5] + s_e[6] + s_e[7] + s_e[8];
        const int sum_l = s_e[0] + s_e[1] + s_e[2] + s_e[3];
        const int dcv = (at_b && al_b) ? (sum_t + sum_l + 4) >> 3
                        : at_b         ? (sum_t + 2) >> 2
                        : al_b         ? (sum_l + 2) >> 2
                                       : 128;
        const int m = a.i4_modes[mb * 16 + r];
        const int p = pred4(m, x, yy, s_e, s_f3, s_h2, dcv);
        s_pred[t] = p;
        s_buf[t] = s_src[(r4 + yy) * 16 + c4 + x] - p;
      }
      __syncthreads();
      if (t < 16) {
        const int i = t >> 2, j = t & 3;
        const int w = fdct(s_buf, 4, 0, 0, i, j);
        const int lv = quant(w, qmf[qrem * 16 + t], qb, fq);
        a.ac[mb * 256 + r * 16 + t] = lv;
        s_buf2[t] = dequant(lv, dmf[qrem * 16 + t] << 4, qper - 4);
      }
      __syncthreads();
      if (t < 16) {
        const int i = t >> 2, j = t & 3;
        s_buf[16 + t] = inv1d(s_buf2[j], s_buf2[4 + j], s_buf2[8 + j],
                              s_buf2[12 + j], i);
      }
      __syncthreads();
      if (t < 16) {
        const int i = t >> 2, j = t & 3;
        const int* hh = s_buf + 16 + i * 4;
        const int rr = (inv1d(hh[0], hh[1], hh[2], hh[3], j) + 32) >> 6;
        s_ext[(r4 + 1 + i) * 21 + c4 + 1 + j] = clip255(s_pred[t] + rr);
      }
      __syncthreads();
    }
    const int py = t >> 4, px = t & 15;
    a.ry[luma_base + py * W + px] = (uint8_t)s_ext[(1 + py) * 21 + 1 + px];
  }
  __syncthreads();

  // ----------------------------------------------------------- chroma
  // threads 0..127: component c = t >> 6 (U, V), pixel / coeff p = t & 63
  const int qpc = a.qpc[mb];
  const int crem = qpc % 6, cper = qpc / 6;
  const uint8_t* csrc_plane[2] = {a.u, a.v};
  uint8_t* crec_plane[2] = {a.ru, a.rv};
  int* s_ctop = s_ext;          // [2][8]
  int* s_cleft = s_ext + 16;    // [2][8]
  int* s_ctl = s_ext + 32;      // [2]
  int* s_cpar = s_ext + 40;     // [2][8]
  int* s_cdc = s_ext + 64;      // [2][4]
  int* s_cdcv = s_ext + 72;     // [2][4]
  if (t < 16) {
    const int c = t >> 3, k = t & 7;
    s_ctop[t] = at ? crec_plane[c][chroma_base - Wc + k] : 0;
  } else if (t < 32) {
    const int c = (t - 16) >> 3, k = t & 7;
    s_cleft[t - 16] = al ? crec_plane[c][chroma_base + k * Wc - 1] : 0;
  } else if (t < 34) {
    const int c = t - 32;
    s_ctl[c] = (al && at) ? crec_plane[c][chroma_base - Wc - 1] : 0;
  }
  if (t < 128) {
    const int c = t >> 6, p = t & 63;
    s_src[t] = csrc_plane[c][chroma_base + (p >> 3) * Wc + (p & 7)];
  }
  __syncthreads();
  if (t < 2) {
    const int* top = s_ctop + 8 * t;
    const int* left = s_cleft + 8 * t;
    const int tl = s_ctl[t];
    const int st0 = top[0] + top[1] + top[2] + top[3];
    const int st1 = top[4] + top[5] + top[6] + top[7];
    const int sl0 = left[0] + left[1] + left[2] + left[3];
    const int sl1 = left[4] + left[5] + left[6] + left[7];
    // quadrant DCs: (0,0) both, (0,1) prefers top, (1,0) prefers left,
    // (1,1) both
    s_cpar[8 * t + 0] = (at && al) ? (st0 + sl0 + 4) >> 3
                        : at       ? (st0 + 2) >> 2
                        : al       ? (sl0 + 2) >> 2 : 128;
    s_cpar[8 * t + 1] = at ? (st1 + 2) >> 2 : al ? (sl0 + 2) >> 2 : 128;
    s_cpar[8 * t + 2] = al ? (sl1 + 2) >> 2 : at ? (st0 + 2) >> 2 : 128;
    s_cpar[8 * t + 3] = (at && al) ? (st1 + sl1 + 4) >> 3
                        : at       ? (st1 + 2) >> 2
                        : al       ? (sl1 + 2) >> 2 : 128;
    int hg = 0, vg = 0;
    for (int x = 1; x <= 4; ++x) {
      hg += x * (top[3 + x] - (x < 4 ? top[3 - x] : tl));
      vg += x * (left[3 + x] - (x < 4 ? left[3 - x] : tl));
    }
    s_cpar[8 * t + 4] = 16 * (left[7] + top[7]);
    s_cpar[8 * t + 5] = (17 * hg + 16) >> 5;
    s_cpar[8 * t + 6] = (17 * vg + 16) >> 5;
  }
  __syncthreads();
  const int cmode = a.chroma_mode[mb];
  const int c = t >> 6, p = t & 63;
  const int cb = p >> 4, ck = p & 15, ci = ck >> 2, cj = ck & 3;
  const int cbx = cb & 1, cby = cb >> 1;
  if (t < 128) {
    const int py = p >> 3, px = p & 7;
    const int* par = s_cpar + 8 * c;
    int pr;
    switch (cmode) {
      case 0: pr = par[(py >> 2) * 2 + (px >> 2)]; break;
      case 1: pr = s_cleft[8 * c + py]; break;
      case 2: pr = s_ctop[8 * c + px]; break;
      default:
        pr = clip255((par[4] + par[5] * (px - 3) + par[6] * (py - 3) + 16)
                     >> 5);
    }
    s_pred[t] = pr;
    s_buf[t] = s_src[t] - pr;
  }
  __syncthreads();
  int cw = 0;
  if (t < 128) {
    cw = fdct(s_buf + 64 * c, 8, 4 * cby, 4 * cbx, ci, cj);
    s_buf2[t] = cw;
  }
  __syncthreads();
  if (t < 8) {
    // 2x2 DC Hadamard + quant (qbits + 1)
    const int cc = t >> 2, e = t & 3;
    const int* w = s_buf2 + 64 * cc;
    const int x00 = w[0], x01 = w[16], x10 = w[32], x11 = w[48];
    const int had = e == 0 ? x00 + x01 + x10 + x11
                    : e == 1 ? x00 - x01 + x10 - x11
                    : e == 2 ? x00 + x01 - x10 - x11
                             : x00 - x01 - x10 + x11;
    const int qb = 16 + cper;
    const int lv = quant(had, qsc[crem], qb, (21 << qb) >> 6);
    (cc ? a.vdc : a.udc)[mb * 4 + e] = lv;
    s_cdc[t] = lv;
  }
  if (t < 128) {
    const int qb = 15 + cper;
    const int lv = ck == 0 ? 0 : quant(cw, qmf[crem * 16 + ck], qb,
                                       (21 << qb) >> 6);
    (c ? a.vac : a.uac)[mb * 64 + p] = lv;
    s_buf[t] = dequant(lv, dmf[crem * 16 + ck] << 4, cper - 4);
  }
  __syncthreads();
  if (t < 8) {
    // inverse 2x2 Hadamard + spec 8.5.11 DC dequant
    const int cc = t >> 2, e = t & 3;
    const int* l = s_cdc + 4 * cc;
    const int f = e == 0 ? l[0] + l[1] + l[2] + l[3]
                  : e == 1 ? l[0] - l[1] + l[2] - l[3]
                  : e == 2 ? l[0] + l[1] - l[2] - l[3]
                           : l[0] - l[1] - l[2] + l[3];
    s_cdcv[t] = ((f * (dsc[crem] << 4)) * (1 << cper)) >> 5;
  }
  __syncthreads();
  if (t < 128 && ck == 0) s_buf[t] = s_cdcv[4 * c + cb];
  __syncthreads();
  if (t < 128) {
    const int* dd = s_buf + 64 * c + cb * 16;
    s_buf2[t] = inv1d(dd[cj], dd[4 + cj], dd[8 + cj], dd[12 + cj], ci);
  }
  __syncthreads();
  if (t < 128) {
    const int* hh = s_buf2 + 64 * c + cb * 16 + ci * 4;
    const int r = (inv1d(hh[0], hh[1], hh[2], hh[3], cj) + 32) >> 6;
    const int py = 4 * cby + ci, px = 4 * cbx + cj;
    crec_plane[c][chroma_base + py * Wc + px] =
        (uint8_t)clip255(s_pred[64 * c + py * 8 + px] + r);
  }
}

// ====================================================================
// commit_frame_kernel: one persistent, row-synchronised launch per frame
// ====================================================================

constexpr int kLumaThreads = 256;   // warps 0-7: one thread per luma pixel
constexpr int kChromaThreads = 128; // warps 8-11: U then V, one per pixel
constexpr int kComputeThreads = kLumaThreads + kChromaThreads;
constexpr int kWaiterWarp = 12;     // polls the row above, loads top edges
constexpr int kReleaserWarp = 13;   // publishes this row's progress
constexpr int kThreads = kComputeThreads + 64;
// named barriers: kBarStart (compute + waiter sync, releaser arrives)
// opens an MB; kBarDone (compute arrive, releaser syncs) closes it
constexpr int kBarStart = 1, kBarDone = 2, kBarLuma = 3, kBarChroma = 4;
constexpr int kSpinLimit = 1 << 22;           // polls before a wait fails
constexpr unsigned kFull = 0xffffffffu;

// kKind, two bits per raster block
constexpr unsigned kKindBits = 0x222a2215u;

struct FrameSmem {
  // per-MB inputs, double-buffered: MB n + 1 lands while MB n computes
  alignas(16) uint8_t src_y[2][256];
  alignas(16) uint8_t src_c[2][2][64];
  alignas(16) uint8_t int_y[2][256];   // inter reconstruction (mixed)
  alignas(16) uint8_t int_c[2][2][64];
  alignas(16) int i4m[2][16];
  // i16_mode, chroma_mode, qp, qpc, then the 4-byte words of i4_mask and
  // is_intra that hold this MB's byte: the compute warps read no global
  // memory
  int prm[2][6];
  // right column of the previous MB (this block's own), by MB parity
  int left[2][16];
  int cleft[2][2][8];
  int tab[208];                        // quant tables, as CommitArgs::tab
  int ext[17 * 21];                    // I_4x4 edge buffer, as PR 1's
  int dcw[16], dcv[16];                // luma DC coefficients / values
  int cdcw[2][4];                      // chroma DC coefficients
  // the MB's top edges and top-left pixels (luma, U, V), 0 where
  // unavailable, and whether to abort; written by the waiter warp
  int top[2][16], ctop[2][2][8], tl[2][3], abort[2];
  int quit;                            // compute warps to the releaser
};

__device__ __forceinline__ void bar_named(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// a reconstructed pixel of another block: read at L2, past this SM's L1,
// which may hold a line from before that block wrote it
__device__ __forceinline__ int ldcg_u8(const uint8_t* p) {
  unsigned v;
  asm volatile("ld.global.cg.u8 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return (int)v;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Lane k = 4 i + j of a 16-lane group holds x[i][j] of one 4x4 block.
// Forward core transform W = CF X CF^T, coefficient (i, j) per lane.
__device__ __forceinline__ int fdct_lanes(int x, int i, int j) {
  const int a0 = __shfl_sync(kFull, x, 4 * i + 0, 16);
  const int a1 = __shfl_sync(kFull, x, 4 * i + 1, 16);
  const int a2 = __shfl_sync(kFull, x, 4 * i + 2, 16);
  const int a3 = __shfl_sync(kFull, x, 4 * i + 3, 16);
  // row pass: T[i][j] = sum_q X[i][q] CF[j][q]
  int s03 = a0 + a3, d03 = a0 - a3, s12 = a1 + a2, d12 = a1 - a2;
  const int tr = sel4(j, s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12);
  const int b0 = __shfl_sync(kFull, tr, 0 + j, 16);
  const int b1 = __shfl_sync(kFull, tr, 4 + j, 16);
  const int b2 = __shfl_sync(kFull, tr, 8 + j, 16);
  const int b3 = __shfl_sync(kFull, tr, 12 + j, 16);
  // column pass: W[i][j] = sum_p CF[i][p] T[p][j]
  s03 = b0 + b3, d03 = b0 - b3, s12 = b1 + b2, d12 = b1 - b2;
  return sel4(i, s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12);
}

// The 4x4 Hadamard H V H^T in the same layout (H = kH4).
__device__ __forceinline__ int had4_lanes(int x, int i, int j) {
  const int a0 = __shfl_sync(kFull, x, 4 * i + 0, 16);
  const int a1 = __shfl_sync(kFull, x, 4 * i + 1, 16);
  const int a2 = __shfl_sync(kFull, x, 4 * i + 2, 16);
  const int a3 = __shfl_sync(kFull, x, 4 * i + 3, 16);
  const int tr = sel4(j, a0 + a1 + a2 + a3, a0 + a1 - a2 - a3,
                      a0 - a1 - a2 + a3, a0 - a1 + a2 - a3);
  const int b0 = __shfl_sync(kFull, tr, 0 + j, 16);
  const int b1 = __shfl_sync(kFull, tr, 4 + j, 16);
  const int b2 = __shfl_sync(kFull, tr, 8 + j, 16);
  const int b3 = __shfl_sync(kFull, tr, 12 + j, 16);
  return sel4(i, b0 + b1 + b2 + b3, b0 + b1 - b2 - b3, b0 - b1 - b2 + b3,
              b0 - b1 + b2 - b3);
}

// Where pred4 finds the value of mode m at (x, y), as a flat index into
// [e | f3 | h2] (16 entries each), with f3[14] = mode 8's
// (e1 + 3 e0 + 2) >> 2 and f3[15] = the DC value: no branches.
__device__ __forceinline__ int pred4_index(int m, int x, int y) {
  constexpr int F = 16, H = 32;
  const int zvr = 2 * x - y, i5 = 4 + x - (y >> 1);
  const int m5 = zvr == -3                         ? F + 2
                 : (zvr >= 0 && (zvr & 1) == 0)    ? H + i5
                                                   : F + i5;
  const int zhd = 2 * y - x;
  const int m6 = zhd < -1          ? F + 3 + x
                 : (zhd & 1) == 0  ? H + max(3 - (y - (x >> 1)), 0)
                                   : F + max(4 - y + (x >> 1), 1);
  const int m7 = (y & 1) == 0 ? H + 5 + x + (y >> 1) : F + 6 + x + (y >> 1);
  const int zhu = x + 2 * y, ilow = 2 - y - (x >> 1);
  const int m8 = zhu > 5          ? 0
                 : zhu == 5       ? F + 14
                 : (zhu & 1) == 0 ? H + max(ilow, 0)
                                  : F + max(ilow, 1);
  return m == 0   ? 5 + x
         : m == 1 ? 3 - y
         : m == 2 ? F + 15
         : m == 3 ? F + 6 + x + y
         : m == 4 ? F + 4 + x - y
         : m == 5 ? m5
         : m == 6 ? m6
         : m == 7 ? m7
                  : m8;
}

// Inverse core transform of dequantised levels, rounded (+32 >> 6): the
// stage along axis -2 first, then along axis -1, as the JAX twin does.
__device__ __forceinline__ int idct_lanes(int d, int i, int j) {
  const int c0 = __shfl_sync(kFull, d, 0 + j, 16);
  const int c1 = __shfl_sync(kFull, d, 4 + j, 16);
  const int c2 = __shfl_sync(kFull, d, 8 + j, 16);
  const int c3 = __shfl_sync(kFull, d, 12 + j, 16);
  const int h = inv1d_sel(c0, c1, c2, c3, i);
  const int r0 = __shfl_sync(kFull, h, 4 * i + 0, 16);
  const int r1 = __shfl_sync(kFull, h, 4 * i + 1, 16);
  const int r2 = __shfl_sync(kFull, h, 4 * i + 2, 16);
  const int r3 = __shfl_sync(kFull, h, 4 * i + 3, 16);
  return (inv1d_sel(r0, r1, r2, r3, j) + 32) >> 6;
}

// The arguments of item `item` of the batch: every plane, map and output
// advanced by its item stride (the tables are shared; a null pointer
// stays null). Without kBatched (a batch of one) they are `a` itself, so
// the single-frame kernel reads its pointers from the parameter space.
template <typename T>
__device__ __forceinline__ T* item_ptr(T* p, int item, long long stride) {
  return p == nullptr ? p : p + item * stride;
}

template <bool kBatched>
__device__ __forceinline__ CommitArgs item_args(const CommitArgs& a,
                                                int item) {
  if (!kBatched) return a;
  CommitArgs r = a;
  r.y = item_ptr(a.y, item, a.s_luma);
  r.iy = item_ptr(a.iy, item, a.s_luma);
  r.ry = item_ptr(a.ry, item, a.s_luma);
  r.u = item_ptr(a.u, item, a.s_chroma);
  r.v = item_ptr(a.v, item, a.s_chroma);
  r.iu = item_ptr(a.iu, item, a.s_chroma);
  r.iv = item_ptr(a.iv, item, a.s_chroma);
  r.ru = item_ptr(a.ru, item, a.s_chroma);
  r.rv = item_ptr(a.rv, item, a.s_chroma);
  r.i16_mode = item_ptr(a.i16_mode, item, a.s_map);
  r.chroma_mode = item_ptr(a.chroma_mode, item, a.s_map);
  r.qp = item_ptr(a.qp, item, a.s_map);
  r.qpc = item_ptr(a.qpc, item, a.s_map);
  r.i4_mask = item_ptr(a.i4_mask, item, a.s_map);
  r.is_intra = item_ptr(a.is_intra, item, a.s_map);
  r.i4_modes = item_ptr(a.i4_modes, item, a.s_i4m);
  r.dc = item_ptr(a.dc, item, a.s_dc);
  r.ac = item_ptr(a.ac, item, a.s_ac);
  r.udc = item_ptr(a.udc, item, a.s_cdc);
  r.vdc = item_ptr(a.vdc, item, a.s_cdc);
  r.uac = item_ptr(a.uac, item, a.s_cac);
  r.vac = item_ptr(a.vac, item, a.s_cac);
  return r;
}

// The aligned 4-byte word that holds mask byte *p: an item's mask need
// not start on a word, so the word is found from the address.
__device__ __forceinline__ const void* mask_word(const uint8_t* p) {
  return (const void*)((uintptr_t)p & ~(uintptr_t)3);
}

// Start the copies of MB (x, row)'s inputs into buffer `buf` (`a` is the
// MB's item, as item_args gives it).
__device__ __forceinline__ void prefetch_mb(FrameSmem& s, const CommitArgs& a,
                                            int buf, int row, int x, int t) {
  const int W = 16 * a.mbw, Wc = 8 * a.mbw;
  if (t < 16) {
    cp_async16(&s.src_y[buf][16 * t], a.y + (16 * row + t) * W + 16 * x);
  } else if (t < 32) {
    const int c = (t - 16) >> 3, r = (t - 16) & 7;
    cp_async8(&s.src_c[buf][c][8 * r],
              (c ? a.v : a.u) + (8 * row + r) * Wc + 8 * x);
  } else if (t < 48) {
    if (a.is_intra != nullptr)
      cp_async16(&s.int_y[buf][16 * (t - 32)],
                 a.iy + (16 * row + t - 32) * W + 16 * x);
  } else if (t < 64) {
    const int c = (t - 48) >> 3, r = (t - 48) & 7;
    if (a.is_intra != nullptr)
      cp_async8(&s.int_c[buf][c][8 * r],
                (c ? a.iv : a.iu) + (8 * row + r) * Wc + 8 * x);
  } else if (t < 68) {
    if (a.i4_modes != nullptr)
      cp_async16(&s.i4m[buf][4 * (t - 64)],
                 a.i4_modes + (row * a.mbw + x) * 16 + 4 * (t - 64));
  } else if (t < 74) {
    const int mb = row * a.mbw + x, k = t - 68;
    const uint8_t* mask = k == 4 ? a.i4_mask : a.is_intra;
    if (k < 4)
      cp_async4(&s.prm[buf][k], (k == 0   ? a.i16_mode
                                 : k == 1 ? a.chroma_mode
                                 : k == 2 ? a.qp
                                          : a.qpc) + mb);
    else if (mask != nullptr)
      cp_async4(&s.prm[buf][k], mask_word(mask + mb));
  }
}

// mask byte *p from its prefetched word (little-endian)
__device__ __forceinline__ bool mask_byte(int word, const uint8_t* p) {
  return ((word >> (8 * ((uintptr_t)p & 3))) & 0xff) != 0;
}

// Luma of one intra I16x16 MB; thread t < 256 holds pixel / coefficient
// k = t & 15 of raster 4x4 block b = t >> 4.
__device__ __forceinline__ void luma_i16(FrameSmem& s, const CommitArgs& a,
                                         int t, int mb, int buf, int par,
                                         int luma_base, bool al, bool at,
                                         int qp) {
  const int W = 16 * a.mbw;
  const int lane = t & 31, b = t >> 4, k = t & 15, i = k >> 2, j = k & 3;
  const int bx = b & 3, by = b >> 2, py = 4 * by + i, px = 4 * bx + j;
  const int qrem = qp % 6, qper = qp / 6;
  const int* qmf = s.tab;
  const int* dmf = s.tab + 96;
  // lanes 0-15: top[lane]; lanes 16-31: left[lane - 16]; 0 if unavailable
  const int edge = lane < 16 ? s.top[buf][lane]
                   : al      ? s.left[par][lane - 16] : 0;
  const int tl = s.tl[buf][0];
  // DC sums and plane gradients (weight l - 7 on edge pixel l, -8 on tl)
  int sum = edge, g = ((lane & 15) - 7) * edge;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(kFull, sum, o);
    g += __shfl_xor_sync(kFull, g, o);
  }
  const int sum_t = __shfl_sync(kFull, sum, 0);
  const int sum_l = __shfl_sync(kFull, sum, 16);
  const int hg = __shfl_sync(kFull, g, 0) - 8 * tl;
  const int vg = __shfl_sync(kFull, g, 16) - 8 * tl;
  const int top15 = __shfl_sync(kFull, edge, 15);
  const int left15 = __shfl_sync(kFull, edge, 31);
  const int vtop = __shfl_sync(kFull, edge, px);
  const int hleft = __shfl_sync(kFull, edge, 16 + py);
  int p;
  switch (s.prm[buf][0]) {
    case 0: p = vtop; break;
    case 1: p = hleft; break;
    case 2:
      p = (at && al) ? (sum_t + sum_l + 16) >> 5
          : at       ? (sum_t + 8) >> 4
          : al       ? (sum_l + 8) >> 4
                     : 128;
      break;
    default:
      p = clip255((16 * (left15 + top15) + ((5 * hg + 32) >> 6) * (px - 7)
                   + ((5 * vg + 32) >> 6) * (py - 7) + 16) >> 5);
  }
  const int w = fdct_lanes(s.src_y[buf][16 * py + px] - p, i, j);
  if (k == 0) s.dcw[b] = w;
  int lv = 0;
  if (k != 0) {
    const int qb = 15 + qper;
    lv = quant(w, qmf[qrem * 16 + k], qb, (21 << qb) >> 6);
  }
  a.ac[mb * 256 + t] = lv;
  const int deq = dequant(lv, dmf[qrem * 16 + k] << 4, qper - 4);
  bar_named(kBarLuma, kLumaThreads);
  if (t < 32) {
    // luma DC: Hadamard of the raster DC grid, >> 1, quant (qbits + 1),
    // then the inverse Hadamard and the spec 8.5.10 DC dequant
    const int had = had4_lanes(s.dcw[k], i, j) >> 1;
    const int qb = 16 + qper;
    const int dlv = quant(had, s.tab[192 + qrem], qb, (21 << qb) >> 6);
    const int l32 = had4_lanes(dlv, i, j) * (s.tab[198 + qrem] << 4);
    if (lane < 16) {
      a.dc[mb * 16 + k] = dlv;
      s.dcv[k] = qper >= 6 ? l32 * (1 << (qper - 6))
                           : (l32 + (1 << (5 - qper))) >> (6 - qper);
    }
  }
  bar_named(kBarLuma, kLumaThreads);
  const int r = idct_lanes(k == 0 ? s.dcv[b] : deq, i, j);
  const int rec = clip255(p + r);
  a.ry[luma_base + py * W + px] = (uint8_t)rec;
  if (px == 15) s.left[par ^ 1][py] = rec;
}

// Luma of one intra I_4x4 MB: warp 0 runs the 16 blocks as a wavefront of
// 10 steps over bx + 2 by (two blocks, 32 lanes, per step; __syncwarp
// between steps) on the [17][21] edge buffer; then the luma threads store.
__device__ __forceinline__ void luma_i4(FrameSmem& s, const CommitArgs& a,
                                        int t, int mb, int buf, int par,
                                        int luma_base, bool al, bool at,
                                        int qp) {
  const int W = 16 * a.mbw;
  if (t < 32) {
    const int lane = t, slot = lane >> 4, k = lane & 15, i = k >> 2,
              j = k & 3;
    const int qrem = qp % 6, qper = qp / 6;
    const int qb = 15 + qper, fq = (21 << qb) >> 6;
    const int qmf = s.tab[qrem * 16 + k], dmf = s.tab[96 + qrem * 16 + k];
    const int edge = lane < 16 ? s.top[buf][lane]
                     : al      ? s.left[par][lane - 16] : 0;
    const int tl = s.tl[buf][0];
    const int top15 = __shfl_sync(kFull, edge, 15);
    if (lane < 16) s.ext[1 + lane] = edge;
    else s.ext[(lane - 15) * 21] = edge;
    if (lane == 0) s.ext[0] = tl;
    if (lane < 4) s.ext[17 + lane] = top15;
    if (lane < 16) a.dc[mb * 16 + lane] = 0;
    __syncwarp();
#pragma unroll
    for (int step = 0; step < 10; ++step) {
      // blocks of step s = bx + 2 by: slot 0 takes the top one, slot 1
      // the one below-left if there is one, else twins slot 0
      const int by0 = step < 2 ? 0 : (step - 2) >> 1, bx0 = step - 2 * by0;
      const bool valid = slot == 0 || (bx0 >= 2 && by0 < 3);
      const int bx = slot && valid ? bx0 - 2 : bx0;
      const int by = slot && valid ? by0 + 1 : by0;
      const int r = 4 * by + bx, r4 = 4 * by, c4 = 4 * bx;
      const int pidx = pred4_index(s.i4m[buf][r], j, i);
      // edge vector e = [l3, l2, l1, l0, tl, t0..t7, t7]: one load per
      // lane, no branches (lanes 14-15 read a cell they then ignore)
      const int kk0 = k == 13 ? 7 : min(k - 5, 7);
      const int kind = (kKindBits >> (2 * r)) & 3;
      const bool tr_ok = kind == 2 || (kind == 1 && at);
      const int kk = (kk0 < 4 || tr_ok) ? kk0 : 3;
      const int addr = k < 4    ? (r4 + 4 - k) * 21 + c4
                       : k == 4 ? r4 * 21 + c4
                                : r4 * 21 + c4 + 1 + kk;
      const int ev = k < 14 ? s.ext[addr] : 0;
      const int prev = __shfl_sync(kFull, ev, (k + 15) & 15, 16);
      const int next = __shfl_sync(kFull, ev, (k + 1) & 15, 16);
      const int l3 = __shfl_sync(kFull, ev, 0, 16);
      const int l2 = __shfl_sync(kFull, ev, 1, 16);
      const int sum_l = l3 + l2 + __shfl_sync(kFull, ev, 2, 16)
                        + __shfl_sync(kFull, ev, 3, 16);
      const int sum_t = __shfl_sync(kFull, ev, 5, 16)
                        + __shfl_sync(kFull, ev, 6, 16)
                        + __shfl_sync(kFull, ev, 7, 16)
                        + __shfl_sync(kFull, ev, 8, 16);
      const bool al_b = bx > 0 || al, at_b = by > 0 || at;
      const int dcv = (at_b && al_b) ? (sum_t + sum_l + 4) >> 3
                      : at_b         ? (sum_t + 2) >> 2
                      : al_b         ? (sum_l + 2) >> 2
                                     : 128;
      // lane k holds e[k], f3[k], h2[k]; f3[14] and f3[15] hold mode 8's
      // corner value and the DC value
      const int f3 = k == 15   ? dcv
                     : k == 14 ? (l2 + 3 * l3 + 2) >> 2
                     : (k == 0 || k == 13) ? 0
                                           : (prev + 2 * ev + next + 2) >> 2;
      const int h2 = k >= 13 ? 0 : (ev + next + 1) >> 1;
      const int src = pidx & 15;
      const int pe = __shfl_sync(kFull, ev, src, 16);
      const int pf = __shfl_sync(kFull, f3, src, 16);
      const int ph = __shfl_sync(kFull, h2, src, 16);
      const int p = pidx < 16 ? pe : pidx < 32 ? pf : ph;
      const int w = fdct_lanes(s.src_y[buf][(r4 + i) * 16 + c4 + j] - p, i, j);
      const int lv = quant(w, qmf, qb, fq);
      const int rr = idct_lanes(dequant(lv, dmf << 4, qper - 4), i, j);
      if (valid) {
        a.ac[mb * 256 + r * 16 + k] = lv;
        s.ext[(r4 + 1 + i) * 21 + c4 + 1 + j] = clip255(p + rr);
      }
      __syncwarp();
    }
  }
  bar_named(kBarLuma, kLumaThreads);
  const int py = t >> 4, px = t & 15;
  const int rec = s.ext[(1 + py) * 21 + 1 + px];
  a.ry[luma_base + py * W + px] = (uint8_t)rec;
  if (px == 15) s.left[par ^ 1][py] = rec;
}

// Chroma of one intra MB; thread ct = t - 256 < 128 holds component
// c = ct >> 6, pixel / coefficient k = ct & 15 of 4x4 block cb = (ct >> 4) & 3.
__device__ __forceinline__ void chroma_i8(FrameSmem& s, const CommitArgs& a,
                                          int ct, int mb, int buf, int par,
                                          int chroma_base, bool al, bool at,
                                          int qpc) {
  const int Wc = 8 * a.mbw;
  const int lane = ct & 31, c = ct >> 6, p = ct & 63;
  const int cb = p >> 4, k = p & 15, i = k >> 2, j = k & 3;
  const int py = 4 * (cb >> 1) + i, px = 4 * (cb & 1) + j;
  const int crem = qpc % 6, cper = qpc / 6;
  uint8_t* crec = c ? a.rv : a.ru;
  // lanes 0-7: top[lane]; lanes 8-15: left[lane - 8]; others 0
  const int edge = lane < 8              ? s.ctop[buf][c][lane]
                   : (lane < 16 && al)   ? s.cleft[par][c][lane - 8] : 0;
  const int tl = s.tl[buf][1 + c];
  int sum = edge, g = ((lane & 7) - 3) * edge;
  sum += __shfl_xor_sync(kFull, sum, 1);
  sum += __shfl_xor_sync(kFull, sum, 2);
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) g += __shfl_xor_sync(kFull, g, o);
  const int st0 = __shfl_sync(kFull, sum, 0), st1 = __shfl_sync(kFull, sum, 4);
  const int sl0 = __shfl_sync(kFull, sum, 8), sl1 = __shfl_sync(kFull, sum, 12);
  const int hg = __shfl_sync(kFull, g, 0) - 4 * tl;
  const int vg = __shfl_sync(kFull, g, 8) - 4 * tl;
  const int top7 = __shfl_sync(kFull, edge, 7);
  const int left7 = __shfl_sync(kFull, edge, 15);
  const int vtop = __shfl_sync(kFull, edge, px);
  const int hleft = __shfl_sync(kFull, edge, 8 + py);
  int pr;
  switch (s.prm[buf][1]) {
    case 0:   // quadrant cb's DC: (0,0) both, (0,1) top first,
              // (1,0) left first, (1,1) both
      pr = cb == 0 ? ((at && al) ? (st0 + sl0 + 4) >> 3
                      : at       ? (st0 + 2) >> 2
                      : al       ? (sl0 + 2) >> 2 : 128)
         : cb == 1 ? (at ? (st1 + 2) >> 2 : al ? (sl0 + 2) >> 2 : 128)
         : cb == 2 ? (al ? (sl1 + 2) >> 2 : at ? (st0 + 2) >> 2 : 128)
                   : ((at && al) ? (st1 + sl1 + 4) >> 3
                      : at       ? (st1 + 2) >> 2
                      : al       ? (sl1 + 2) >> 2 : 128);
      break;
    case 1: pr = hleft; break;
    case 2: pr = vtop; break;
    default:
      pr = clip255((16 * (left7 + top7) + ((17 * hg + 16) >> 5) * (px - 3)
                    + ((17 * vg + 16) >> 5) * (py - 3) + 16) >> 5);
  }
  const int w = fdct_lanes(s.src_c[buf][c][8 * py + px] - pr, i, j);
  if (k == 0) s.cdcw[c][cb] = w;
  int lv = 0;
  if (k != 0) {
    const int qb = 15 + cper;
    lv = quant(w, s.tab[crem * 16 + k], qb, (21 << qb) >> 6);
  }
  (c ? a.vac : a.uac)[mb * 64 + p] = lv;
  const int deq = dequant(lv, s.tab[96 + crem * 16 + k] << 4, cper - 4);
  bar_named(kBarChroma, kChromaThreads);
  int d = deq;
  if (k == 0) {
    // 2x2 DC Hadamard + quant (qbits + 1), inverse, spec 8.5.11 dequant
    const int x00 = s.cdcw[c][0], x01 = s.cdcw[c][1];
    const int x10 = s.cdcw[c][2], x11 = s.cdcw[c][3];
    const int qb = 16 + cper, mf = s.tab[192 + crem], f = (21 << qb) >> 6;
    const int l0 = quant(x00 + x01 + x10 + x11, mf, qb, f);
    const int l1 = quant(x00 - x01 + x10 - x11, mf, qb, f);
    const int l2 = quant(x00 + x01 - x10 - x11, mf, qb, f);
    const int l3 = quant(x00 - x01 - x10 + x11, mf, qb, f);
    (c ? a.vdc : a.udc)[mb * 4 + cb] = sel4(cb, l0, l1, l2, l3);
    const int fi = sel4(cb, l0 + l1 + l2 + l3, l0 - l1 + l2 - l3,
                        l0 + l1 - l2 - l3, l0 - l1 - l2 + l3);
    d = ((fi * (s.tab[198 + crem] << 4)) * (1 << cper)) >> 5;
  }
  const int rec = clip255(pr + idct_lanes(d, i, j));
  crec[chroma_base + py * Wc + px] = (uint8_t)rec;
  if (px == 7) s.cleft[par ^ 1][c][py] = rec;
}

// Mixed lane (intra-in-P, not intra): copy the inter reconstruction from
// the prefetched tile and write zero levels.
__device__ __forceinline__ void inter_mb(FrameSmem& s, const CommitArgs& a,
                                         int t, int mb, int buf, int par,
                                         int luma_base, int chroma_base) {
  if (t < kLumaThreads) {
    const int py = t >> 4, px = t & 15;
    const int rec = s.int_y[buf][t];
    a.ry[luma_base + py * 16 * a.mbw + px] = (uint8_t)rec;
    if (px == 15) s.left[par ^ 1][py] = rec;
    a.ac[mb * 256 + t] = 0;
    if (t < 16) a.dc[mb * 16 + t] = 0;
  } else {
    const int ct = t - kLumaThreads, c = ct >> 6, p = ct & 63;
    const int py = p >> 3, px = p & 7;
    const int rec = s.int_c[buf][c][p];
    (c ? a.rv : a.ru)[chroma_base + py * 8 * a.mbw + px] = (uint8_t)rec;
    if (px == 7) s.cleft[par ^ 1][c][py] = rec;
    (c ? a.vac : a.uac)[mb * 64 + p] = 0;
    if (p < 4) (c ? a.vdc : a.udc)[mb * 4 + p] = 0;
  }
}

constexpr int kStats = 9;   // int64 counters per block, when asked for

__device__ __forceinline__ long long globaltimer() {
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}

// One block per co-resident slot walks the global MB rows r = blockIdx.x,
// + grid, ... < items * mbh (item r / mbh, row r % mbh), each left to
// right; kBatched is false for a batch of one (r is the row; no item
// arithmetic), and true otherwise (item and row found once per row).
// Before MB (x, row) with row > 0 it waits until global row r - 1 (the
// row above, in the same item) has published progress > x: the MB
// reads only its left (this block's previous MB, kept on chip), top and
// top-left neighbours; the top-right MB is never read (kKind treats it as
// unavailable, as the JAX scan does). Row 0 of an item waits on nothing.
// prog[0..items*mbh-1] is each global row's count of finished MBs,
// prog[items*mbh] the error word; the caller zeroes both.
//
// Warps 0-11 compute. Warp 12 (waiter) polls the row above for the next
// MB and loads its top edges while the compute warps work on this one;
// warp 13 (releaser) publishes each finished MB while the compute warps
// start the next. Per MB: kBarStart opens it (compute and waiter sync;
// the releaser arrives once it has seen the previous MB done), kBarDone
// closes it (compute arrive, the releaser syncs), so no barrier phase can
// take an arrival meant for the next one.
//
// `stats`, when not null, gets kStats int64 per block: SM cycles that
// thread 0 (luma) waited at kBarStart and computed I16 / I_4x4 MBs, that
// thread 256 (chroma) computed, that the waiter polled, the block's MBs
// and I_4x4 MBs, and its whole run in cycles and in nanoseconds.
template <bool kBatched>
__global__ void __launch_bounds__(kThreads, 1)
commit_frame_kernel(CommitArgs a, int* prog, int grid, long long* stats) {
  __shared__ FrameSmem s;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int mbw = a.mbw, mbh = a.mbh, rows = kBatched ? mbh * a.items : mbh;
  int* err = prog + rows;
  long long* st = stats != nullptr ? stats + kStats * blockIdx.x : nullptr;
  const long long c_start = clock64(), ns_start = globaltimer();
  long long n_wait = 0, n_main = 0, n_i4 = 0, n_aux = 0;   // for stats

  if (warp == kReleaserWarp) {
    bar_arrive(kBarStart, kThreads);
    for (int r = blockIdx.x; r < rows; r += grid) {
      for (int x = 0; x < mbw; ++x) {
        bar_named(kBarDone, kComputeThreads + 32);
        if (s.quit) return;
        if (x + 1 < mbw || r + grid < rows) bar_arrive(kBarStart, kThreads);
        st_release(prog + r, x + 1);   // all lanes: one store, no split
      }
    }
    return;
  }

  if (warp == kWaiterWarp) {
    const int W = 16 * mbw, Wc = 8 * mbw;
    int seq = 0;
    for (int r = blockIdx.x; r < rows; r += grid) {
      const int row = kBatched ? r % mbh : r;
      const CommitArgs ai = item_args<kBatched>(a, kBatched ? r / mbh : 0);
      int seen = 0;   // last progress read from row - 1
      for (int x = 0; x < mbw; ++x, ++seq) {
        const int buf = seq & 1;
        int ab = 0;
        const long long c0 = clock64();
        // every lane polls the same word (one load), so the warp reaches
        // the barrier undivided
        if (row > 0 && seen <= x) {
          for (int it = 1;; ++it) {
            seen = ld_acquire(prog + r - 1);
            if (seen > x) break;
            if ((it & 255) == 0) {
              if (ld_relaxed(err) != 0) { ab = 1; break; }
              if (it >= kSpinLimit) {
                if (lane == 0) atomicExch(err, 1);
                ab = 1;
                break;
              }
            }
          }
        }
        n_aux += clock64() - c0;   // polling
        __syncwarp();
        // the row above's last row of pixels, read past L1 after the
        // acquire (lanes 0-15 luma, 16-23 U, 24-31 V)
        const bool at = row > 0, al = x > 0;
        if (lane < 16) {
          s.top[buf][lane] =
              at ? ldcg_u8(ai.ry + (16 * row - 1) * W + 16 * x + lane) : 0;
        } else {
          const int c = (lane - 16) >> 3, k = lane & 7;
          s.ctop[buf][c][k] =
              at ? ldcg_u8((c ? ai.rv : ai.ru) + (8 * row - 1) * Wc + 8 * x +
                           k)
                 : 0;
        }
        if (lane < 3) {
          const uint8_t* plane = lane == 0 ? ai.ry : lane == 1 ? ai.ru : ai.rv;
          const int w = lane == 0 ? W : Wc, sz = lane == 0 ? 16 : 8;
          s.tl[buf][lane] =
              (at && al) ? ldcg_u8(plane + (sz * row - 1) * w + sz * x - 1)
                         : 0;
        }
        if (lane == 0) s.abort[buf] = ab;
        __syncwarp();
        bar_named(kBarStart, kThreads);
        if (ab) return;
      }
    }
    if (st != nullptr && lane == 0) st[4] = n_aux;
    return;
  }

  for (int idx = t; idx < 208; idx += kComputeThreads) s.tab[idx] = a.tab[idx];
  if (t == 0) s.quit = 0;
  const int r0 = blockIdx.x;
  if (r0 < rows)
    prefetch_mb(s, item_args<kBatched>(a, kBatched ? r0 / mbh : 0), 0,
                kBatched ? r0 % mbh : r0, 0, t);
  cp_async_commit();
  int seq = 0;   // this block's MB count: buffer parity
  for (int r = r0; r < rows; r += grid) {
    const int row = kBatched ? r % mbh : r;
    const CommitArgs ai = item_args<kBatched>(a, kBatched ? r / mbh : 0);
    for (int x = 0; x < mbw; ++x, ++seq) {
      const int buf = seq & 1, par = x & 1;
      if (x + 1 < mbw) {
        prefetch_mb(s, ai, buf ^ 1, row, x + 1, t);
      } else if (r + grid < rows) {   // this block's next row
        const int nr = r + grid;
        prefetch_mb(s, item_args<kBatched>(a, kBatched ? nr / mbh : 0),
                    buf ^ 1, kBatched ? nr % mbh : nr, 0, t);
      }
      cp_async_commit();
      cp_async_wait_prev();
      const long long c0 = clock64();
      bar_named(kBarStart, kThreads);
      // bar.sync may let the warp run on until its next shared-memory
      // access: read the clock only once a value read after it is in
      int aborted = s.abort[buf];
      asm volatile("add.s32 %0, %0, 0;" : "+r"(aborted));
      const long long c1 = clock64();
      n_wait += c1 - c0;
      if (aborted) {
        if (t == 0) s.quit = 1;
        bar_arrive(kBarDone, kComputeThreads + 32);
        asm volatile("cp.async.wait_all;" ::: "memory");
        return;
      }
      const int mb = row * mbw + x;
      const bool al = x > 0, at = row > 0;
      const int* prm = s.prm[buf];
      const bool i4 =
          ai.i4_mask != nullptr && mask_byte(prm[4], ai.i4_mask + mb);
      const int luma_base = 16 * row * 16 * mbw + 16 * x;
      const int chroma_base = 8 * row * 8 * mbw + 8 * x;
      if (ai.is_intra != nullptr && !mask_byte(prm[5], ai.is_intra + mb)) {
        inter_mb(s, ai, t, mb, buf, par, luma_base, chroma_base);
      } else if (t < kLumaThreads) {
        if (i4)
          luma_i4(s, ai, t, mb, buf, par, luma_base, al, at, prm[2]);
        else
          luma_i16(s, ai, t, mb, buf, par, luma_base, al, at, prm[2]);
      } else {
        chroma_i8(s, ai, t - kLumaThreads, mb, buf, par, chroma_base, al, at,
                  prm[3]);
      }
      const long long dc = clock64() - c1;
      if (i4 && t < kLumaThreads) n_i4 += dc;
      else n_main += dc;   // I16 luma, or chroma
      n_aux += i4;
      bar_arrive(kBarDone, kComputeThreads + 32);
    }
  }
  if (st != nullptr && t == 0) {
    st[0] = n_wait;
    st[1] = n_main;
    st[2] = n_i4;
    st[5] = seq;
    st[6] = n_aux;
    st[7] = clock64() - c_start;
    st[8] = globaltimer() - ns_start;
  }
  if (st != nullptr && t == kLumaThreads) st[3] = n_main;
}

}  // namespace

// Launch the commit of anti-diagonal d on `stream` (one block per MB).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int x264t_commit_diag(const CommitArgs* a, int d, void* stream) {
  const int y0 = d - a->mbw + 1 > 0 ? d - a->mbw + 1 : 0;
  const int y1 = d < a->mbh - 1 ? d : a->mbh - 1;
  if (y1 < y0) return (int)cudaErrorInvalidValue;
  commit_diag_kernel<<<y1 - y0 + 1, 256, 0, (cudaStream_t)stream>>>(*a, d,
                                                                    y0);
  return (int)cudaGetLastError();
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One launch of an empty kernel on `stream`: the floor that a ctypes
// launch costs, for splitting a launch's time into launch and work.
extern "C" int x264t_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// How many blocks of commit_frame_kernel (either instance: the fewer)
// the card holds at once (blocks per SM times SMs), or minus a CUDA error
// code.
extern "C" int x264t_commit_capacity() {
  int dev = 0, sms = 0, one = 0, batched = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &one, commit_frame_kernel<false>, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &batched, commit_frame_kernel<true>, kThreads, 0);
  return e == cudaSuccess ? (one < batched ? one : batched) * sms : -(int)e;
}

// Launch the commit of a batch of a->items frames (or bands) on `stream`:
// `grid` persistent blocks (1 <= grid <= min(items * mbh, capacity)), all
// co-resident by a cooperative launch. `prog` holds items * mbh + 1 zeroed
// int32: each global row's progress, then the error word, which the kernel
// sets when a wavefront wait runs past its bound. `stats`: null, or grid x
// kStats zeroed int64 (see the kernel). Returns the launch's CUDA error (0
// on success).
extern "C" int x264t_commit_frame(const CommitArgs* a, int* prog, int grid,
                                  long long* stats, void* stream) {
  if (a->items < 1 || grid < 1 || grid > a->mbh * a->items)
    return (int)cudaErrorInvalidValue;
  CommitArgs args = *a;
  void* params[] = {&args, &prog, &grid, &stats};
  const void* kernel = a->items == 1 ? (const void*)commit_frame_kernel<false>
                                     : (const void*)commit_frame_kernel<true>;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), params, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// sizeof(CommitArgs), so the binding can check its struct layout.
extern "C" int x264t_commit_args_size() { return (int)sizeof(CommitArgs); }
