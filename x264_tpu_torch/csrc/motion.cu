// Motion search for Hopper (sm_90a): the seeded full-pel search (its
// half-res scan and its full-res refine), the exhaustive full-pel search
// and the quarter-pel refine of the partition lanes.
//
// Replaces the jnp lax.scans of x264_tpu/encoder/inter.py (no Pallas
// kernel): motion_search_seeded's stage 1 (:208-246, a scan over 8-offset
// chunks of the half-res offsets) in me_lowres_scan_kernel, its stage 2
// (:248-311, a scan over the (2M + 1)^2 refine offsets) and motion_search
// (:86, the ESA: a scan over every offset of [-R, R]^2, once per pass) in
// me_fullpel_kernel, and _subpel_refine_scan with _subpel_windows (:351,
// :400, a scan over the qpel candidate table) in me_subpel_kernel. XLA
// compiles each scan into one device program; the port's plain versions
// (x264_tpu_torch/encoder/inter.py motion_search_ref,
// motion_search_seeded_ref, subpel_refine_all_ref, subpel_refine_mc_ref)
// dispatch a dozen torch ops per offset from the host instead.
//
// Bit-exact twin of those scans. A scan keeps the best candidate so far
// and replaces it only when a cost is strictly lower, starting from cost
// 1 << 30 (and a zero MV, or the full-pel MV for the qpel refine). Here
// the candidates run in parallel, and each (cost, candidate) pair is one
// 64-bit key, cost * 2^32 + index, with index 0 for the scan's initial
// best and k + 1 for the k-th candidate in scan order. The least key is
// the scan's winner: the first candidate of the least cost, and the
// initial best where no cost is below 1 << 30. All costs are int32, as in
// both twins: the largest, 1 << 28 (the periodic-intra-refresh cap) plus a
// SAD plus an MV rate, is far below 2^31.
//
// What bounds them on this card: instructions, not bytes. Per 1080p
// reference (8,160 MBs) at me_range 16, the ESA takes 1,089 offsets x 64
// packed byte SADs per MB and pass, the qpel refine 49 candidates x the
// lanes' distinct 4x4 blocks (at most 64 over 9 lanes) x a 4x4 Hadamard,
// the seeded stages 289 and 81 offsets per MB. One frame's luma planes are
// 5.1 MB. The reference window of an MB is read from device memory once
// into shared memory and then read again for every offset.
//
// What the design does about it. The full-pel kernel: one block per MB,
// its source MB and reference window in shared memory (loaded as aligned
// words and a funnel shift, clamped byte by byte only where the window
// leaves the plane), a thread per offset. The SADs take four pixels per
// instruction: each window row is read as aligned 32-bit words, a funnel
// shift aligns them to the offset's column, and __vsadu4 sums four
// absolute byte differences at once; one offset's 16 rows give the four
// 8x8 quadrant SADs that every partition lane sums. Each lane's least key
// is a warp-shuffle minimum, unrolled over the lanes so that the keys stay
// in registers, then one combine of the warps' keys in shared memory.
//
// The qpel refine: one block per MB over all of its lanes. The source MB
// and the candidate table are loaded once, each distinct lane window once
// (word-wide, as above; only the rows and words a candidate reads). Work
// items are only the weighed 4x4 blocks that
// no earlier lane with the same full-pel MV has computed, times the 49
// candidates: a partition lane whose MV equals an earlier lane's reads
// that lane's SATDs. A 4x4 SATD is four dp4a row transforms of the
// prediction (four pixels per instruction), each accumulated onto the
// source row's negated transform (computed once per MB), a column
// butterfly and |a + b| + |a - b| =
// 2 max(|a|, |b|). A warp per lane sums each candidate's weighed SATDs and
// MV rate, two candidates a thread, and takes the warp-shuffle minimum;
// then the block rebuilds each lane's winning prediction from shared
// memory. No per-MB window tensor and no candidate prediction is ever
// written to device memory.
//
// Every entry point checks its sizes, launches on the caller's stream,
// does not synchronise and allocates nothing, and returns the launch's
// CUDA error (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInitCost = 1 << 30;   // the scans' initial best cost
constexpr int kPirCost = 1 << 28;    // an offset past the PIR cap
constexpr int kMaxRange = 32;        // full-pel range: at most the border
constexpr int kMaxLowRange = 16;     // half-res range (R + 1) / 2
constexpr int kLanes = 9;            // 16x16, 16x8 x 2, 8x16 x 2, 8x8 x 4
constexpr int kLowThreads = 128;
constexpr int kRefineThreads = 96;   // 81 offsets at refine 4: three warps
constexpr int kEsaThreads = 256;
constexpr int kSubThreads = 256;     // me_subpel: 8 warps per MB
constexpr int kMaxCands = 49;        // the +-3 qpel grid
constexpr int kCandCols = 9;         // qdx qdy p0 p1 oy0 ix iy ox1 avg
constexpr int kSubWin = 24;          // SUBPEL_WIN
constexpr int kSubMarg = 2;          // SUBPEL_MARG
constexpr int kSubRowWords = kSubWin / 4;
constexpr int kSubWinWords = 4 * kSubWin * kSubRowWords;  // one lane's
// the window rows and words a candidate reads: rows 1-18 (kSubMarg + oy0
// or iy, oy0 in -1..1, iy in -1..0, plus 0-15) and bytes 1-18 (words 0-4)
constexpr int kSubReadRow0 = 1, kSubReadRows = 18, kSubReadWords = 5;
constexpr int kMaxPairs = kLanes * 16;   // (lane, 4x4 block) pairs

// _mv_cost_bits: 2 * min(15, floor(log2(2 |v| + 1))) - 1
__device__ __forceinline__ int mv_bits(int v) {
  v = v < 0 ? -v : v;
  const int lg = 31 - __clz(2 * v + 1);
  return 2 * (lg < 15 ? lg : 15) - 1;
}

__device__ __forceinline__ long long key_of(int cost, int index) {
  return (long long)cost * 4294967296LL + index;
}

__device__ __forceinline__ int index_of(long long key) {
  return (int)(key & 0xffffffffLL);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ long long min_key(long long a, long long b) {
  return b < a ? b : a;
}

// The least of each lane's keys over the block's kThreads threads, a tree
// over shared memory: keys[l][0] holds lane l's once it returns.
template <int kThreads>
__device__ void block_min(long long (*keys)[kThreads], const long long* mine,
                          int lanes) {
  const int t = threadIdx.x;
  for (int l = 0; l < lanes; ++l) keys[l][t] = mine[l];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int l = 0; l < lanes; ++l)
        keys[l][t] = min_key(keys[l][t], keys[l][t + s]);
    __syncthreads();
  }
}

// The least key of the calling warp, in every one of its threads.
__device__ __forceinline__ long long warp_min(long long k) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    k = min_key(k, __shfl_xor_sync(0xffffffffu, k, s));
  return k;
}

// Whether the words of a byte tensor [n bytes] at p can be read whole:
// its start is word-aligned and it ends on a word, so that every aligned
// word holding one of its bytes lies inside it.
__device__ __forceinline__ bool word_readable(const void* p, size_t n) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0 && (n & 3) == 0;
}

// The four bytes at p (any alignment) as one little-endian word, from the
// aligned words that hold them.
__device__ __forceinline__ uint32_t load_word(const uint8_t* p) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(at & ~uintptr_t(3));
  const int shift = (int)(at & 3) * 8;
  return shift ? __funnelshift_r(w[0], w[1], shift) : w[0];
}

// The four bytes at p as one word: whole words where `whole`, else byte
// by byte.
__device__ __forceinline__ uint32_t read_word(const uint8_t* p, bool whole) {
  return whole ? load_word(p)
               : p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

// The four bytes of plane [hp][wp] at row y, columns x..x+3, each index
// clamped to the plane as mb_windows_ref clamps it.
__device__ __forceinline__ uint32_t clamped_word(const uint8_t* plane,
                                                 int hp, int wp, int y,
                                                 int x) {
  const uint8_t* row = plane + (size_t)clampi(y, 0, hp - 1) * wp;
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v |= (uint32_t)row[clampi(x + k, 0, wp - 1)] << (8 * k);
  return v;
}

// ---------------------------------------------------------------- stage 1
// One block per MB: the 8x8 half-res block's SAD at every offset of
// [-rl, rl]^2, cost 4 sad + lam (bits(8 dx) + bits(8 dy)), scan order dy
// outer, dx inner. lsrc [8 mbh][8 mbw] and lref (lsrc's reference,
// edge-extended by rl + 1 on every side) are int32, as _lowres gives them.
__global__ void __launch_bounds__(kLowThreads)
me_lowres_scan_kernel(const int32_t* __restrict__ lsrc,
                      const int32_t* __restrict__ lref, int mbw, int rl,
                      int lam, int32_t* __restrict__ bm) {
  extern __shared__ int32_t low_smem[];
  __shared__ long long keys[1][kLowThreads];
  const int t = threadIdx.x, mb = blockIdx.x;
  const int mx = mb % mbw, my = mb / mbw;
  const int wl = 8 * mbw, wr = wl + 2 * (rl + 1), ww = 8 + 2 * rl;
  int32_t* src = low_smem;
  int32_t* win = low_smem + 64;     // rows 8 my + 1 + r of lref, from
  for (int i = t; i < 64; i += kLowThreads)       // column 8 mx + 1
    src[i] = lsrc[(8 * my + i / 8) * wl + 8 * mx + i % 8];
  for (int i = t; i < ww * ww; i += kLowThreads)
    win[i] = lref[(8 * my + 1 + i / ww) * wr + 8 * mx + 1 + i % ww];
  __syncthreads();
  const int k_side = 2 * rl + 1;
  long long best = key_of(kInitCost, 0);
  for (int k = t; k < k_side * k_side; k += kLowThreads) {
    const int oy = k / k_side, ox = k % k_side;
    int sad = 0;
    for (int r = 0; r < 8; ++r) {
      const int32_t* w = win + (oy + r) * ww + ox;
      const int32_t* s = src + 8 * r;
#pragma unroll
      for (int c = 0; c < 8; ++c) sad += abs(w[c] - s[c]);
    }
    const int cost = 4 * sad + lam * (mv_bits(8 * (ox - rl)) +
                                      mv_bits(8 * (oy - rl)));
    best = min_key(best, key_of(cost, k + 1));
  }
  block_min<kLowThreads>(keys, &best, 1);
  if (t == 0) {
    const int i = index_of(keys[0][0]);
    bm[2 * mb] = i ? (i - 1) % k_side - rl : 0;
    bm[2 * mb + 1] = i ? (i - 1) / k_side - rl : 0;
  }
}

// ----------------------------------------------------- full-pel searches
struct FullpelArgs {
  const uint8_t* ref;      // [hp][wp] padded luma reference
  const uint8_t* src;      // [16 mbh][16 mbw] luma
  const int32_t* center;   // [n][2] window centres (the seeds), or null: 0
  const int32_t* mvp;      // [n][2] qpel MVP estimate, or null: 0
  const int32_t* pir_cap;  // [n] cap on the MV's x, or null: none
  int32_t* out16;          // [n][2]
  int32_t* out16x8;        // [n][2][2]  (with shapes)
  int32_t* out8x16;        // [n][2][2]
  int32_t* out8x8;         // [n][4][2]  z order: TL, TR, BL, BR
  int hp, wp, pad, mbw, range, lam, lanes;
};

// One block per MB: the 16x16 SAD's four 8x8 quadrants at every offset of
// [-range, range]^2 around the MB's centre (centre + offset is the MV, its
// window row PAD + 16 my + MV_y, column PAD + 16 mx + MV_x, each clamped to
// the plane as mb_windows_ref clamps it), each lane's cost its quadrants'
// sum plus lam (bits(4 mv_x - mvp_x) + bits(4 mv_y - mvp_y)), plus
// 1 << 28 where mv_x exceeds the PIR cap. Scan order dy outer, dx inner.
// kL 1: the 16x16 lane only; 9: every partition lane.
template <int kThreads, int kL>
__global__ void __launch_bounds__(kThreads)
me_fullpel_kernel(const FullpelArgs a) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) uint8_t fp_win[];
  __shared__ uint32_t src_w[64];              // 16 rows x 4 words
  __shared__ long long wkeys[kWarps][kL];
  const int t = threadIdx.x, mb = blockIdx.x;
  const int mx = mb % a.mbw, my = mb / a.mbw;
  const int cx = a.center ? a.center[2 * mb] : 0;
  const int cy = a.center ? a.center[2 * mb + 1] : 0;
  const int ww = 16 + 2 * a.range;
  const int row_words = ((ww + 3) >> 2) + 1;  // whole words, one spare
  const int stride = 4 * row_words;
  const int y0 = a.pad + 16 * my + cy - a.range;
  const int x0 = a.pad + 16 * mx + cx - a.range;
  uint32_t* win_w = reinterpret_cast<uint32_t*>(fp_win);
  const bool inside = y0 >= 0 && y0 + ww <= a.hp && x0 >= 0 &&
                      x0 + stride <= a.wp &&
                      word_readable(a.ref, (size_t)a.hp * a.wp);
  for (int i = t; i < ww * row_words; i += kThreads) {
    const int r = i / row_words, j = i - r * row_words;
    win_w[i] = inside ? load_word(a.ref + (size_t)(y0 + r) * a.wp + x0 +
                                  4 * j)
                      : clamped_word(a.ref, a.hp, a.wp, y0 + r, x0 + 4 * j);
  }
  const int w = 16 * a.mbw;
  if (t < 64)
    src_w[t] = read_word(a.src + (size_t)(16 * my + t / 4) * w + 16 * mx +
                             4 * (t % 4),
                         word_readable(a.src, (size_t)256 * gridDim.x));
  __syncthreads();
  const int mvpx = a.mvp ? a.mvp[2 * mb] : 0;
  const int mvpy = a.mvp ? a.mvp[2 * mb + 1] : 0;
  const int cap = a.pir_cap ? a.pir_cap[mb] : 0;
  const int k_side = 2 * a.range + 1;
  long long best[kL];
#pragma unroll
  for (int l = 0; l < kL; ++l) best[l] = key_of(kInitCost, 0);
  for (int k = t; k < k_side * k_side; k += kThreads) {
    const int oy = k / k_side, ox = k % k_side;
    const int word = ox >> 2, shift = (ox & 3) * 8;
    int q[4] = {0, 0, 0, 0};                  // registers: the halves
#pragma unroll                                // are unrolled
    for (int h = 0; h < 2; ++h) {
#pragma unroll 4
      for (int r = 8 * h; r < 8 * h + 8; ++r) {
        const uint32_t* row = win_w + (oy + r) * row_words + word;
        const uint32_t w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3],
                       w4 = row[4];
        const uint32_t* s = src_w + 4 * r;
        q[2 * h] += __vsadu4(__funnelshift_r(w0, w1, shift), s[0]) +
                    __vsadu4(__funnelshift_r(w1, w2, shift), s[1]);
        q[2 * h + 1] += __vsadu4(__funnelshift_r(w2, w3, shift), s[2]) +
                        __vsadu4(__funnelshift_r(w3, w4, shift), s[3]);
      }
    }
    const int mvx = cx + ox - a.range, mvy = cy + oy - a.range;
    int mvc = a.lam * (mv_bits(4 * mvx - mvpx) + mv_bits(4 * mvy - mvpy));
    if (a.pir_cap && mvx > cap) mvc += kPirCost;
    const int i = k + 1;
    best[0] = min_key(best[0], key_of(q[0] + q[1] + q[2] + q[3] + mvc, i));
    if (kL == kLanes) {
      best[1] = min_key(best[1], key_of(q[0] + q[1] + mvc, i));
      best[2] = min_key(best[2], key_of(q[2] + q[3] + mvc, i));
      best[3] = min_key(best[3], key_of(q[0] + q[2] + mvc, i));
      best[4] = min_key(best[4], key_of(q[1] + q[3] + mvc, i));
#pragma unroll
      for (int p = 0; p < 4; ++p)
        best[5 + p] = min_key(best[5 + p], key_of(q[p] + mvc, i));
    }
  }
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    const long long k = warp_min(best[l]);
    if ((t & 31) == 0) wkeys[t >> 5][l] = k;
  }
  __syncthreads();
  if (t < kL) {
    long long k = wkeys[0][t];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) k = min_key(k, wkeys[v][t]);
    const int i = index_of(k);
    const int mvx = i ? cx + (i - 1) % k_side - a.range : 0;
    const int mvy = i ? cy + (i - 1) / k_side - a.range : 0;
    int32_t* out = t == 0 ? a.out16 + 2 * mb
                 : t < 3  ? a.out16x8 + 4 * mb + 2 * (t - 1)
                 : t < 5  ? a.out8x16 + 4 * mb + 2 * (t - 3)
                          : a.out8x8 + 8 * mb + 2 * (t - 5);
    out[0] = mvx;
    out[1] = mvy;
  }
}

// ----------------------------------------------------- quarter-pel refine
struct SubpelArgs {
  const uint8_t* hpel;     // [4][hp][wp]: full, H, V, C half-pel planes
  const uint8_t* src;      // [16 mbh][16 mbw] luma
  const int32_t* lane_mv;  // [lanes][n][2] full-pel MVs
  const int32_t* masks;    // [lanes][16] weights of the raster 4x4 blocks
  const int32_t* tab;      // [cands][9] _subpel_cand_table, (0, 0) first
  const int32_t* mvp;      // [n][2] qpel MVP, or null: 0
  int32_t* bq;             // [lanes][n][2] qpel MVs
  int32_t* bp;             // [lanes][n][16][16] predictions
  int32_t* bc;             // [lanes][n] costs
  int hp, wp, pad, mbw, n, cands, lam, lanes;
};

// A qpel candidate as byte offsets into a lane's window words
// [4 planes][24 rows][24 bytes]: p0's sample of MB pixel (0, 0), p1's
// (averaged with p0's where avg is set), and its qpel offset (qdx, qdy).
struct Cand {
  int off0, off1, avg, qd;
};

__device__ __forceinline__ Cand cand_of(const int32_t* c) {
  return {c[2] * kSubWin * kSubWin + (kSubMarg + c[4]) * kSubWin +
              kSubMarg + c[5],
          c[3] * kSubWin * kSubWin + (kSubMarg + c[6]) * kSubWin +
              kSubMarg + c[7],
          c[8], (int)(((uint32_t)c[1] << 16) | (c[0] & 0xffff))};
}

// The four window bytes at byte offset `off` of win (any alignment, the
// words of one window row).
__device__ __forceinline__ uint32_t win_word(const uint32_t* win, int off) {
  const uint32_t* w = win + (off >> 2);
  return __funnelshift_r(w[0], w[1], (off & 3) * 8);
}

// The candidate's predicted row: 4 pixels at byte offset `at` of the MB.
__device__ __forceinline__ uint32_t pred_word(const uint32_t* win,
                                              const Cand& c, int at) {
  const uint32_t p = win_word(win, c.off0 + at);
  return c.avg ? __vavgu4(p, win_word(win, c.off1 + at)) : p;
}

// c + the dot product of 4 unsigned pixels with 4 signed coefficients.
__device__ __forceinline__ int dp4a_us(uint32_t px, uint32_t coef, int c) {
  int r;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(r) : "r"(px), "r"(coef),
      "r"(c));
  return r;
}

// c + the 4-point Hadamard of a row of 4 pixels, in _satd16_map's order:
// (1 1 1 1), (1 -1 1 -1), (1 1 -1 -1), (1 -1 -1 1).
__device__ __forceinline__ int4 row_hadamard(uint32_t px, int4 c) {
  return make_int4(dp4a_us(px, 0x01010101u, c.x),
                   dp4a_us(px, 0xff01ff01u, c.y),
                   dp4a_us(px, 0xffff0101u, c.z),
                   dp4a_us(px, 0x01ffff01u, c.w));
}

// SATD of one 4x4 block (_satd16_map: the sum of |coefficients| of the 2D
// Hadamard of prediction - source, halved): the rows' transforms of the
// prediction, each starting from the source row's negated transform
// (neg_hs), a column butterfly, and for the last stage |a + b| + |a - b| =
// 2 max(|a|, |b|), which also halves the sum.
__device__ __forceinline__ int satd4x4(const uint32_t* win, const Cand& c,
                                       int at, const int4* neg_hs) {
  int4 e[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    e[r] = row_hadamard(pred_word(win, c, at + r * kSubWin), neg_hs[r]);
  int s = 0;
#define X264T_SATD_COL(f)                                           \
  {                                                                 \
    const int a0 = e[0].f + e[1].f, a1 = e[0].f - e[1].f;           \
    const int a2 = e[2].f + e[3].f, a3 = e[2].f - e[3].f;           \
    s += max(abs(a0), abs(a2)) + max(abs(a1), abs(a3));             \
  }
  X264T_SATD_COL(x) X264T_SATD_COL(y) X264T_SATD_COL(z) X264T_SATD_COL(w)
#undef X264T_SATD_COL
  return s;
}

// One block per MB over its L lanes (L <= 9). Each lane's 24x24 windows of
// the four half-pel planes sit at its full-pel MV - 2 (rows and columns
// clamped to the planes, as mb_windows_ref clamps them); a lane whose MV
// equals an earlier lane's shares that lane's windows. A thread per
// (pair, candidate) computes one SATD, where a pair is a weighed (lane,
// 4x4 block) that no earlier lane with the same MV weighs; the other
// weighed pairs read that lane's SATD. A warp per lane then sums each
// candidate's weighted SATDs and its MV rate lam (bits(qx - mvp_x) +
// bits(qy - mvp_y)), the least key picks the winner, and the block writes
// each lane's prediction at its winner.
__global__ void __launch_bounds__(kSubThreads, 4)
me_subpel_kernel(const SubpelArgs a) {
  __shared__ uint32_t win[kLanes * kSubWinWords];
  __shared__ uint16_t satd[kMaxPairs][kMaxCands];
  __shared__ int4 neg_hs[16][4];        // the source rows' transforms
  __shared__ uint32_t src_w[64];
  __shared__ Cand cand[kMaxCands];
  __shared__ int32_t mask[kLanes][16];
  __shared__ int16_t ref_of[kMaxPairs];   // the pair computed for each
  __shared__ int16_t pair_at[kMaxPairs];  // a computed pair's satd row
  __shared__ uint8_t pair_lb[kMaxPairs];  // a satd row's lane * 16 + block
  __shared__ int lmv[kLanes][2], slot[kLanes], inside[kLanes];
  __shared__ int warp_pairs[kMaxPairs / 32 + 1];
  __shared__ long long lane_key[kLanes];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int mb = blockIdx.x, mx = mb % a.mbw, my = mb / a.mbw;
  const int L = a.lanes, n_lb = 16 * L;
  const size_t plane = (size_t)a.hp * a.wp;
  if (t < L) {
    lmv[t][0] = a.lane_mv[2 * (t * a.n + mb)];
    lmv[t][1] = a.lane_mv[2 * (t * a.n + mb) + 1];
  }
  if (t < 64) {
    const int w = 16 * a.mbw;
    src_w[t] = read_word(a.src + (size_t)(16 * my + t / 4) * w + 16 * mx +
                             4 * (t % 4),
                         word_readable(a.src, (size_t)256 * a.n));
  }
  if (t < a.cands) cand[t] = cand_of(a.tab + kCandCols * t);
  if (t < n_lb) mask[t >> 4][t & 15] = a.masks[t];
  __syncthreads();
  // the pairs to compute, numbered in (lane, block) order; each lane's
  // window slot (the first lane with its MV); the source's row transforms
  const bool lb_warp = warp < (n_lb + 31) / 32;
  int ref = -1;
  if (t < n_lb && mask[t >> 4][t & 15]) {
    const int l = t >> 4, b = t & 15;
    int j = 0;
    while (lmv[j][0] != lmv[l][0] || lmv[j][1] != lmv[l][1] || !mask[j][b])
      ++j;
    ref = 16 * j + b;
  }
  if (lb_warp) {
    const unsigned own = __ballot_sync(0xffffffffu, ref == t);
    if (lane == 0) warp_pairs[warp] = __popc(own);
    if (ref == t) pair_at[t] = __popc(own & ((1u << lane) - 1));
    if (t < n_lb) ref_of[t] = (int16_t)ref;
  }
  if (t < L) {
    int j = 0;
    while (lmv[j][0] != lmv[t][0] || lmv[j][1] != lmv[t][1]) ++j;
    slot[t] = j;
    const int y0 = a.pad + 16 * my + lmv[t][1] - kSubMarg;
    const int x0 = a.pad + 16 * mx + lmv[t][0] - kSubMarg;
    inside[t] = y0 >= 0 && y0 + kSubWin <= a.hp && x0 >= 0 &&
                x0 + kSubWin <= a.wp && word_readable(a.hpel, 4 * plane);
  }
  if (t < 64) {
    const int b = t >> 2, r = t & 3;
    const int4 h = row_hadamard(src_w[(4 * (b >> 2) + r) * 4 + (b & 3)],
                                make_int4(0, 0, 0, 0));
    neg_hs[b][r] = make_int4(-h.x, -h.y, -h.z, -h.w);
  }
  __syncthreads();
  int n_pairs = 0;
  for (int v = 0; v < (n_lb + 31) / 32; ++v) n_pairs += warp_pairs[v];
  if (lb_warp && ref == t) {
    int at = pair_at[t];
    for (int v = 0; v < warp; ++v) at += warp_pairs[v];
    pair_at[t] = (int16_t)at;
    pair_lb[at] = (uint8_t)t;
  }
  // the windows of the lanes that own a slot
  for (int l = 0; l < L; ++l) {
    if (slot[l] != l) continue;
    const int y0 = a.pad + 16 * my + lmv[l][1] - kSubMarg;
    const int x0 = a.pad + 16 * mx + lmv[l][0] - kSubMarg;
    uint32_t* dst = win + l * kSubWinWords;
    constexpr int kN = 4 * kSubReadRows * kSubReadWords;
#pragma unroll
    for (int k = 0; k < (kN + kSubThreads - 1) / kSubThreads; ++k) {
      const int i = t + k * kSubThreads;
      if (i < kN) {
        const int p = i / (kSubReadRows * kSubReadWords);
        const int r = kSubReadRow0 + i / kSubReadWords % kSubReadRows;
        const int j = i % kSubReadWords;
        const uint8_t* pl = a.hpel + p * plane;
        dst[(p * kSubWin + r) * kSubRowWords + j] = inside[l]
                     ? load_word(pl + (size_t)(y0 + r) * a.wp + x0 + 4 * j)
                     : clamped_word(pl, a.hp, a.wp, y0 + r, x0 + 4 * j);
      }
    }
  }
  __syncthreads();
  // one SATD per (pair, candidate)
  for (int i = t; i < n_pairs * kMaxCands; i += kSubThreads) {
    const int pr = i / kMaxCands, c = i - pr * kMaxCands;
    if (c >= a.cands) continue;
    const int lb = pair_lb[pr], b = lb & 15;
    const int at = (b >> 2) * 4 * kSubWin + (b & 3) * 4;
    satd[pr][c] = (uint16_t)satd4x4(win + slot[lb >> 4] * kSubWinWords,
                                    cand[c], at, neg_hs[b]);
  }
  __syncthreads();
  // a warp per lane: each candidate's cost, then the least key
  const int mvpx = a.mvp ? a.mvp[2 * mb] : 0;
  const int mvpy = a.mvp ? a.mvp[2 * mb + 1] : 0;
  for (int l = warp; l < L; l += kSubThreads / 32) {
    const int fx = lmv[l][0], fy = lmv[l][1];
    long long k = key_of(kInitCost, 0);
    for (int c = lane; c < a.cands; c += 32) {
      int cost = 0;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int r = ref_of[16 * l + b];
        if (r >= 0) cost += mask[l][b] * satd[pair_at[r]][c];
      }
      const int qd = cand[c].qd;
      cost += a.lam * (mv_bits(4 * fx + (int16_t)(qd & 0xffff) - mvpx) +
                       mv_bits(4 * fy + (qd >> 16) - mvpy));
      k = min_key(k, key_of(cost, c + 1));
    }
    k = warp_min(k);
    if (lane == 0) lane_key[l] = k;
  }
  __syncthreads();
  // each lane's prediction at its winner (the full-pel MV where no
  // candidate won), four pixels a thread
  for (int i = t; i < L * 64; i += kSubThreads) {
    const int l = i >> 6, row = (i >> 2) & 15, col = 4 * (i & 3);
    const int w = index_of(lane_key[l]);
    const Cand c = w ? cand[w - 1]
                     : Cand{kSubMarg * kSubWin + kSubMarg, 0, 0, 0};
    const uint32_t p = pred_word(win + slot[l] * kSubWinWords, c,
                                 row * kSubWin + col);
    reinterpret_cast<int4*>(a.bp)[(((size_t)l * a.n + mb) * 256 +
                                   row * 16 + col) >> 2] =
        make_int4(p & 0xff, (p >> 8) & 0xff, (p >> 16) & 0xff, p >> 24);
  }
  if (t < L) {
    const long long k = lane_key[t];
    const int w = index_of(k);
    const int qd = w ? cand[w - 1].qd : 0;
    const size_t out = (size_t)t * a.n + mb;
    a.bq[2 * out] = 4 * lmv[t][0] + (int16_t)(qd & 0xffff);
    a.bq[2 * out + 1] = 4 * lmv[t][1] + (qd >> 16);
    a.bc[out] = (int)(k >> 32);
  }
}

template <int kThreads>
int fullpel_launch(const FullpelArgs& a, int mbh, void* stream) {
  if (a.mbw < 1 || mbh < 1 || a.range < 0 || a.range > kMaxRange ||
      (a.lanes != 1 && a.lanes != kLanes) || a.hp < 1 || a.wp < 1)
    return (int)cudaErrorInvalidValue;
  const int ww = 16 + 2 * a.range;
  const size_t smem = (size_t)ww * 4 * (((ww + 3) >> 2) + 1);
  if (a.lanes == 1)
    me_fullpel_kernel<kThreads, 1><<<a.mbw * mbh, kThreads, smem,
                                     (cudaStream_t)stream>>>(a);
  else
    me_fullpel_kernel<kThreads, kLanes><<<a.mbw * mbh, kThreads, smem,
                                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Stage 1 of the seeded search on `stream`: lsrc [8 mbh][8 mbw] int32,
// lref [8 mbh + 2 rl + 2][8 mbw + 2 rl + 2] int32; bm [mbh][mbw][2] int32
// gets each MB's half-res winner (dx, dy).
extern "C" int x264t_me_lowres_scan(const int32_t* lsrc, const int32_t* lref,
                                    int mbw, int mbh, int rl, int lam,
                                    int32_t* bm, void* stream) {
  if (mbw < 1 || mbh < 1 || rl < 0 || rl > kMaxLowRange)
    return (int)cudaErrorInvalidValue;
  const int ww = 8 + 2 * rl;
  const size_t smem = (64 + (size_t)ww * ww) * sizeof(int32_t);
  me_lowres_scan_kernel<<<mbw * mbh, kLowThreads, smem,
                          (cudaStream_t)stream>>>(lsrc, lref, mbw, rl, lam,
                                                  bm);
  return (int)cudaGetLastError();
}

// Stage 2 of the seeded search on `stream`: every offset of [-refine,
// refine]^2 around each MB's seed [mbh][mbw][2], the MV rate against mvp
// [mbh][mbw][2], pir_cap [mbh][mbw] or null. lanes 1 writes out16 only;
// lanes 9 all four MV fields.
extern "C" int x264t_me_refine(const uint8_t* ref, int hp, int wp, int pad,
                               const uint8_t* src, int mbw, int mbh,
                               const int32_t* seed, int refine,
                               const int32_t* mvp, const int32_t* pir_cap,
                               int lam, int lanes, int32_t* out16,
                               int32_t* out16x8, int32_t* out8x16,
                               int32_t* out8x8, void* stream) {
  if (seed == nullptr || mvp == nullptr) return (int)cudaErrorInvalidValue;
  const FullpelArgs a{ref,    src,     seed,    mvp, pir_cap, out16,
                      out16x8, out8x16, out8x8, hp,  wp,      pad,
                      mbw,    refine,  lam,     lanes};
  return fullpel_launch<kRefineThreads>(a, mbh, stream);
}

// One pass of the exhaustive search on `stream`: every offset of [-range,
// range]^2, the MV rate against mvp [mbh][mbw][2] (null: zero, the first
// pass), pir_cap and the outputs as x264t_me_refine's.
extern "C" int x264t_me_esa(const uint8_t* ref, int hp, int wp, int pad,
                            const uint8_t* src, int mbw, int mbh, int range,
                            const int32_t* mvp, const int32_t* pir_cap,
                            int lam, int lanes, int32_t* out16,
                            int32_t* out16x8, int32_t* out8x16,
                            int32_t* out8x8, void* stream) {
  const FullpelArgs a{ref,    src,     nullptr, mvp, pir_cap, out16,
                      out16x8, out8x16, out8x8,  hp,  wp,      pad,
                      mbw,    range,   lam,     lanes};
  return fullpel_launch<kEsaThreads>(a, mbh, stream);
}

// The qpel refine of `lanes` (at most 9) partition lanes on `stream`: hpel
// [4][hp][wp], lane_mv [lanes][mbh * mbw][2], masks [lanes][16], tab
// [cands][9], mvp [mbh * mbw][2] or null; bq, bp, bc as
// _subpel_refine_scan returns them. One block per MB.
extern "C" int x264t_me_subpel(const uint8_t* hpel, int hp, int wp, int pad,
                               const uint8_t* src, int mbw, int mbh,
                               int lanes, const int32_t* lane_mv,
                               const int32_t* masks, const int32_t* tab,
                               int cands, const int32_t* mvp, int lam,
                               int32_t* bq, int32_t* bp, int32_t* bc,
                               void* stream) {
  if (mbw < 1 || mbh < 1 || lanes < 1 || lanes > kLanes || cands < 1 ||
      cands > kMaxCands || hp < 1 || wp < 1)
    return (int)cudaErrorInvalidValue;
  const SubpelArgs a{hpel, src, lane_mv, masks, tab, mvp, bq,    bp,
                     bc,   hp,  wp,      pad,   mbw, mbw * mbh, cands,
                     lam,  lanes};
  me_subpel_kernel<<<mbw * mbh, kSubThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
