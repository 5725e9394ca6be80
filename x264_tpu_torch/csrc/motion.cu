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
// What bounds them on this card: integer operations, not bytes. Per 1080p
// reference (8,160 MBs) at me_range 16, the ESA does 1,089 offsets x 256
// absolute differences and sums per MB and pass (6.8 G operations, one
// frame's luma planes are 5.1 MB), the qpel refine 49 candidates x the
// lanes' 4x4 blocks (64 blocks of 16 pixels over 9 lanes) x ~7 operations
// per pixel, the seeded stages 0.45 G and 0.5 G. The reference window of an
// MB is read from device memory once into shared memory and then read
// again for every offset.
//
// What the design does about it: one block per MB (or per lane and MB),
// its source MB and reference window in shared memory, a thread per
// offset (or per candidate and 4x4 block). The full-pel SADs take four
// pixels per instruction: each window row is read as aligned 32-bit words,
// a funnel shift aligns them to the offset's column, and __vsadu4 sums four
// absolute byte differences at once; one offset's 16 rows give the four
// 8x8 quadrant SADs that every partition lane sums. The qpel refine skips
// the 4x4 blocks outside a lane's partition (they cost 0 in the twin too)
// and rebuilds only the winner's prediction after the reduction, so no
// per-MB window tensor and no candidate prediction is ever written to
// device memory. The reductions are trees over shared memory.
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
constexpr int kRefineThreads = 128;  // 81 offsets at refine 4
constexpr int kEsaThreads = 256;
constexpr int kSubThreads = 256;     // one per predicted pixel too
constexpr int kMaxCands = 49;        // the +-3 qpel grid
constexpr int kCandCols = 9;         // qdx qdy p0 p1 oy0 ix iy ox1 avg
constexpr int kSubWin = 24;          // SUBPEL_WIN
constexpr int kSubMarg = 2;          // SUBPEL_MARG

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
// lanes 1: the 16x16 lane only; 9: every partition lane.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
me_fullpel_kernel(const FullpelArgs a) {
  extern __shared__ __align__(16) uint8_t fp_win[];
  __shared__ uint32_t src_w[64];              // 16 rows x 4 words
  __shared__ long long keys[kLanes][kThreads];
  const int t = threadIdx.x, mb = blockIdx.x;
  const int mx = mb % a.mbw, my = mb / a.mbw;
  const int cx = a.center ? a.center[2 * mb] : 0;
  const int cy = a.center ? a.center[2 * mb + 1] : 0;
  const int ww = 16 + 2 * a.range;
  const int stride = ((ww + 3) & ~3) + 4;     // whole words, one spare
  const int y0 = a.pad + 16 * my + cy - a.range;
  const int x0 = a.pad + 16 * mx + cx - a.range;
  for (int i = t; i < ww * stride; i += kThreads) {
    const int yy = clampi(y0 + i / stride, 0, a.hp - 1);
    const int xx = clampi(x0 + i % stride, 0, a.wp - 1);
    fp_win[i] = a.ref[(size_t)yy * a.wp + xx];
  }
  const int w = 16 * a.mbw;
  for (int i = t; i < 64; i += kThreads) {
    const uint8_t* s = a.src + (size_t)(16 * my + i / 4) * w + 16 * mx +
                       4 * (i % 4);
    src_w[i] = s[0] | (s[1] << 8) | (s[2] << 16) | ((uint32_t)s[3] << 24);
  }
  __syncthreads();
  const int mvpx = a.mvp ? a.mvp[2 * mb] : 0;
  const int mvpy = a.mvp ? a.mvp[2 * mb + 1] : 0;
  const int cap = a.pir_cap ? a.pir_cap[mb] : 0;
  const int k_side = 2 * a.range + 1;
  long long best[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) best[l] = key_of(kInitCost, 0);
  for (int k = t; k < k_side * k_side; k += kThreads) {
    const int oy = k / k_side, ox = k % k_side;
    const int word = ox >> 2, shift = (ox & 3) * 8;
    int q[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(fp_win + (oy + r) * stride) + word;
      const uint32_t w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3],
                     w4 = row[4];
      const uint32_t* s = src_w + 4 * r;
      const int left = __vsadu4(__funnelshift_r(w0, w1, shift), s[0]) +
                       __vsadu4(__funnelshift_r(w1, w2, shift), s[1]);
      const int right = __vsadu4(__funnelshift_r(w2, w3, shift), s[2]) +
                        __vsadu4(__funnelshift_r(w3, w4, shift), s[3]);
      q[(r >> 3) * 2] += left;
      q[(r >> 3) * 2 + 1] += right;
    }
    const int mvx = cx + ox - a.range, mvy = cy + oy - a.range;
    int mvc = a.lam * (mv_bits(4 * mvx - mvpx) + mv_bits(4 * mvy - mvpy));
    if (a.pir_cap && mvx > cap) mvc += kPirCost;
    const int i = k + 1;
    best[0] = min_key(best[0], key_of(q[0] + q[1] + q[2] + q[3] + mvc, i));
    if (a.lanes == kLanes) {
      best[1] = min_key(best[1], key_of(q[0] + q[1] + mvc, i));
      best[2] = min_key(best[2], key_of(q[2] + q[3] + mvc, i));
      best[3] = min_key(best[3], key_of(q[0] + q[2] + mvc, i));
      best[4] = min_key(best[4], key_of(q[1] + q[3] + mvc, i));
#pragma unroll
      for (int p = 0; p < 4; ++p)
        best[5 + p] = min_key(best[5 + p], key_of(q[p] + mvc, i));
    }
  }
  block_min<kThreads>(keys, best, a.lanes);
  if (t < a.lanes) {
    const int i = index_of(keys[t][0]);
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
  int hp, wp, pad, mbw, n, cands, lam;
};

// The qpel sample of candidate row `c` (or of the full-pel MV, c null) at
// (y, x) of the MB: p0 at (oy0, ix), averaged with p1 at (iy, ox1) where
// avg is set, as _subpel_refine_scan reads its 24x24 windows.
__device__ __forceinline__ int qpel_sample(
    const uint8_t (*win)[kSubWin][kSubWin], const int* c, int y, int x) {
  if (c == nullptr) return win[0][kSubMarg + y][kSubMarg + x];
  const int v = win[c[2]][kSubMarg + c[4] + y][kSubMarg + c[5] + x];
  if (!c[8]) return v;
  return (v + win[c[3]][kSubMarg + c[6] + y][kSubMarg + c[7] + x] + 1) >> 1;
}

// One block per (lane, MB): the lane's 24x24 windows of the four half-pel
// planes at its full-pel MV - 2 (rows and columns clamped to the planes,
// as mb_windows_ref clamps them) in shared memory; a thread per
// (candidate, 4x4 block) computes the block's SATD (4x4 Hadamard, the sum
// of absolute values halved per block, as _satd16_map does) where the
// lane's mask weighs it; a thread per candidate sums them and adds the MV
// rate lam (bits(qx - mvp_x) + bits(qy - mvp_y)); the least key picks the
// winner, and then a thread per pixel writes its prediction.
__global__ void __launch_bounds__(kSubThreads)
me_subpel_kernel(const SubpelArgs a) {
  __shared__ uint8_t win[4][kSubWin][kSubWin];
  __shared__ int32_t src[256];
  __shared__ int32_t tab[kMaxCands][kCandCols];
  __shared__ int32_t satd[kMaxCands][16];
  __shared__ int32_t mask[16];
  __shared__ long long keys[1][kSubThreads];
  const int t = threadIdx.x;
  const int lane = blockIdx.x / a.n, mb = blockIdx.x % a.n;
  const int mx = mb % a.mbw, my = mb / a.mbw;
  const int fx = a.lane_mv[2 * (lane * a.n + mb)];
  const int fy = a.lane_mv[2 * (lane * a.n + mb) + 1];
  const int y0 = a.pad + 16 * my + fy - kSubMarg;
  const int x0 = a.pad + 16 * mx + fx - kSubMarg;
  const size_t plane = (size_t)a.hp * a.wp;
  for (int i = t; i < 4 * kSubWin * kSubWin; i += kSubThreads) {
    const int p = i / (kSubWin * kSubWin), r = i / kSubWin % kSubWin;
    const int yy = clampi(y0 + r, 0, a.hp - 1);
    const int xx = clampi(x0 + i % kSubWin, 0, a.wp - 1);
    win[p][r][i % kSubWin] = a.hpel[p * plane + (size_t)yy * a.wp + xx];
  }
  const int w = 16 * a.mbw;
  src[t] = a.src[(size_t)(16 * my + t / 16) * w + 16 * mx + t % 16];
  for (int i = t; i < a.cands * kCandCols; i += kSubThreads)
    tab[i / kCandCols][i % kCandCols] = a.tab[i];
  if (t < 16) mask[t] = a.masks[16 * lane + t];
  __syncthreads();
  for (int i = t; i < a.cands * 16; i += kSubThreads) {
    const int c = i >> 4, b = i & 15;
    int s = 0;
    if (mask[b]) {
      const int by = (b >> 2) * 4, bx = (b & 3) * 4;
      int d[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int col = 0; col < 4; ++col)
          d[r][col] = qpel_sample(win, tab[c], by + r, bx + col) -
                      src[(by + r) * 16 + bx + col];
#pragma unroll
      for (int r = 0; r < 4; ++r) {           // rows, then columns
        const int a0 = d[r][0] + d[r][1], a1 = d[r][0] - d[r][1];
        const int a2 = d[r][2] + d[r][3], a3 = d[r][2] - d[r][3];
        d[r][0] = a0 + a2;
        d[r][1] = a1 + a3;
        d[r][2] = a0 - a2;
        d[r][3] = a1 - a3;
      }
#pragma unroll
      for (int col = 0; col < 4; ++col) {
        const int a0 = d[0][col] + d[1][col], a1 = d[0][col] - d[1][col];
        const int a2 = d[2][col] + d[3][col], a3 = d[2][col] - d[3][col];
        s += abs(a0 + a2) + abs(a1 + a3) + abs(a0 - a2) + abs(a1 - a3);
      }
      s = (s >> 1) * mask[b];
    }
    satd[c][b] = s;
  }
  __syncthreads();
  const int mvpx = a.mvp ? a.mvp[2 * mb] : 0;
  const int mvpy = a.mvp ? a.mvp[2 * mb + 1] : 0;
  long long mine = key_of(kInitCost, 0);
  if (t < a.cands) {
    int cost = 0;
#pragma unroll
    for (int b = 0; b < 16; ++b) cost += satd[t][b];
    cost += a.lam * (mv_bits(4 * fx + tab[t][0] - mvpx) +
                     mv_bits(4 * fy + tab[t][1] - mvpy));
    mine = key_of(cost, t + 1);
  }
  block_min<kSubThreads>(keys, &mine, 1);
  const long long best = keys[0][0];
  const int i = index_of(best);
  const size_t out = (size_t)lane * a.n + mb;
  a.bp[out * 256 + t] =
      qpel_sample(win, i ? tab[i - 1] : nullptr, t / 16, t % 16);
  if (t == 0) {
    a.bq[2 * out] = 4 * fx + (i ? tab[i - 1][0] : 0);
    a.bq[2 * out + 1] = 4 * fy + (i ? tab[i - 1][1] : 0);
    a.bc[out] = (int)(best >> 32);
  }
}

template <int kThreads>
int fullpel_launch(const FullpelArgs& a, int mbh, void* stream) {
  if (a.mbw < 1 || mbh < 1 || a.range < 0 || a.range > kMaxRange ||
      (a.lanes != 1 && a.lanes != kLanes) || a.hp < 1 || a.wp < 1)
    return (int)cudaErrorInvalidValue;
  const int ww = 16 + 2 * a.range;
  const size_t smem = (size_t)ww * (((ww + 3) & ~3) + 4);
  me_fullpel_kernel<kThreads><<<a.mbw * mbh, kThreads, smem,
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

// The qpel refine of `lanes` partition lanes on `stream`: hpel [4][hp][wp],
// lane_mv [lanes][mbh * mbw][2], masks [lanes][16], tab [cands][9], mvp
// [mbh * mbw][2] or null; bq, bp, bc as _subpel_refine_scan returns them.
extern "C" int x264t_me_subpel(const uint8_t* hpel, int hp, int wp, int pad,
                               const uint8_t* src, int mbw, int mbh,
                               int lanes, const int32_t* lane_mv,
                               const int32_t* masks, const int32_t* tab,
                               int cands, const int32_t* mvp, int lam,
                               int32_t* bq, int32_t* bp, int32_t* bc,
                               void* stream) {
  if (mbw < 1 || mbh < 1 || lanes < 1 || cands < 1 || cands > kMaxCands ||
      hp < 1 || wp < 1)
    return (int)cudaErrorInvalidValue;
  const SubpelArgs a{hpel, src, lane_mv, masks, tab, mvp, bq, bp, bc,
                     hp,   wp,  pad,     mbw,   mbw * mbh, cands, lam};
  me_subpel_kernel<<<lanes * mbw * mbh, kSubThreads, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
