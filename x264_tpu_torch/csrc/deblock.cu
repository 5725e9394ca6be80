// In-loop deblocking filter (spec 8.7) for Hopper (sm_90a).
//
// Replaces x264_tpu/ops/deblock.py:263 deblock_frame, a jnp lax.scan over
// the frame's MB anti-diagonals (no Pallas kernel): XLA compiles the scan
// once and runs it as one device program per frame. Bit-exact twin of that
// scan and of the plain PyTorch version x264_tpu_torch/ops/deblock.py
// deblock_ref (every order).
//
// What it computes: a reconstructed 4:2:0 frame filtered in raster MB
// order. Per MB, the four vertical luma edges left to right (with chroma
// edges 0 and 4, from luma edges 0 and 2), then the four horizontal luma
// edges top to bottom (chroma edges 0 and 4). Edge 0 is the MB edge: its
// p side lies in the left (V) or top (H) MB. alpha and beta come from
// clamp(qp_avg + a_off / b_off, 0, 51), tc0 from [ia][clamp(bs, 1, 3) - 1];
// luma qp_avg is (qp_p + qp_q + 1) >> 1 on edge 0 and the MB's own QP
// inside, chroma maps each MB's QP through CHROMA_QP_TABLE first and then
// averages. bs 4 takes the strong filter, bs 1-3 the normal one, bs 0
// none. The picture's left and top edges get bs 0 here, without writing
// into the caller's strength tensors (which may be one tensor twice).
//
// What bounds it on this card: the dependency chain, not bytes or
// operations. A 1080p frame moves about 7.3 MB (planes read and written
// once: 2 x 3,133,440 B; bs_v and bs_h as int32: 2 x 522,240 B; the QP
// map), 2.2 us at 3.35 TB/s, and does about 192 line filters per MB. The
// chain comes from the pixels that two MBs' phases share. The V phase of
// MB (x, y) (its vertical edges) touches only MB row y: it needs V and H
// of (x - 1, y) and nothing of row y - 1. The H phase of (x, y) filters
// rows 12-15 of (x, y - 1), whose columns 13-15 the V edge 0 of
// (x + 1, y - 1) rewrites: it needs V(x, y) and V(x + 1, y - 1). So in
// half-steps, row y does V(x) at 2x + 2y and H(x) at 2x + 2y + 1:
// V(x, y) runs beside V(x + 1, y - 1) (disjoint rows) and H(x, y) beside
// H(x + 1, y - 1) (disjoint columns). The chain is mbw + mbh - 1 = 187
// MB steps at 1080p; with a publish per whole MB it would be
// mbw + 2 (mbh - 1) = 254 (deblock_frame_kernel_rowwarp below).
//
// deblock_frame_kernel, the main path: one persistent cooperative launch
// per frame. A block walks bands of kRows consecutive MB rows (band =
// blockIdx.x, + grid, ...) with kRows filter warps, warp w on row band *
// kRows + w, and two helper warps. Each row publishes a progress count
// twice per MB: 2x + 1 when V(x) is done, 2x + 2 when H(x) is done (2 mbw
// at its end). V(x) waits on nothing outside its row; H(x) waits until
// the row above has published min(2x + 3, 2 mbw). The filter warps wait
// on, and read, shared memory only (st.release.cta / ld.acquire.cta):
// each row keeps its last kSlots MBs, filtered so far, in a row buffer,
// and the row below reads the MB above's rows 12-15 (chroma 6-7) straight
// from it; a row does not overwrite a slot before the row below has
// filtered the MB under it. The band's first row reads the same from a
// row buffer that the waiter warp fills: it polls the progress word of
// the band above's last row in global memory (ld.acquire.gpu) and copies
// that row's MB strips, read at L2 past this SM's L1. The band's last row
// writes its MBs out before it counts them, and the releaser warp
// publishes its counts to global memory (st.release.gpu). So no filter
// warp waits on an L2 round trip or a gpu-scope fence: measured on the
// card, a row that did (the band's first and last) set the pace of every
// row below it. Before each MB, cp.async copies the next MB's source
// pixels, its 2 x 16 strength words and its three QPs into a two-slot
// ring in shared memory, so no load follows a wait. Rows rest on lower
// rows only (the row above, inside the block or in a block with a lower
// band), so with every block co-resident the walk cannot deadlock. A wait
// that runs past its bound sets the error word; every warp of every block
// then leaves, so nothing hangs.
//
// Inside an MB, lanes 0-15 take the 16 luma lines of an edge, lanes 16-23
// the 8 U lines, lanes 24-31 the 8 V lines: in the V phase a lane holds
// its line in registers and runs its edges in order, in the H phase its
// column. Luma and chroma lanes run one filter code path (a chroma line
// sits at the luma positions of the edges it shares), so the warp does
// not run the two one after the other. The filter works out of place: an
// MB's own pixels come from the source planes (no MB touches (x, y)
// before V(x, y), raster order), its neighbours' from the row buffers.
// Each output pixel is written once it is final: rows 0-12 (chroma 0-6)
// of MB x after V(x + 1) by its own row, rows 13-15 (chroma 7) after the
// row below's H phase by that row; a band's last row writes its whole MB
// for the band below to read, which then rewrites rows 13-15. The kernel
// allocates nothing and never reads outside the frame.
//
// deblock_frame_kernel_rowwarp, the first port's kernel, kept only so
// that a run on the card can time the two designs side by side: one warp
// per block, one MB row per warp, a progress count per whole MB through
// global memory and a gpu-scope fence after every MB (254 steps at 1080p).

#include <cstdint>
#include <cuda_runtime.h>

struct DeblockArgs {
  const uint8_t* y;       // source planes [H][W], [H/2][W/2]
  const uint8_t* u;
  const uint8_t* v;
  uint8_t* dy;            // filtered planes (outputs)
  uint8_t* du;
  uint8_t* dv;
  const int32_t* bs_v;    // [mbh][mbw][4 edges][4 lines], 0-4
  const int32_t* bs_h;
  const int32_t* qp;      // [mbh][mbw], the QPs the decoder carries
  int32_t mbw;
  int32_t mbh;
  int32_t a_off;
  int32_t b_off;
  int32_t cqpo;           // chroma_qp_offset
};

namespace {

constexpr int kRows = 4;              // MB rows (filter warps) per block
constexpr int kSlots = 4;             // MBs a row buffer keeps (power of 2)
constexpr int kSpinLimit = 1 << 22;   // polls before a wait fails
constexpr unsigned kFull = 0xffffffffu;

// spec tables 8-16 / 8-17 and the chroma QP table (8-15), qp 0..51
__constant__ uint8_t kAlpha[52] = {
    0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,
    0,   0,   0,   4,   4,   5,   6,   7,   8,   9,   10,  12,  13,
    15,  17,  20,  22,  25,  28,  32,  36,  40,  45,  50,  56,  63,
    71,  80,  90,  101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
__constant__ uint8_t kBeta[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  2, 2,
    2,  3,  3,  3,  3,  4,  4,  4,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
    11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
__constant__ uint8_t kTc0[52][3] = {
    {0, 0, 0},    {0, 0, 0},    {0, 0, 0},    {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},    {0, 0, 0},    {0, 0, 0},    {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},    {0, 0, 0},    {0, 0, 0},    {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},    {0, 0, 0},    {0, 0, 1},    {0, 0, 1},   {0, 0, 1},
    {0, 0, 1},    {0, 1, 1},    {0, 1, 1},    {1, 1, 1},   {1, 1, 1},
    {1, 1, 1},    {1, 1, 1},    {1, 1, 2},    {1, 1, 2},   {1, 1, 2},
    {1, 1, 2},    {1, 2, 3},    {1, 2, 3},    {2, 2, 3},   {2, 2, 4},
    {2, 3, 4},    {2, 3, 4},    {3, 3, 5},    {3, 4, 6},   {3, 4, 6},
    {4, 5, 7},    {4, 5, 8},    {4, 6, 9},    {5, 7, 10},  {6, 8, 11},
    {6, 8, 13},   {7, 10, 14},  {8, 11, 16},  {9, 12, 18}, {10, 13, 20},
    {11, 15, 23}, {13, 17, 25}};
__constant__ uint8_t kChromaQp[52] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33,
    34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};

// the tables above, copied to shared memory by each block
struct Tables {
  int alpha[52], beta[52], tc0[52][3], cqp[52];
};

__device__ __forceinline__ void load_tables(Tables& t, int tid, int n) {
  for (int i = tid; i < 52; i += n) {
    t.alpha[i] = kAlpha[i];
    t.beta[i] = kBeta[i];
    t.cqp[i] = kChromaQp[i];
    for (int k = 0; k < 3; ++k) t.tc0[i][k] = kTc0[i][k];
  }
}

// ---- memory-model and copy primitives (inline PTX) ----

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

// a progress word in shared memory, read and written at block scope
__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];"
               : "=r"(v)
               : "r"(s)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("st.release.cta.shared.s32 [%0], %1;" ::"r"(s), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_volatile_cta(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// pixels another block wrote: read at L2, past this SM's L1, which may
// hold a line from before that block wrote it
__device__ __forceinline__ uint4 ldcg16(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint2 ldcg8(const uint8_t* p) {
  uint2 v;
  asm volatile("ld.global.cg.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p)
               : "memory");
  return v;
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

// every group but the newest has landed (for this thread)
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// ---- end of the primitives ----

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ void unpack4(unsigned w, int* out) {
#pragma unroll
  for (int b = 0; b < 4; ++b) out[b] = (w >> (8 * b)) & 255;
}

__device__ __forceinline__ unsigned pack4(const int* in) {
  return (unsigned)in[0] | ((unsigned)in[1] << 8) | ((unsigned)in[2] << 16) |
         ((unsigned)in[3] << 24);
}

struct EdgeParams {
  int alpha, beta, tc0;
};

__device__ __forceinline__ EdgeParams edge_params(const Tables& t, int qp_av,
                                                  int a_off, int b_off,
                                                  int bs) {
  const int ia = clip3(0, 51, qp_av + a_off);
  const int ib = clip3(0, 51, qp_av + b_off);
  return {t.alpha[ia], t.beta[ib], t.tc0[ia][clip3(1, 3, bs) - 1]};
}

// One luma line across an edge: x[0..7] = p3 p2 p1 p0 q0 q1 q2 q3
// (x264_tpu/ops/deblock.py:49 filter_lines_luma).
__device__ __forceinline__ void filter_luma(int* x, int bs, EdgeParams e) {
  const int p3 = x[0], p2 = x[1], p1 = x[2], p0 = x[3];
  const int q0 = x[4], q1 = x[5], q2 = x[6], q3 = x[7];
  if (bs <= 0 || abs(p0 - q0) >= e.alpha || abs(p1 - p0) >= e.beta ||
      abs(q1 - q0) >= e.beta)
    return;
  const bool ap = abs(p2 - p0) < e.beta, aq = abs(q2 - q0) < e.beta;
  if (bs == 4) {
    const bool cond = abs(p0 - q0) < ((e.alpha >> 2) + 2);
    if (ap && cond) {
      x[3] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      x[2] = (p2 + p1 + p0 + q0 + 2) >> 2;
      x[1] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      x[3] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && cond) {
      x[4] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
      x[5] = (q2 + q1 + q0 + p0 + 2) >> 2;
      x[6] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      x[4] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
    return;
  }
  const int tc = e.tc0 + ap + aq;
  const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
  x[3] = clip3(0, 255, p0 + delta);
  x[4] = clip3(0, 255, q0 - delta);
  const int avg = (p0 + q0 + 1) >> 1;
  if (ap) x[2] = p1 + clip3(-e.tc0, e.tc0, (p2 + avg - (p1 << 1)) >> 1);
  if (aq) x[5] = q1 + clip3(-e.tc0, e.tc0, (q2 + avg - (q1 << 1)) >> 1);
}

// One chroma line: x[0..3] = p1 p0 q0 q1 (filter_lines_chroma, :110).
__device__ __forceinline__ void filter_chroma(int* x, int bs, EdgeParams e) {
  const int p1 = x[0], p0 = x[1], q0 = x[2], q1 = x[3];
  if (bs <= 0 || abs(p0 - q0) >= e.alpha || abs(p1 - p0) >= e.beta ||
      abs(q1 - q0) >= e.beta)
    return;
  if (bs == 4) {
    x[1] = (2 * p1 + p0 + q1 + 2) >> 2;
    x[2] = (2 * q1 + q0 + p1 + 2) >> 2;
    return;
  }
  const int tc = e.tc0 + 1;
  const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
  x[1] = clip3(0, 255, p0 + delta);
  x[2] = clip3(0, 255, q0 - delta);
}

// One line across an edge, luma or chroma, in one code path (so that the
// luma and chroma lanes of a warp do not diverge): x[0..7] = p3 p2 p1 p0
// q0 q1 q2 q3. A chroma line uses p1 p0 q0 q1: with ap and aq false the
// luma filter's strong branch is the chroma strong filter, and its
// normal branch the chroma one once tc is tc0 + 1.
__device__ __forceinline__ void filter_line(int* x, int bs, EdgeParams e,
                                            bool chroma) {
  const int p3 = x[0], p2 = x[1], p1 = x[2], p0 = x[3];
  const int q0 = x[4], q1 = x[5], q2 = x[6], q3 = x[7];
  if (bs <= 0 || abs(p0 - q0) >= e.alpha || abs(p1 - p0) >= e.beta ||
      abs(q1 - q0) >= e.beta)
    return;
  const bool ap = !chroma && abs(p2 - p0) < e.beta;
  const bool aq = !chroma && abs(q2 - q0) < e.beta;
  if (bs == 4) {
    const bool cond = abs(p0 - q0) < ((e.alpha >> 2) + 2);
    if (ap && cond) {
      x[3] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      x[2] = (p2 + p1 + p0 + q0 + 2) >> 2;
      x[1] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      x[3] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && cond) {
      x[4] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
      x[5] = (q2 + q1 + q0 + p0 + 2) >> 2;
      x[6] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      x[4] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
    return;
  }
  const int tc = chroma ? e.tc0 + 1 : e.tc0 + ap + aq;
  const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
  x[3] = clip3(0, 255, p0 + delta);
  x[4] = clip3(0, 255, q0 - delta);
  const int avg = (p0 + q0 + 1) >> 1;
  if (ap) x[2] = p1 + clip3(-e.tc0, e.tc0, (p2 + avg - (p1 << 1)) >> 1);
  if (aq) x[5] = q1 + clip3(-e.tc0, e.tc0, (q2 + avg - (q1 << 1)) >> 1);
}

// The four V (H) edges of a line held in r[0..19] (positions -4..15
// across the edges): bs[e] and the averaged QPs of edge 0 and of the
// inner edges. A chroma line sits at the luma positions of the edges it
// shares (chroma_pos), with bs 0 on edges 1 and 3.
__device__ __forceinline__ void line_edges(const Tables& t, int* r,
                                           const int* bs, int q_edge,
                                           int q_in, int a_off, int b_off,
                                           bool chroma) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int qav = e == 0 ? q_edge : q_in;
    filter_line(r + 4 * e, bs[e], edge_params(t, qav, a_off, b_off, bs[e]),
                chroma);
  }
}

// Where chroma positions -2..7 of a line sit in r: -2..1 at 2..5 (p1..q1
// of luma edge 0), 2..7 at 10..15 (p1..q1 of luma edge 2 are 2..5).
__device__ __forceinline__ constexpr int chroma_pos(int j) {
  return j < 4 ? 2 + j : 6 + j;
}

// ====================================================================
// deblock_frame_kernel: kRows MB rows per block, phased progress
// ====================================================================

// One MB's inputs, copied ahead with cp.async.
struct alignas(16) MbSrc {
  uint8_t y[16][16];
  uint8_t c[2][8][8];       // U, V
  int bsv[16], bsh[16];     // [edge][line]
  int qp[4];                // current, left, top (the current one where
                            // there is no neighbour), unused
};

// One MB row's last kSlots MBs as filtered so far (MB x in slot
// x % kSlots). Row pitches of 16 kSlots + 16 and 8 kSlots + 8 bytes put
// the 16-byte rows of 8 lanes on distinct banks.
struct alignas(16) RowBuf {
  uint8_t y[16][16 * kSlots + 16];
  uint8_t c[2][8][8 * kSlots + 8];
};

template <int R>
struct RowsSmem {
  Tables t;
  MbSrc src[R][2];          // each row's two-slot input ring
  // row[0]: rows 12-15 (chroma 6-7) of the MB row above the band, copied
  // by the waiter warp; row[1 + w]: MB row w of the band
  RowBuf row[R + 1];
  int prog[R + 1];          // progress of the same, counted on over bands
  int abort;                // a wait of this block failed
};

// Copy MB x of row y into the ring slot m (one or two cp.async a lane).
__device__ __forceinline__ void prefetch_mb(const DeblockArgs& a, MbSrc& m,
                                            int y, int x, int lane) {
  const int mbw = a.mbw, W = 16 * mbw, Wc = 8 * mbw, mb = y * mbw + x;
  if (lane < 16) {
    cp_async16(m.y[lane], a.y + (size_t)(16 * y + lane) * W + 16 * x);
  } else {
    const int c = (lane >> 3) & 1, k = lane & 7;
    cp_async8(m.c[c][k], (c ? a.v : a.u) + (size_t)(8 * y + k) * Wc + 8 * x);
  }
  if (lane < 4) {
    cp_async16(m.bsv + 4 * lane, a.bs_v + 16 * (size_t)mb + 4 * lane);
  } else if (lane < 8) {
    cp_async16(m.bsh + 4 * (lane - 4), a.bs_h + 16 * (size_t)mb +
                                           4 * (lane - 4));
  } else if (lane < 11) {
    const int j = lane - 8;
    const int at = j == 1 ? (x > 0 ? mb - 1 : mb)
                          : j == 2 ? (y > 0 ? mb - mbw : mb) : mb;
    cp_async4(m.qp + j, a.qp + at);
  }
}

// Rows [0, ny) of MB x of row y (chroma [0, nc)) from the row buffer to
// the output planes; lane = luma row, or chroma plane and row.
__device__ __forceinline__ void store_mb(const DeblockArgs& a,
                                         const RowBuf& b, int y, int x,
                                         int ny, int nc, int lane) {
  const int W = 16 * a.mbw, Wc = 8 * a.mbw, slot = x & (kSlots - 1);
  if (lane < 16) {
    if (lane < ny)
      *reinterpret_cast<uint4*>(a.dy + (size_t)(16 * y + lane) * W +
                                16 * x) =
          *reinterpret_cast<const uint4*>(&b.y[lane][16 * slot]);
  } else {
    const int c = (lane >> 3) & 1, k = lane & 7;
    if (k < nc)
      *reinterpret_cast<uint2*>((c ? a.dv : a.du) + (size_t)(8 * y + k) * Wc +
                                8 * x) =
          *reinterpret_cast<const uint2*>(&b.c[c][k][8 * slot]);
  }
}

// Wait until *p (shared, block scope) >= need. Lane 0 polls, the warp
// syncs behind it; `known` is lane 0's last reading. Returns false when
// the block aborted or the wait ran past its bound (which sets the error
// word).
__device__ __forceinline__ bool wait_cta(const int* p, int need, int& known,
                                         const int* abort, int* err,
                                         int lane) {
  int ok = 1;
  if (lane == 0 && known < need) {
    for (int it = 1; (known = ld_acquire_cta(p)) < need; ++it) {
      if ((it & 255) == 0) {
        if (ld_volatile_cta(abort) != 0) { ok = 0; break; }
        if (it >= kSpinLimit) {
          atomicExch(err, 1);
          ok = 0;
          break;
        }
      }
    }
  }
  __syncwarp();
  return __shfl_sync(kFull, ok, 0) != 0;
}

// The same on a progress word in global memory (another block's row).
__device__ __forceinline__ bool wait_gpu(const int* p, int need, int& known,
                                         int* err, int lane) {
  int ok = 1;
  if (lane == 0 && known < need) {
    for (int it = 1; (known = ld_acquire(p)) < need; ++it) {
      if ((it & 255) == 0) {
        if (ld_relaxed(err) != 0) { ok = 0; break; }
        if (it >= kSpinLimit) {
          atomicExch(err, 1);
          ok = 0;
          break;
        }
      }
    }
  }
  __syncwarp();
  return __shfl_sync(kFull, ok, 0) != 0;
}

// Filter MB row y, warp w of the band, in the phased order; `last` if it
// is the band's last row. Everything it waits on and reads of other rows
// is in shared memory: the row above is row buffer w (the waiter's copy
// for w = 0), and its own is w + 1. `base` is what the block's progress
// words held when the band began. Returns false when a wait failed.
template <int R>
__device__ __forceinline__ bool filter_row(const DeblockArgs& a, int* prog,
                                           RowsSmem<R>& s, int w, int lane,
                                           int y, bool last, int base) {
  const int mbw = a.mbw, W = 16 * mbw, Wc = 8 * mbw;
  int* err = prog + a.mbh;
  const bool at = y > 0;
  const int c = (lane >> 3) & 1, k = lane & 7;   // chroma lanes
  uint8_t* cdst = c ? a.dv : a.du;
  const RowBuf& up = s.row[w];
  RowBuf& me = s.row[w + 1];
  int* mine = &s.prog[w + 1];
  const int a_off = a.a_off, b_off = a.b_off, cqpo = a.cqpo;
  int up_known = 0, down_known = 0;              // lane 0's readings

  prefetch_mb(a, s.src[w][0], y, 0, lane);
  cp_async_commit();
  for (int x = 0; x < mbw; ++x) {
    const int slot = x & (kSlots - 1);
    const bool al = x > 0;
    // MB x + 1 lands in the other ring slot while MB x filters
    if (x + 1 < mbw) prefetch_mb(a, s.src[w][(x + 1) & 1], y, x + 1, lane);
    cp_async_commit();
    cp_async_wait_prev();
    __syncwarp();
    const MbSrc& m = s.src[w][x & 1];
    const int q_cur = m.qp[0], q_left = m.qp[1], q_top = m.qp[2];
    // slot x last held MB x - kSlots: the row below must have filtered
    // the MB under it (its H phase reads that MB's rows 12-15)
    if (!last && x >= kSlots &&
        !wait_cta(&s.prog[w + 2], base + 2 * (x - kSlots) + 2, down_known,
                  &s.abort, err, lane))
      return false;

    // ---- V(x): lane = row; the left border is MB x - 1's columns 12-15
    // (chroma 6-7) in the row buffer ----
    const int cq = lane < 16 ? 0 : cqpo;    // chroma lanes map their QPs
    const int l_cur = lane < 16 ? q_cur : s.t.cqp[clip3(0, 51, q_cur + cq)];
    const int l_left =
        lane < 16 ? q_left : s.t.cqp[clip3(0, 51, q_left + cq)];
    const int l_top = lane < 16 ? q_top : s.t.cqp[clip3(0, 51, q_top + cq)];
    const int line = lane < 16 ? lane >> 2 : k >> 1;   // its strength word
    int r[20];
    if (lane < 16) {
      const int lo = (16 * x - 4) & (16 * kSlots - 1);
      unpack4(al ? *reinterpret_cast<const unsigned*>(&me.y[lane][lo]) : 0u,
              r);
      const uint4 v = *reinterpret_cast<const uint4*>(m.y[lane]);
      unpack4(v.x, r + 4);
      unpack4(v.y, r + 8);
      unpack4(v.z, r + 12);
      unpack4(v.w, r + 16);
    } else {
#pragma unroll
      for (int j = 0; j < 20; ++j) r[j] = 0;
      const int lo = (8 * x - 2) & (8 * kSlots - 1);
      const unsigned lw =
          al ? *reinterpret_cast<const uint16_t*>(&me.c[c][k][lo]) : 0u;
      r[chroma_pos(0)] = lw & 255;
      r[chroma_pos(1)] = lw >> 8;
      const uint2 v = *reinterpret_cast<const uint2*>(m.c[c][k]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[chroma_pos(2 + j)] = ((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 255;
    }
    {
      int bs[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bs[e] = (e == 0 && !al) || (lane >= 16 && (e & 1))
                    ? 0 : m.bsv[4 * e + line];
      line_edges(s.t, r, bs, (l_left + l_cur + 1) >> 1, l_cur, a_off, b_off,
                 lane >= 16);
    }
    if (lane < 16) {
      const int lo = (16 * x - 4) & (16 * kSlots - 1);
      if (al) *reinterpret_cast<unsigned*>(&me.y[lane][lo]) = pack4(r);
      *reinterpret_cast<uint4*>(&me.y[lane][16 * slot]) =
          make_uint4(pack4(r + 4), pack4(r + 8), pack4(r + 12),
                     pack4(r + 16));
    } else {
      const int lo = (8 * x - 2) & (8 * kSlots - 1);
      if (al)
        *reinterpret_cast<uint16_t*>(&me.c[c][k][lo]) =
            (uint16_t)(r[chroma_pos(0)] | (r[chroma_pos(1)] << 8));
      unsigned w0 = 0, w1 = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w0 |= (unsigned)r[chroma_pos(2 + j)] << (8 * j);
        w1 |= (unsigned)r[chroma_pos(6 + j)] << (8 * j);
      }
      *reinterpret_cast<uint2*>(&me.c[c][k][8 * slot]) = make_uint2(w0, w1);
    }
    __syncwarp();
    // MB x - 1 is final down to row 12 (chroma 6): the row below filters
    // rows 13-15 (chroma 7). The band's last row writes them too, for the
    // band below to read, before its count tells the releaser so.
    if (al && last) {
      store_mb(a, me, y, x - 1, 16, 8, lane);
      __syncwarp();
    }
    if (lane == 0) st_release_cta(mine, base + 2 * x + 1);
    if (al && !last) store_mb(a, me, y, x - 1, 13, 7, lane);

    // ---- H(x): lane = column; wait until the row above has done
    // V(x + 1) (the whole row, for its last MB) ----
    if (at && !wait_cta(&s.prog[w], base + min(2 * x + 3, 2 * mbw),
                        up_known, &s.abort, err, lane))
      return false;
    if (lane < 16) {
      const int col = 16 * slot + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = at ? up.y[12 + j][col] : 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) r[4 + j] = me.y[j][col];
    } else {
      const int col = 8 * slot + k;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        r[chroma_pos(j)] = at ? up.c[c][6 + j][col] : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) r[chroma_pos(2 + j)] = me.c[c][j][col];
    }
    {
      int bs[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bs[e] = (e == 0 && !at) || (lane >= 16 && (e & 1))
                    ? 0 : m.bsh[4 * e + line];
      line_edges(s.t, r, bs, (l_top + l_cur + 1) >> 1, l_cur, a_off, b_off,
                 lane >= 16);
    }
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        me.y[j][16 * slot + lane] = (uint8_t)r[4 + j];
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        me.c[c][j][8 * slot + k] = (uint8_t)r[chroma_pos(2 + j)];
    }
    __syncwarp();
    if (x + 1 == mbw && last) {
      // the row's last MB is final
      store_mb(a, me, y, x, 16, 8, lane);
      __syncwarp();
    }
    if (lane == 0) st_release_cta(mine, base + 2 * x + 2);
    // rows 13-15 (chroma 7) of the MB above are final
    if (at) {
      if (lane < 16) {
        uint8_t* top = a.dy + (size_t)(16 * y - 3) * W + 16 * x + lane;
#pragma unroll
        for (int j = 0; j < 3; ++j) top[(size_t)j * W] = (uint8_t)r[1 + j];
      } else {
        cdst[(size_t)(8 * y - 1) * Wc + 8 * x + k] =
            (uint8_t)r[chroma_pos(1)];
      }
    }
    if (x + 1 == mbw && !last) {
      // the row's last MB is final down to row 12 (chroma 6)
      store_mb(a, me, y, x, 13, 7, lane);
      if (lane == 0) prog[y] = 2 * mbw;      // read only after the launch
    }
  }
  return true;
}

// The waiter warp of the band whose first row is y0 > 0: for each MB x,
// wait until the band above's last row (another block's, in global
// memory) has published min(2x + 3, 2 mbw), copy rows 12-15 (chroma 6-7)
// of its MB x, read at L2 past this SM's L1, into row buffer 0, and count
// the same on the shared progress word 0. It does not overwrite a slot
// before the band's first row has filtered the MB under it.
template <int R>
__device__ __forceinline__ bool copy_top(const DeblockArgs& a, int* prog,
                                         RowsSmem<R>& s, int lane, int y0,
                                         int base) {
  const int mbw = a.mbw, W = 16 * mbw, Wc = 8 * mbw;
  int* err = prog + a.mbh;
  RowBuf& top = s.row[0];
  int known = 0, down_known = 0;                 // lane 0's readings
  for (int x = 0; x < mbw; ++x) {
    const int slot = x & (kSlots - 1), need = min(2 * x + 3, 2 * mbw);
    if (x >= kSlots &&
        !wait_cta(&s.prog[1], base + 2 * (x - kSlots) + 2, down_known,
                  &s.abort, err, lane))
      return false;
    if (!wait_gpu(prog + y0 - 1, need, known, err, lane)) return false;
    if (lane < 4) {
      *reinterpret_cast<uint4*>(&top.y[12 + lane][16 * slot]) =
          ldcg16(a.dy + (size_t)(16 * y0 - 4 + lane) * W + 16 * x);
    } else if (lane < 8) {
      const int c = (lane - 4) >> 1, j = lane & 1;
      *reinterpret_cast<uint2*>(&top.c[c][6 + j][8 * slot]) =
          ldcg8((c ? a.dv : a.du) + (size_t)(8 * y0 - 2 + j) * Wc + 8 * x);
    }
    __syncwarp();
    if (lane == 0) st_release_cta(&s.prog[0], base + need);
  }
  return true;
}

// The releaser warp: publish the progress of the band's last row (warp
// w, MB row y) to global memory for the band below, with a gpu-scope
// release of each new count it sees (the row wrote its MBs out before
// counting them), until the row is done. The filter warps thus never
// wait on a gpu-scope fence. Lane 0 works, the warp follows.
template <int R>
__device__ __forceinline__ bool release_row(int* prog, int* err,
                                            RowsSmem<R>& s, int lane, int w,
                                            int y, int mbw, int base) {
  int ok = 1;
  if (lane == 0) {
    for (int done = 0, it = 1; done < 2 * mbw; ++it) {
      const int v = ld_acquire_cta(&s.prog[w + 1]) - base;
      if (v > done) {
        st_release(prog + y, v);
        done = v;
        it = 0;
        continue;
      }
      __nanosleep(32);    // leave the schedulers to the filter warps
      if ((it & 255) == 0) {
        if (ld_volatile_cta(&s.abort) != 0) { ok = 0; break; }
        if (it >= kSpinLimit) {
          atomicExch(err, 1);
          ok = 0;
          break;
        }
      }
    }
  }
  __syncwarp();
  return __shfl_sync(kFull, ok, 0) != 0;
}

// kRows filter warps, then the waiter and the releaser.
template <int R>
__global__ void __launch_bounds__(32 * (R + 2))
deblock_frame_kernel(DeblockArgs a, int* prog, int grid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowsSmem<R>& s = *reinterpret_cast<RowsSmem<R>*>(smem_raw);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  load_tables(s.t, threadIdx.x, 32 * (R + 2));
  if (threadIdx.x <= R) s.prog[threadIdx.x] = 0;
  if (threadIdx.x == 0) s.abort = 0;
  __syncthreads();
  const int bands = (a.mbh + R - 1) / R;
  // the progress words count on from band to band, 2 mbw per band, so a
  // band's waits never see the band before it as progress
  int base = 0;
  for (int band = blockIdx.x; band < bands;
       band += grid, base += 2 * a.mbw) {
    const int y0 = band * R, rows = min(R, a.mbh - y0);
    bool ok = true;
    if (w < rows)
      ok = filter_row<R>(a, prog, s, w, lane, y0 + w, w == rows - 1, base);
    else if (w == R && y0 > 0)
      ok = copy_top<R>(a, prog, s, lane, y0, base);
    else if (w == R + 1)
      ok = release_row<R>(prog, prog + a.mbh, s, lane, rows - 1,
                          y0 + rows - 1, a.mbw, base);
    if (!ok && lane == 0) *reinterpret_cast<volatile int*>(&s.abort) = 1;
    // the next band overwrites the row buffers the band's rows read
    __syncthreads();
    if (ld_volatile_cta(&s.abort) != 0) return;
  }
}

template <int R>
int rows_capacity() {
  const void* fn = (const void*)deblock_frame_kernel<R>;
  const int bytes = (int)sizeof(RowsSmem<R>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && bytes > 48 * 1024)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, deblock_frame_kernel<R>, 32 * (R + 2), bytes);
  return e == cudaSuccess ? per_sm * sms : -(int)e;
}

template <int R>
int rows_launch(const DeblockArgs* a, int* prog, int grid, void* stream) {
  if (a->mbw < 1 || a->mbh < 1 || grid < 1 || grid > (a->mbh + R - 1) / R)
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)deblock_frame_kernel<R>;
  const int bytes = (int)sizeof(RowsSmem<R>);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  DeblockArgs args = *a;
  void* params[] = {&args, &prog, &grid};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(32 * (R + 2)), params, bytes,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ====================================================================
// deblock_frame_kernel_rowwarp: the first port's kernel (timing only)
// ====================================================================

struct RowwarpSmem {
  Tables t;
  // the MB and its left / top border: luma rows and columns -4..15,
  // chroma -2..7 (U, V); odd row pitches keep a warp's column and row
  // accesses on distinct banks
  int ty[20][21];
  int tc[2][10][11];
};

// Wait until row - 1 has finished `need` MBs: lane 0 polls with acquire
// loads, the warp syncs behind it. Returns false when the wait ran past
// its bound (the error word is then set) or another block failed.
__device__ __forceinline__ bool wait_row(const int* prog, int* err, int row,
                                         int need, int lane) {
  int ok = 1;
  if (lane == 0) {
    for (int it = 1; ld_acquire(prog + row - 1) < need; ++it) {
      if ((it & 255) == 0) {
        if (ld_relaxed(err) != 0) { ok = 0; break; }
        if (it >= kSpinLimit) {
          atomicExch(err, 1);
          ok = 0;
          break;
        }
      }
    }
  }
  // the other lanes read the row above only after lane 0's acquire
  __syncwarp();
  return __shfl_sync(kFull, ok, 0) != 0;
}

// One warp per block; the blocks walk MB rows r = blockIdx.x, + grid, ...
// left to right, and before MB x of row r > 0 wait until row r - 1 has
// published progress >= min(x + 2, mbw) (release store after each MB).
// The MB with its left and top border is staged in shared memory between
// the phases; the left border is the block's own previous MB, the top
// border another block's writes, read past L1 after the acquire. Every MB
// writes its whole tile, the left MB's columns 13-15 and the top MB's
// rows 13-15.
__global__ void __launch_bounds__(32)
deblock_frame_kernel_rowwarp(DeblockArgs a, int* prog, int grid) {
  __shared__ RowwarpSmem s;
  const int lane = threadIdx.x;
  const int mbw = a.mbw, mbh = a.mbh, W = 16 * mbw, Wc = 8 * mbw;
  int* err = prog + mbh;
  load_tables(s.t, lane, 32);
  // chroma lanes: plane c (0 U, 1 V), line k
  const int c = (lane >> 3) & 1, k = lane & 7;
  const uint8_t* csrc = c ? a.v : a.u;
  uint8_t* cdst = c ? a.dv : a.du;
  __syncwarp();

  for (int row = blockIdx.x; row < mbh; row += grid) {
    for (int x = 0; x < mbw; ++x) {
      const bool al = x > 0, at = row > 0;
      if (at && !wait_row(prog, err, row, min(x + 2, mbw), lane)) return;
      const int mb = row * mbw + x;
      const int q_cur = __ldg(a.qp + mb);
      const int q_left = al ? __ldg(a.qp + mb - 1) : q_cur;
      const int q_top = at ? __ldg(a.qp + mb - mbw) : q_cur;
      const int* bsv = a.bs_v + 16 * mb;
      const int* bsh = a.bs_h + 16 * mb;

      // ---- load: the top border (another block's pixels, after the
      // acquire) into shared memory; each lane's own row into registers,
      // its left border from the previous MB's tile ----
      if (lane < 4) {
        const uint4 w = at ? ldcg16(a.dy + (16 * row - 4 + lane) * W + 16 * x)
                           : make_uint4(0, 0, 0, 0);
        unpack4(w.x, s.ty[lane] + 4);
        unpack4(w.y, s.ty[lane] + 8);
        unpack4(w.z, s.ty[lane] + 12);
        unpack4(w.w, s.ty[lane] + 16);
      } else if (lane < 8) {
        const int tcp = (lane - 4) >> 1, tk = lane & 1;
        const uint2 w = at ? ldcg8((tcp ? a.dv : a.du) +
                                   (8 * row - 2 + tk) * Wc + 8 * x)
                           : make_uint2(0, 0);
        unpack4(w.x, s.tc[tcp][tk] + 2);
        unpack4(w.y, s.tc[tcp][tk] + 6);
      }
      int r[20];   // luma row, cols -4..15; chroma row in r[0..9], -2..7
      if (lane < 16) {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = al ? s.ty[4 + lane][16 + j] : 0;
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(
            a.y + (16 * row + lane) * W + 16 * x));
        unpack4(w.x, r + 4);
        unpack4(w.y, r + 8);
        unpack4(w.z, r + 12);
        unpack4(w.w, r + 16);
      } else {
        r[0] = al ? s.tc[c][2 + k][8] : 0;
        r[1] = al ? s.tc[c][2 + k][9] : 0;
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(
            csrc + (8 * row + k) * Wc + 8 * x));
        unpack4(w.x, r + 2);
        unpack4(w.y, r + 6);
      }

      // ---- V edges, left to right: lane = row ----
      if (lane < 16) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int bs =
              (e == 0 && !al) ? 0 : __ldg(bsv + 4 * e + (lane >> 2));
          const int qav = e == 0 ? (q_left + q_cur + 1) >> 1 : q_cur;
          filter_luma(r + 4 * e, bs,
                      edge_params(s.t, qav, a.a_off, a.b_off, bs));
        }
#pragma unroll
        for (int j = 0; j < 20; ++j) s.ty[4 + lane][j] = r[j];
      } else {
        const int cq_cur = s.t.cqp[clip3(0, 51, q_cur + a.cqpo)];
        const int cq_left = s.t.cqp[clip3(0, 51, q_left + a.cqpo)];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bs =
              (e == 0 && !al) ? 0 : __ldg(bsv + 8 * e + (k >> 1));
          const int qav = e == 0 ? (cq_left + cq_cur + 1) >> 1 : cq_cur;
          filter_chroma(r + 4 * e, bs,
                        edge_params(s.t, qav, a.a_off, a.b_off, bs));
        }
#pragma unroll
        for (int j = 0; j < 10; ++j) s.tc[c][2 + k][j] = r[j];
      }
      __syncwarp();

      // ---- H edges, top to bottom: lane = column ----
      if (lane < 16) {
#pragma unroll
        for (int j = 0; j < 20; ++j) r[j] = s.ty[j][4 + lane];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int bs =
              (e == 0 && !at) ? 0 : __ldg(bsh + 4 * e + (lane >> 2));
          const int qav = e == 0 ? (q_top + q_cur + 1) >> 1 : q_cur;
          filter_luma(r + 4 * e, bs,
                      edge_params(s.t, qav, a.a_off, a.b_off, bs));
        }
#pragma unroll
        for (int j = 0; j < 20; ++j) s.ty[j][4 + lane] = r[j];
      } else {
        const int cq_cur = s.t.cqp[clip3(0, 51, q_cur + a.cqpo)];
        const int cq_top = s.t.cqp[clip3(0, 51, q_top + a.cqpo)];
#pragma unroll
        for (int j = 0; j < 10; ++j) r[j] = s.tc[c][j][2 + k];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bs =
              (e == 0 && !at) ? 0 : __ldg(bsh + 8 * e + (k >> 1));
          const int qav = e == 0 ? (cq_top + cq_cur + 1) >> 1 : cq_cur;
          filter_chroma(r + 4 * e, bs,
                        edge_params(s.t, qav, a.a_off, a.b_off, bs));
        }
#pragma unroll
        for (int j = 0; j < 10; ++j) s.tc[c][j][2 + k] = r[j];
      }
      __syncwarp();

      // ---- store: the MB, the left MB's columns 13-15 (chroma 7) and
      // the top MB's rows 13-15 (chroma 7), where they exist ----
      if (lane < 16) {
        const int* t = s.ty[4 + lane];
        uint8_t* d = a.dy + (16 * row + lane) * W + 16 * x;
        *reinterpret_cast<uint4*>(d) =
            make_uint4(pack4(t + 4), pack4(t + 8), pack4(t + 12),
                       pack4(t + 16));
        if (al) {
          d[-3] = (uint8_t)t[1];
          d[-2] = (uint8_t)t[2];
          d[-1] = (uint8_t)t[3];
        }
        if (at && lane < 3) {
          const int* tt = s.ty[1 + lane];
          *reinterpret_cast<uint4*>(a.dy + (16 * row - 3 + lane) * W +
                                    16 * x) =
              make_uint4(pack4(tt + 4), pack4(tt + 8), pack4(tt + 12),
                         pack4(tt + 16));
        }
      } else {
        const int* t = s.tc[c][2 + k];
        uint8_t* d = cdst + (8 * row + k) * Wc + 8 * x;
        *reinterpret_cast<uint2*>(d) = make_uint2(pack4(t + 2), pack4(t + 6));
        if (al) d[-1] = (uint8_t)t[1];
        if (at && k == 0) {
          const int* tt = s.tc[c][1];
          *reinterpret_cast<uint2*>(cdst + (8 * row - 1) * Wc + 8 * x) =
              make_uint2(pack4(tt + 2), pack4(tt + 6));
        }
      }
      // publish: every lane's stores are fenced before the release
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(prog + row, x + 1);
    }
  }
}

}  // namespace

// MB rows per block of deblock_frame_kernel (the band height).
extern "C" int x264t_deblock_rows() { return kRows; }

// How many blocks of deblock_frame_kernel the card holds at once (blocks
// per SM times SMs), or minus a CUDA error code.
extern "C" int x264t_deblock_capacity() { return rows_capacity<kRows>(); }

// Launch the deblock of one frame on `stream`: `grid` persistent blocks
// of kRows warps (1 <= grid <= min(ceil(mbh / kRows), capacity)), all
// co-resident by a cooperative launch. `prog` holds mbh + 1 zeroed int32:
// each MB row's progress (2 mbw once the row is done), then the error
// word, which the kernel sets when a wait runs past its bound. Returns
// the launch's CUDA error (0 on success).
extern "C" int x264t_deblock_frame(const DeblockArgs* a, int* prog, int grid,
                                   void* stream) {
  return rows_launch<kRows>(a, prog, grid, stream);
}

// The same kernel with `rows` (1, 2, 4 or 8) MB rows per block, so that a
// run on the card can time the band heights side by side; grid <=
// ceil(mbh / rows), and the launch fails if the card cannot hold them.
extern "C" int x264t_deblock_frame_rows(const DeblockArgs* a, int* prog,
                                        int grid, int rows, void* stream) {
  switch (rows) {
    case 1: return rows_launch<1>(a, prog, grid, stream);
    case 2: return rows_launch<2>(a, prog, grid, stream);
    case 4: return rows_launch<4>(a, prog, grid, stream);
    case 8: return rows_launch<8>(a, prog, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of deblock_frame_kernel_rowwarp the card holds at once.
extern "C" int x264t_deblock_rowwarp_capacity() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, deblock_frame_kernel_rowwarp, 32, 0);
  return e == cudaSuccess ? per_sm * sms : -(int)e;
}

// The first port's launch (one warp per MB row, 1 <= grid <= min(mbh,
// capacity)); `prog` as above, each row's count of finished MBs (mbw once
// the row is done). For timing beside x264t_deblock_frame only.
extern "C" int x264t_deblock_frame_rowwarp(const DeblockArgs* a, int* prog,
                                           int grid, void* stream) {
  if (a->mbw < 1 || a->mbh < 1 || grid < 1 || grid > a->mbh)
    return (int)cudaErrorInvalidValue;
  DeblockArgs args = *a;
  void* params[] = {&args, &prog, &grid};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)deblock_frame_kernel_rowwarp, dim3(grid), dim3(32), params,
      0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// sizeof(DeblockArgs), so the binding can check its struct layout.
extern "C" int x264t_deblock_args_size() { return (int)sizeof(DeblockArgs); }
