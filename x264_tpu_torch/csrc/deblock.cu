// In-loop deblocking filter (spec 8.7) for Hopper (sm_90a).
//
// Replaces x264_tpu/ops/deblock.py:263 deblock_frame, a jnp lax.scan over
// the frame's MB anti-diagonals (no Pallas kernel): XLA compiles the scan
// once and runs it as one device program per frame. Bit-exact twin of that
// scan and of the plain PyTorch version x264_tpu_torch/ops/deblock.py
// deblock_ref (either order).
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
// map), 2.2 us at 3.35 TB/s, and does about 192 line filters per MB. But
// MB (x, y) may start only when (x - 1, y), (x, y - 1) and (x + 1, y - 1)
// are final: the V edge 0 of (x + 1, y - 1) rewrites columns 13-15 of
// (x, y - 1), whose rows 12-15 are the p side of (x, y)'s top edge. With
// whole-MB steps the chain is mbw + 2 (mbh - 1) MB steps, 254 at 1080p,
// each the latency of one MB's 8 luma and 4 chroma edges in one warp.
//
// deblock_frame_kernel: one persistent cooperative launch per frame (as
// commit.cu's commit_frame_kernel). One warp per block; the blocks walk
// MB rows r = blockIdx.x, + grid, ... left to right, and before MB x of
// row r > 0 wait until row r - 1 has published progress >= min(x + 2,
// mbw) (release store after each MB, acquire load). Row r waits only on
// the lower row r - 1, so with every block co-resident the walk cannot
// deadlock. A wait that runs past its bound sets the error word and every
// block leaves, so nothing hangs.
//
// Inside an MB, lanes 0-15 take the 16 luma lines of an edge, lanes 16-23
// the 8 U lines, lanes 24-31 the 8 V lines: in the V phase a lane holds
// its row in registers and runs its edges in order, in the H phase its
// column. The MB with its 4-pixel (luma) or 2-pixel (chroma) left and top
// border is staged in shared memory between the phases. The left border
// is the block's own previous MB, kept in shared memory; the top border
// was written by another block and is read past L1 (ld.global.cg) after
// the acquire. Every MB first writes its whole tile, so the filter works
// out of place without a copy: an MB's own pixels come from the source
// planes, which no MB has touched before it starts (raster order), and its
// neighbours' from the output. The kernel allocates nothing and never
// reads outside the frame: the left and top borders are loaded only where
// they exist.

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

struct Smem {
  int alpha[52], beta[52], tc0[52][3], cqp[52];
  // the MB and its left / top border: luma rows and columns -4..15,
  // chroma -2..7 (U, V); odd row pitches keep a warp's column and row
  // accesses on distinct banks
  int ty[20][21];
  int tc[2][10][11];
};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(max(v, lo), hi);
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

__device__ __forceinline__ EdgeParams edge_params(const Smem& s, int qp_av,
                                                  int a_off, int b_off,
                                                  int bs) {
  const int ia = clip3(0, 51, qp_av + a_off);
  const int ib = clip3(0, 51, qp_av + b_off);
  return {s.alpha[ia], s.beta[ib], s.tc0[ia][clip3(1, 3, bs) - 1]};
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

__global__ void __launch_bounds__(32)
deblock_frame_kernel(DeblockArgs a, int* prog, int grid) {
  __shared__ Smem s;
  const int lane = threadIdx.x;
  const int mbw = a.mbw, mbh = a.mbh, W = 16 * mbw, Wc = 8 * mbw;
  int* err = prog + mbh;
  for (int i = lane; i < 52; i += 32) {
    s.alpha[i] = kAlpha[i];
    s.beta[i] = kBeta[i];
    s.cqp[i] = kChromaQp[i];
    for (int k = 0; k < 3; ++k) s.tc0[i][k] = kTc0[i][k];
  }
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
                      edge_params(s, qav, a.a_off, a.b_off, bs));
        }
#pragma unroll
        for (int j = 0; j < 20; ++j) s.ty[4 + lane][j] = r[j];
      } else {
        const int cq_cur = s.cqp[clip3(0, 51, q_cur + a.cqpo)];
        const int cq_left = s.cqp[clip3(0, 51, q_left + a.cqpo)];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bs =
              (e == 0 && !al) ? 0 : __ldg(bsv + 8 * e + (k >> 1));
          const int qav = e == 0 ? (cq_left + cq_cur + 1) >> 1 : cq_cur;
          filter_chroma(r + 4 * e, bs,
                        edge_params(s, qav, a.a_off, a.b_off, bs));
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
                      edge_params(s, qav, a.a_off, a.b_off, bs));
        }
#pragma unroll
        for (int j = 0; j < 20; ++j) s.ty[j][4 + lane] = r[j];
      } else {
        const int cq_cur = s.cqp[clip3(0, 51, q_cur + a.cqpo)];
        const int cq_top = s.cqp[clip3(0, 51, q_top + a.cqpo)];
#pragma unroll
        for (int j = 0; j < 10; ++j) r[j] = s.tc[c][j][2 + k];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bs =
              (e == 0 && !at) ? 0 : __ldg(bsh + 8 * e + (k >> 1));
          const int qav = e == 0 ? (cq_top + cq_cur + 1) >> 1 : cq_cur;
          filter_chroma(r + 4 * e, bs,
                        edge_params(s, qav, a.a_off, a.b_off, bs));
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

// How many blocks of deblock_frame_kernel the card holds at once (blocks
// per SM times SMs), or minus a CUDA error code.
extern "C" int x264t_deblock_capacity() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, deblock_frame_kernel, 32, 0);
  return e == cudaSuccess ? per_sm * sms : -(int)e;
}

// Launch the deblock of one frame on `stream`: `grid` persistent blocks
// (1 <= grid <= min(mbh, capacity)), all co-resident by a cooperative
// launch. `prog` holds mbh + 1 zeroed int32: each MB row's count of
// finished MBs, then the error word, which the kernel sets when a wait
// runs past its bound. Returns the launch's CUDA error (0 on success).
extern "C" int x264t_deblock_frame(const DeblockArgs* a, int* prog, int grid,
                                   void* stream) {
  if (a->mbw < 1 || a->mbh < 1 || grid < 1 || grid > a->mbh)
    return (int)cudaErrorInvalidValue;
  DeblockArgs args = *a;
  void* params[] = {&args, &prog, &grid};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)deblock_frame_kernel, dim3(grid), dim3(32), params, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// sizeof(DeblockArgs), so the binding can check its struct layout.
extern "C" int x264t_deblock_args_size() { return (int)sizeof(DeblockArgs); }
