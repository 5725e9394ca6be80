// The CAVLC residual coder for Hopper (sm_90a): each 4x4 (or chroma DC)
// block's coeff_token, trailing-one signs, levels, total_zeros and
// run_before as (code, length) pairs, one thread per block.
//
// Replaces no Pallas kernel. It is the port's form of XLA's fusion of
// x264_tpu/entropy/cavlc_jax.py:82 residual_blocks_dev: XLA compiles that
// function's per-column table lookups into one device program inside the
// writers' jit, where the port's plain version
// (x264_tpu_torch/entropy/cavlc_dev.py residual_blocks_plain) dispatches
// ~2,000 torch ops a call from the host (16 level steps and 15 run_before
// steps, each a dozen ops). The I, P and B writers call it 5 times a
// frame, p_rd_core's CAVLC bit model once per candidate and twice more
// for the intra candidate.
//
// Bit-exact twin of that plain version. A block's 36 slots, in stream
// order: 0 coeff_token; 1-3 the trailing ones' signs; 4-19 the levels
// (slot 4 + j for the j-th nonzero from the last, j >= t1); 20
// total_zeros; 21-35 run_before (slot 21 + j between the j-th and the
// (j + 1)-th nonzero from the last). A slot that the block does not code
// holds (0, 0), past `total` too. Semantics kept from the plain version:
// a table lookup out of range gives (0, 0); levels code in int32 with
// wrapping arithmetic; the first level after fewer than three trailing
// ones codes |level| - 1 (levelCode - 2); an escape clamps its suffix to
// 4095 and sets `over` past it (at suffix length 0 past 30 + 4095); the
// suffix length grows after a level whether or not it escaped. Every
// code is below 2^13 and every length at most 28, so a slot packs into
// one word, code << 8 | length, and the VLC tables (entropy/vlc_tables.py,
// H.264 tables 9-5, 9-7, 9-8 and 9-10) pack the same way.
//
// What bounds it on this card: bytes. In: B x (4L + 4) (the levels and
// nC); out: B x (36 x 12 + 5) (the codes as int64 and the lengths as
// int32, as the plain version returns them, total and over), about 432 B
// a block. A 1080p P frame's five calls code about 350k blocks, ~0.15 GB,
// ~45 us at 3.35 TB/s. The work per block is a few hundred integer
// instructions, far below the byte time.
//
// What the design does about it. A block of 128 threads reads its 128
// rows of levels as one contiguous run (coalesced) into shared memory,
// rows padded to an odd stride; each thread then walks its row twice in
// shared memory (the nonzero count, last position and trailing ones; then
// the codes), writing its 36 packed slots to a shared tile whose row
// stride is odd, so that a warp's stores to one slot fall in 32 banks.
// The block then writes the tile out as two contiguous runs (codes,
// lengths), every store coalesced. The VLC tables live in __constant__
// memory and each block copies them, packed, into shared memory: threads
// of a warp look up different entries, which the constant cache would
// serialise. One launch per call, no host synchronisation, no
// allocation; the entry point returns the launch's CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // blocks of levels per thread block
constexpr int kSlots = 36;           // BLOCK_SLOTS
constexpr int kSlotStride = 37;      // odd: a warp's stores to one slot
                                     // land in 32 banks
constexpr int kMaxCoeffs = 16;

// H.264 tables 9-5, 9-7, 9-8, 9-9 and 9-10, as entropy/vlc_tables.py
// holds them (indexed flat; length 0 marks an illegal combination)
// coeff_token, total_coeff 0 [nC class 0..5]
__constant__ uint8_t kCoeff0TokenCode[6] = {
    1, 3, 15, 3, 1, 1
};
__constant__ uint8_t kCoeff0TokenLen[6] = {
    1, 2, 4, 6, 2, 1
};
// coeff_token [nC class][total_coeff - 1][trailing_ones]
__constant__ uint8_t kCoeffTokenCode[384] = {
    5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11,
    14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10,
    13, 8, 15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8, 11, 2, 0, 0,
    7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4,
    11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12,
    11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4, 15, 14, 0, 0, 11, 15,
    13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9,
    8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13,
    8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2, 0, 1, 0, 0, 4, 5, 6,
    0, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45,
    46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 7,
    1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 15, 1, 0, 0, 14, 13, 1, 0, 7, 12, 11,
    1, 6, 5, 10, 1, 7, 6, 4, 9, 7, 6, 5, 8, 7, 6, 5, 4, 7, 5, 4, 4, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0
};
__constant__ uint8_t kCoeffTokenLen[384] = {
    6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10,
    8, 13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15,
    14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16,
    16, 16, 16, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9,
    8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12,
    12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14,
    14, 14, 14, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7,
    6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9,
    9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 6, 6, 0,
    0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8,
    8, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    7, 2, 0, 0, 7, 7, 3, 0, 9, 7, 7, 5, 9, 9, 7, 6, 10, 10, 9, 7, 11, 11, 10, 7,
    12, 12, 11, 10, 13, 12, 12, 11, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0
};
// total_zeros [total_coeff - 1][total_zeros], 16-coefficient blocks
__constant__ uint8_t kTotalZerosCode[240] = {
    1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1, 7, 6, 5, 4, 3, 5, 4, 3, 2,
    3, 2, 3, 2, 1, 0, 0, 5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0, 0, 0, 3, 7,
    5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0, 0, 0, 0, 5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1,
    0, 0, 0, 0, 0, 1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 5, 4,
    3, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 3, 3, 2, 2, 1, 0, 0, 0, 0, 0,
    0, 0, 0, 1, 0, 1, 3, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 3, 2, 1,
    1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0
};
__constant__ uint8_t kTotalZerosLen[240] = {
    1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9, 3, 3, 3, 3, 3, 4, 4, 4, 4,
    5, 5, 6, 6, 6, 6, 0, 4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6, 0, 0, 5, 3,
    4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5, 0, 0, 0, 4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4,
    5, 0, 0, 0, 0, 6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6, 0, 0, 0, 0, 0, 6, 5, 3, 3,
    3, 2, 3, 4, 3, 6, 0, 0, 0, 0, 0, 0, 6, 4, 5, 3, 2, 2, 3, 3, 6, 0, 0, 0, 0,
    0, 0, 0, 6, 6, 4, 2, 2, 3, 2, 5, 0, 0, 0, 0, 0, 0, 0, 0, 5, 5, 3, 2, 2, 2,
    4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 3, 3, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 4, 4, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 3, 1, 2, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
    1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0
};
// total_zeros, chroma DC 2x2 (4:2:0) [total_coeff - 1][total_zeros]
__constant__ uint8_t kTotalZeros2x2Code[12] = {
    1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0
};
__constant__ uint8_t kTotalZeros2x2Len[12] = {
    1, 2, 3, 3, 1, 2, 2, 0, 1, 1, 0, 0
};
// total_zeros, chroma DC 2x4 (4:2:2) [total_coeff - 1][total_zeros]
__constant__ uint8_t kTotalZeros2x4Code[56] = {
    1, 2, 3, 2, 3, 1, 1, 0, 0, 1, 1, 4, 5, 6, 7, 0, 0, 1, 1, 2, 6, 7, 0, 0, 6,
    0, 1, 2, 7, 0, 0, 0, 0, 1, 2, 3, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 1,
    0, 0, 0, 0, 0, 0
};
__constant__ uint8_t kTotalZeros2x4Len[56] = {
    1, 3, 3, 4, 4, 4, 5, 5, 3, 2, 3, 3, 3, 3, 3, 0, 3, 3, 2, 2, 3, 3, 0, 0, 3,
    2, 2, 2, 3, 0, 0, 0, 2, 2, 2, 2, 0, 0, 0, 0, 2, 2, 1, 0, 0, 0, 0, 0, 1, 1,
    0, 0, 0, 0, 0, 0
};
// run_before [min(zeros_left - 1, 6)][run_before]
__constant__ uint8_t kRunBeforeCode[112] = {
    1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 2,
    1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 2, 3, 2, 1, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 3, 0, 1, 3, 2, 5, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 7, 6, 5, 4,
    3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0
};
__constant__ uint8_t kRunBeforeLen[112] = {
    1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 2, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2,
    2, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 3, 3, 3, 3, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 2, 3, 3, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 3, 3, 3,
    3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 0
};

// The tables one after another in the shared copy: (offset, entries)
constexpr int kCoeff0At = 0, kCoeff0N = 6;
constexpr int kTokenAt = kCoeff0At + kCoeff0N, kTokenN = 384;
constexpr int kZerosAt = kTokenAt + kTokenN, kZerosN = 240;
constexpr int kZeros22At = kZerosAt + kZerosN, kZeros22N = 12;
constexpr int kZeros24At = kZeros22At + kZeros22N, kZeros24N = 56;
constexpr int kRunAt = kZeros24At + kZeros24N, kRunN = 112;
constexpr int kTableN = kRunAt + kRunN;

__device__ __forceinline__ uint32_t packed(uint32_t code, uint32_t len) {
  return code << 8 | len;
}

// Entry i of the tables laid end to end, packed.
__device__ uint32_t table_entry(int i) {
  if (i < kTokenAt) return packed(kCoeff0TokenCode[i], kCoeff0TokenLen[i]);
  if (i < kZerosAt) {
    i -= kTokenAt;
    return packed(kCoeffTokenCode[i], kCoeffTokenLen[i]);
  }
  if (i < kZeros22At) {
    i -= kZerosAt;
    return packed(kTotalZerosCode[i], kTotalZerosLen[i]);
  }
  if (i < kZeros24At) {
    i -= kZeros22At;
    return packed(kTotalZeros2x2Code[i], kTotalZeros2x2Len[i]);
  }
  if (i < kRunAt) {
    i -= kZeros24At;
    return packed(kTotalZeros2x4Code[i], kTotalZeros2x4Len[i]);
  }
  i -= kRunAt;
  return packed(kRunBeforeCode[i], kRunBeforeLen[i]);
}

// Entry idx of the table of n entries at `at`; (0, 0) out of range, as the
// plain version's lut (the JAX one-hot lookup's semantics).
__device__ __forceinline__ uint32_t lut(const uint16_t* tab, int at, int n,
                                        int idx) {
  return idx >= 0 && idx < n ? tab[at + idx] : 0u;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The packed code of a level (not a trailing one) at suffix length sl,
// levelCode - 2 where `minus2`; updates sl and `over` as the plain
// version's level step does. int32 arithmetic wraps, as torch's does.
__device__ __forceinline__ uint32_t level_code(int lv, bool minus2, int& sl,
                                               bool& over) {
  const uint32_t u = (uint32_t)lv;
  int lc = lv > 0 ? (int)(2u * u - 2u) : (int)(0u - 2u * u - 1u);
  if (minus2) lc = (int)((uint32_t)lc - 2u);
  lc = lc < 0 ? 0 : lc;
  uint32_t code;
  int len;
  if (sl == 0) {
    if (lc < 14) {
      code = 1u;
      len = lc + 1;
    } else if (lc < 30) {
      code = 16u | (uint32_t)(lc - 14);
      len = 19;
    } else {
      code = 4096u | (uint32_t)(lc - 30 < 4095 ? lc - 30 : 4095);
      len = 28;
    }
    over |= lc > 30 + 4095;
  } else {
    const int prefix = lc >> sl;
    if (prefix >= 15) {
      const int rest = lc - (15 << sl);
      code = 4096u | (uint32_t)clampi(rest, 0, 4095);
      len = 28;
      over |= rest > 4095;
    } else {
      code = (1u << sl) | (uint32_t)(lc & ((1 << sl) - 1));
      len = prefix + 1 + sl;
    }
  }
  int next = sl < 1 ? 1 : sl;
  const int mag = lv < 0 ? (int)(0u - u) : lv;
  if (mag > (3 << (next - 1)) && next < 6) ++next;
  sl = next;
  return packed(code, (uint32_t)len);
}

__global__ void __launch_bounds__(kThreads)
    cavlc_residual_kernel(const int32_t* __restrict__ coeffs,
                          const int32_t* __restrict__ nc, int nblocks, int L,
                          int chroma_dc, int64_t* __restrict__ codes,
                          int32_t* __restrict__ lens,
                          int32_t* __restrict__ total_out,
                          uint8_t* __restrict__ over_out) {
  __shared__ uint16_t s_tab[kTableN];
  __shared__ int32_t s_in[kThreads * (kMaxCoeffs + 1)];
  __shared__ uint32_t s_slot[kThreads * kSlotStride];
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, nblocks - b0);
  const int stride = L | 1;          // odd: a warp's reads of one column
                                     // land in 32 banks
  for (int i = t; i < kTableN; i += kThreads)
    s_tab[i] = (uint16_t)table_entry(i);
  const int32_t* src = coeffs + (size_t)b0 * L;
  for (int i = t; i < rows * L; i += kThreads) {
    const int r = i / L;
    s_in[r * stride + i - r * L] = src[i];
  }
  __syncthreads();

  if (t < rows) {
    const int32_t* c = s_in + t * stride;
    uint32_t* out = s_slot + t * kSlotStride;
    for (int s = 0; s < kSlots; ++s) out[s] = 0u;
    // the nonzeros from the last: their count, the last one's position,
    // and the leading +-1s among the first three (trailing ones)
    int total = 0, t1 = 0, last = -1;
    bool ones = true;
    for (int k = L - 1; k >= 0; --k) {
      const int v = c[k];
      if (v == 0) continue;
      if (total == 0) last = k;
      if (total < 3 && ones) {
        if (v == 1 || v == -1)
          ++t1;
        else
          ones = false;
      }
      ++total;
    }
    int cls;
    if (chroma_dc) {
      cls = L == 4 ? 4 : 5;
    } else {
      const int v = nc[b0 + t];
      cls = v < 2 ? 0 : (v < 4 ? 1 : (v < 8 ? 2 : 3));
    }
    const int ti = total > 1 ? total - 1 : 0;
    out[0] = total == 0
                 ? lut(s_tab, kCoeff0At, kCoeff0N, cls)
                 : lut(s_tab, kTokenAt, kTokenN, (cls * 16 + ti) * 4 + t1);
    const int tz = total > 0 ? last + 1 - total : 0;
    const bool write_tz = total > 0 && total < L;
    if (write_tz) {
      if (chroma_dc && L == 4)
        out[20] = lut(s_tab, kZeros22At, kZeros22N,
                      min(ti, 2) * 4 + clampi(tz, 0, 3));
      else if (chroma_dc)
        out[20] = lut(s_tab, kZeros24At, kZeros24N,
                      min(ti, 6) * 8 + clampi(tz, 0, 7));
      else
        out[20] = lut(s_tab, kZerosAt, kZerosN,
                      min(ti, 14) * 16 + clampi(tz, 0, 15));
    }
    // the codes, walking the nonzeros from the last again: the j-th a
    // trailing one's sign or a level, then the run between it and the
    // (j - 1)-th while zeros are left
    int sl = total > 10 && t1 < 3 ? 1 : 0;
    bool over = false;
    int zleft = write_tz ? tz : 0;
    int j = 0, prev = -1;
    for (int k = L - 1; k >= 0; --k) {
      const int v = c[k];
      if (v == 0) continue;
      if (j < t1)
        out[1 + j] = packed(v < 0 ? 1u : 0u, 1u);
      else
        out[4 + j] = level_code(v, j == t1 && t1 < 3, sl, over);
      if (j > 0 && zleft > 0) {
        const int run = prev - k - 1;
        out[21 + j - 1] = lut(s_tab, kRunAt, kRunN,
                              clampi(zleft - 1, 0, 6) * 16 +
                                  clampi(run, 0, 15));
        zleft -= run;
      }
      prev = k;
      ++j;
    }
    total_out[b0 + t] = total;
    over_out[b0 + t] = over ? 1 : 0;
  }
  __syncthreads();

  int64_t* code_dst = codes + (size_t)b0 * kSlots;
  int32_t* len_dst = lens + (size_t)b0 * kSlots;
  for (int i = t; i < rows * kSlots; i += kThreads) {
    const int r = i / kSlots;
    const uint32_t w = s_slot[r * kSlotStride + i - r * kSlots];
    code_dst[i] = (int64_t)(w >> 8);
    len_dst[i] = (int32_t)(w & 0xffu);
  }
}

}  // namespace

// CAVLC of `nblocks` blocks on `stream`: coeffs [nblocks][L] int32 in
// zig-zag order (1 <= L <= 16), nc [nblocks] int32 (null with chroma_dc:
// the class follows L); codes [nblocks][36] int64, lens [nblocks][36]
// int32, total [nblocks] int32, over [nblocks] bool (one byte each), as
// residual_blocks_plain returns them.
extern "C" int x264t_cavlc_residual(const int32_t* coeffs, const int32_t* nc,
                                    int nblocks, int L, int chroma_dc,
                                    int64_t* codes, int32_t* lens,
                                    int32_t* total, uint8_t* over,
                                    void* stream) {
  if (nblocks < 1 || L < 1 || L > kMaxCoeffs ||
      (!chroma_dc && nc == nullptr))
    return (int)cudaErrorInvalidValue;
  const int grid = (nblocks + kThreads - 1) / kThreads;
  cavlc_residual_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      coeffs, nc, nblocks, L, chroma_dc, codes, lens, total, over);
  return (int)cudaGetLastError();
}
