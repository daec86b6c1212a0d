// Helpers shared by the consult kernels (consult.cu: the CSR form of K1 and
// K2; dense_join.cu and dense_join_tk.cu: their dense tensor-core forms on
// the [K, T] and the [T, K] index): the five-lane timestamp order, the kind
// clamp, the witness table's transpose, the SM count, the nibble-to-bytes
// spread, the [K, T] kernel's key order and stage addresses, and the dense
// forms' cross-block fold of K2's partial maxima.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 5;
constexpr unsigned kFull = 0xffffffffu;

// a < b, lexicographically over the lanes (no branches)
__device__ __forceinline__ bool lex_less(const int32_t* a, const int32_t* b) {
  bool lt = false, eq = true;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    lt = lt | (eq & (a[l] < b[l]));
    eq = eq & (a[l] == b[l]);
  }
  return lt;
}

// best = max(best, cand) lexicographically, where `take` allows it
__device__ __forceinline__ void take_max(int32_t* best, const int32_t* cand,
                                         bool take = true) {
  const bool up = take & lex_less(best, cand);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) best[l] = up ? cand[l] : best[l];
}

// The lexicographic max over the warp of one candidate per lane (lanes
// >= 0; -1 lanes for none), lane by lane: the warp's max of the lane over
// the candidates still tied, then only those that reach it stay.  Zero
// lanes when no lane has a candidate.  Every lane gets the result.
__device__ __forceinline__ void warp_lex_max(const int32_t* mine,
                                             int32_t* best) {
  bool tied = true;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const int32_t top = __reduce_max_sync(kFull, tied ? mine[l] : -1);
    tied = tied & (mine[l] == top);
    best[l] = max(top, 0);
  }
}

// A kind code as an index of the n-kind witness table, read as the
// reference's gather reads it: a negative code wraps once (k + n), then
// the index clamps into [0, n - 1] (n = 6: -1 -> 5, -6 -> 0, -7 -> 0,
// 100 -> 5).
__device__ __forceinline__ int clamp_kind(int k, int n) {
  k = k < 0 ? k + n : k;
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

// the 8x8 bit matrix transposed: bit 8a + b -> bit 8b + a
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL;
  x ^= t ^ (t << 28);
  return x;
}

// The SM count of the current device, read once per device; a failed
// query is returned, not guessed.
constexpr int kMaxDevices = 64;

cudaError_t sm_count(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (*sms <= 0) return cudaErrorInvalidDevice;
  if (dev < kMaxDevices) cached[dev] = *sms;
  return cudaSuccess;
}

// bits 0-3 of x -> bytes 0-3 (0 or 1 each)
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// The [K, T] dense kernel's stage (dense_join.cu): [128 keys][128 slots]
// bytes, key row r at r * 128, written by TMA with the 128-byte swizzle
// (16-byte chunk x of row r lands at chunk x ^ (r % 8)).  Its fragment
// loads read four slots of one key row as a 32-bit word, for the key that
// the wgmma fragment puts at position p = 32 ks + 16 h + 4 c + j of a
// 128-key stage (k32 step ks, half h, lane % 4 = c, byte j).  Read in key
// order, the rows 4c + j of one load differ only in bit 2 of r % 8, and
// its 32 lanes meet on 16 banks; the query's keys are therefore placed in
// the order kt_key_row gives, which puts c in bits 1-2 of the row, so the
// four c of a load see four swizzle chunks and every lane its own bank.
// kt_key_row: position p -> key row; kt_key_pos: its inverse (both keep
// p's bits 4 and up, within a 128-key stage and across stages).
__host__ __device__ constexpr int kt_key_row(int p) {
  return (p & ~15) | (p & 1) | ((p >> 1) & 6) | ((p & 2) << 2);
}

__host__ __device__ constexpr int kt_key_pos(int r) {
  return (r & ~15) | (r & 1) | ((r & 8) >> 2) | ((r & 6) << 1);
}

// the byte offset in a stage of key row r (0 .. 127), slot s (0 .. 127)
__host__ __device__ constexpr int kt_stage_offset(int r, int s) {
  return r * 128 + ((((s >> 4) ^ (r & 7)) << 4) | (s & 15));
}

constexpr int kFoldThreads = 128;                // the fold kernel's blocks

// out[b] = the lex max of row b's partials [b, 0 .. ny-1, 5] (lanes >= 0):
// a block per row, a few partials per thread, then the warps' maxima
__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const int32_t* __restrict__ partial, int ny,
            int32_t* __restrict__ out) {
  __shared__ int32_t s_warp[kFoldThreads / 32][kLanes];
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t mine[kLanes] = {-1, -1, -1, -1, -1};
  for (int y = threadIdx.x; y < ny; y += kFoldThreads) {
    int32_t cand[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      cand[l] = __ldg(partial + (b * ny + y) * kLanes + l);
    }
    take_max(mine, cand);
  }
  int32_t best[kLanes];
  warp_lex_max(mine, best);
  if (lane == 0) {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) s_warp[warp][l] = best[l];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t r[kLanes] = {0, 0, 0, 0, 0};
#pragma unroll
    for (int w = 0; w < kFoldThreads / 32; ++w) take_max(r, s_warp[w]);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) out[b * kLanes + l] = r[l];
  }
}

}  // namespace
