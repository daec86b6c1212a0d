// Helpers shared by the consult kernels (consult.cu: the CSR form of K1 and
// K2; dense_join.cu: their dense tensor-core form): the five-lane timestamp
// order, the kind clamp, the witness table's transpose and the SM count.
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

__device__ __forceinline__ int clamp_kind(int k, int n) {
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

}  // namespace
