// The conflict-graph step's MaxConflicts on Hopper (sm_90a): for each row of
// a [B, T] bool deps mask, the lexicographic max of the [T, 5] int32 lanes of
// the slots the row names, and whether it names any.
//
// It replaces the XLA chain of the reference's
// cassandra_accord_tpu/ops/deps_kernels.py::max_conflict_ts (:117), whose
// _lex_max_masked (:101) runs five lanes of where / max / == / & over
// [B, T], with tie_0 = deps:
//
//   best_l    = max over t of (tie_l[t] ? v_l[t] : -1)
//   tie_l+1   = tie_l & (v_l == best_l)
//   out_l     = max(best_l, 0)
//
// and any = the row's OR.  The port ran that chain in torch ops: a [B, T]
// int32 temporary for each `where`, a reduction and two compares a lane,
// about 30 launches a step.
//
// One pass gives the same answer for every int32 input.  Let S be the row's
// set slots, n = |S|, and M the plain lexicographic max of their lanes.
// Call the -1 that an untied slot puts into best_l a seed.  A seed is there
// at lane l when some slot is untied at l: always when n < T; when n == T,
// only after a lane on which the slots do not all agree.  Where a seed is
// there, best_l = max(M_l, -1).  If M_l >= -1 the tied slots after l are
// those that match M up to l, as in a plain lex max (the seed ties nothing
// real).  If M_l < -1, best_l = -1 and no tied slot has v_l == -1, so the
// tie set empties and every later best is -1.  Where no seed is there, best_l
// = M_l.  So, with s = 0 when n < T, and else 1 + the first lane on which
// the slots do not all agree (5 when they agree on all):
//
//   n == 0:  every lane 0 (every best is -1), any = false;
//   else:    out_l = 0 if M_j < -1 for some j in [s, l], else max(M_l, 0).
//
// While all T slots agree on the lanes before l, they are all tied and M_l
// is the max of lane l over the whole row, so "the slots do not all agree on
// lane l" is min over S of v_l != M_l.  A thread keeps n, M (from INT_MIN
// lanes) and the lane minima over the slots it reads; the block folds them
// (n summed, M as the lex max of the threads with n > 0, the minima) and
// applies the rule.
//
// Bound: the deps bytes, read once (B * T: 16.8 MB at B = 256, T = 65,536,
// 5.0 us at 3.35 TB/s), with ts read once (T * 20 bytes, 1.3 MB) and B * 21
// bytes written.  A block takes one row, so no fold crosses blocks; 512
// threads, two blocks an SM, so the step's 256 rows run in one wave.  A warp
// takes 128-slot tiles of its row, four deps bytes a thread in one 32-bit
// load, eight tiles' loads in flight (streaming: the row is read once).  A
// tile's set slots then read their lanes, which stay in L2 (1.3 MB): with
// few set in the warp's tile (at most kGatherMax), each thread loads its set
// slots' five lanes; with more, the warp copies the tile's 2,560 bytes of
// lanes into shared memory with coalesced 16-byte loads and each thread reads
// its four slots' 80 bytes there (an 80-byte stride: no bank conflict in a
// quarter warp).  So the rows' density sets only the number of gathers: a
// sparse row costs its bytes and a few loads from L2, a dense one a copy of
// the lanes from L2 a row (at most T * 20 bytes).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kLexThreads = 512;
constexpr int kLexWarps = kLexThreads / 32;
constexpr int kTile = 128;                    // slots a warp takes at once
constexpr int kTileInts = kTile * kLanes;     // their lanes: 640 int32
constexpr int kUnroll = 8;                    // tiles' loads in flight
constexpr int kGatherMax = 16;                // set slots a tile gathers
constexpr long long kStride = static_cast<long long>(kLexWarps) * kTile;

// what a thread, a warp and then the block know of a row: the set slots
// counted, their lex max and their lane minima
struct LexAcc {
  int n;
  int32_t top[kLanes];
  int32_t low[kLanes];
};

__device__ __forceinline__ void acc_add(LexAcc& a, const int32_t* v) {
  take_max(a.top, v);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) a.low[l] = min(a.low[l], v[l]);
}

// the warp's fold, on every lane: n summed, the lex max of the lanes with n
// > 0 (lane by lane over the ones still tied), the minima
__device__ __forceinline__ void warp_fold(LexAcc& a) {
  bool tied = a.n > 0;
  a.n = __reduce_add_sync(kFull, a.n);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const int32_t top = __reduce_max_sync(kFull, tied ? a.top[l] : INT_MIN);
    tied = tied & (a.top[l] == top);
    a.top[l] = top;
    a.low[l] = __reduce_min_sync(kFull, a.low[l]);
  }
}

// the four deps bytes of slots s .. s + 3 (0 past T)
__device__ __forceinline__ uint32_t deps_word(const uint8_t* row, long long s,
                                              long long T, bool vec4) {
  if (s >= T) return 0u;
  if (vec4) return __ldcs(reinterpret_cast<const unsigned int*>(row + s));
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (s + j < T) w |= static_cast<uint32_t>(row[s + j]) << (8 * j);
  }
  return w;
}

// a warp's tile of 128 slots from tile0, its deps bytes in w (slots
// tile0 + 4 * lane + j in byte j); stage: the warp's 640 ints of shared
// memory
__device__ __forceinline__ void lex_tile(const int32_t* __restrict__ ts,
                                         long long T, long long tile0,
                                         uint32_t w, bool ts16,
                                         int32_t* stage, int lane,
                                         LexAcc& a) {
  const uint32_t set = __vcmpne4(w, 0u) & 0x01010101u;
  const int mine = __popc(set);
  const int n = __reduce_add_sync(kFull, mine);
  if (n == 0) return;
  a.n += mine;
  const long long s0 = tile0 + 4 * lane;
  if (n <= kGatherMax) {
    for (uint32_t bits = set; bits != 0u; bits &= bits - 1u) {
      const int32_t* p = ts + (s0 + ((__ffs(bits) - 1) >> 3)) * kLanes;
      int32_t v[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) v[l] = __ldg(p + l);
      acc_add(a, v);
    }
    return;
  }
  const long long first = tile0 * kLanes;
  const long long end = T * kLanes;
  if (ts16 && first + kTileInts <= end) {
    const int4* src = reinterpret_cast<const int4*>(ts + first);
    int4* dst = reinterpret_cast<int4*>(stage);
    for (int c = lane; c < kTileInts / 4; c += 32) dst[c] = __ldg(src + c);
  } else {
    for (int i = lane; i < kTileInts; i += 32) {
      stage[i] = first + i < end ? __ldg(ts + first + i) : 0;
    }
  }
  __syncwarp();
  if (set != 0u) {
    const int4* mine4 = reinterpret_cast<const int4*>(stage) + lane * kLanes;
    int32_t v[4 * kLanes];
#pragma unroll
    for (int c = 0; c < kLanes; ++c) {
      const int4 q = mine4[c];
      v[4 * c] = q.x;
      v[4 * c + 1] = q.y;
      v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((set >> (8 * j)) & 1u) acc_add(a, v + j * kLanes);
    }
  }
  __syncwarp();   // the stage serves the warp's next tile
}

// block b: row b of deps [B, T] against ts [T, 5]; out [B, 5], any [B]
__global__ void __launch_bounds__(kLexThreads, 2)
lex_max_deps_kernel(const uint8_t* __restrict__ deps,
                    const int32_t* __restrict__ ts, long long T, bool vec4,
                    bool ts16, int32_t* __restrict__ out,
                    bool* __restrict__ any) {
  __shared__ int4 s_stage[kLexWarps][kTileInts / 4];
  __shared__ LexAcc s_warp[kLexWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t b = blockIdx.x;
  const uint8_t* row = deps + b * static_cast<size_t>(T);
  int32_t* stage = reinterpret_cast<int32_t*>(s_stage[warp]);
  LexAcc a;
  a.n = 0;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    a.top[l] = INT_MIN;
    a.low[l] = INT_MAX;
  }
  for (long long t0 = warp * kTile; t0 < T; t0 += kStride * kUnroll) {
    uint32_t w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = deps_word(row, t0 + u * kStride + 4 * lane, T, vec4);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long tile0 = t0 + u * kStride;   // the same on every lane
      if (tile0 < T) lex_tile(ts, T, tile0, w[u], ts16, stage, lane, a);
    }
  }
  warp_fold(a);
  if (lane == 0) s_warp[warp] = a;
  __syncthreads();
  if (warp != 0) return;
  if (lane < kLexWarps) {
    a = s_warp[lane];
  } else {
    a.n = 0;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      a.top[l] = INT_MIN;
      a.low[l] = INT_MAX;
    }
  }
  warp_fold(a);
  if (lane != 0) return;
  int32_t* o = out + b * kLanes;
  if (a.n == 0) {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) o[l] = 0;
    any[b] = false;
    return;
  }
  int s = 0;   // the first lane with a seed (see the header)
  if (a.n == T) {
    s = kLanes;
    for (int l = 0; l < kLanes; ++l) {
      if (a.low[l] != a.top[l]) {
        s = l + 1;
        break;
      }
    }
  }
  bool gone = false;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    gone = gone | (l >= s && a.top[l] < -1);
    o[l] = gone ? 0 : max(a.top[l], 0);
  }
  any[b] = true;
}

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

}  // namespace

extern "C" {

// deps [B, T] bool, ts [T, 5] int32 -> out [B, 5] int32 (the lex max of
// each row's set slots, by the reference's rule), any [B] bool
int lex_max_deps_launch(const void* deps, const void* ts, int B, long long T,
                        void* out, void* any, void* stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  const bool vec4 = T % 4 == 0 && aligned(deps, 4);
  lex_max_deps_kernel<<<static_cast<unsigned>(B), kLexThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(deps), static_cast<const int32_t*>(ts), T,
      vec4, aligned(ts, 16), static_cast<int32_t*>(out),
      static_cast<bool*>(any));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
