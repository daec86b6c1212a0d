// The dependency consult on Hopper (sm_90a): kernels K1 and K2.
//
// K1 deps_join replaces the TPU kernel cassandra_accord_tpu/ops/pallas_join.py
// ::_join_kernel (launched by _pallas_join, wrapped by overlap_join_fused),
// and with it the dependency half of the service's fused consult
// device_service/kernel.py::ragged_consult_t (deps) and of
// ops/deps_kernels.py::consult/consult_packed/overlap_join:
//
//   out[b, t] = OR_{c in cols(b)} inc[c, t]
//             & ts_less(txn_id[t], before[b])
//             & WITNESSES[qkind[b], kind[t]]
//             & active[t] & (status[t] != INVALIDATED)
//
// K2 max_conflict replaces the timestamp-proposal half of the same consult
// (ops/deps_kernels.py::max_conflict_keys, the max_lanes output of
// ragged_consult_t): the lexicographic max of
//   per_slot[t] = ts_less(ts[t], txn_id[t]) ? txn_id[t] : ts[t]
// over {t : OR_{c in cols(b)} inc[c, t] & active[t]}, five zero lanes when no
// slot matches (all real lanes are >= 0, so zeros are the identity).
//
// Design.  The TPU kernel densified the query to [B, K] and ran a bf16
// matmul against the whole [T, K] incidence, with the predicate built
// outside the kernel as a [B, T] f32 mask.  Protocol queries touch 1-8 of K
// keys, so here the query stays sparse (CSR: offsets[B+1], cols[N]) and each
// row ORs only the incidence rows of its own keys from the pre-transposed
// [K, T] uint8 index: nnz*T bytes instead of K*T, and no tensor cores.  The
// predicate is evaluated in the epilogue from the lane, kind, status and
// active vectors and a 6x6 witness table passed as a 64-bit mask; nothing of
// size [B, T] is built except the output.  A block owns a tile of 2048 slots
// (8 per thread, one 8-byte load per key row) and ROWS query rows: the slot
// data is loaded into registers once and reused for every row of the block.
//
// Bound on the H100: memory.  K1 moves the incidence rows the batch names
// (each once), the slot lanes and codes, the query, and the output ([B, T]
// bytes, or [B, T/8] bit-packed).  K2 moves the same incidence rows of the
// full index, the ts and txn_id lanes, and [B, 5] int32.  Neither does
// enough arithmetic per byte to approach the card's compute rates.
//
// K2 reduces across T tiles in a second pass: blocks run in no order, and
// five 31-bit lanes do not fit one 64-bit atomic, so each (row, tile) block
// writes its partial max to [B, nTiles, 5] scratch and max_conflict_reduce
// folds the tiles per row.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after its launches (0 = success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 5;
constexpr int kSlots = 8;                    // slots per thread
constexpr int kThreads = 256;                // threads per block
constexpr int kTile = kSlots * kThreads;     // slots per block
constexpr int kRows = 8;                     // query rows per block

__device__ __forceinline__ bool lex_less(const int32_t* a, const int32_t* b) {
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    if (a[l] != b[l]) return a[l] < b[l];
  }
  return false;
}

__device__ __forceinline__ int clamp_kind(int k, int n) {
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

// OR of the incidence bytes of slots [t0, t0 + nvalid) over the row's key
// columns, one byte per slot in a 64-bit word (byte i = slot t0 + i).
__device__ __forceinline__ uint64_t or_rows(const uint8_t* __restrict__ inc,
                                            const int32_t* __restrict__ cols,
                                            int lo, int hi, int T, int K,
                                            int t0, int nvalid, bool vec8) {
  uint64_t acc = 0;
  if (vec8) {
    for (int j = lo; j < hi; ++j) {
      const int c = __ldg(cols + j);
      if (c < 0 || c >= K) continue;
      acc |= __ldg(reinterpret_cast<const unsigned long long*>(
          inc + static_cast<size_t>(c) * T + t0));
    }
  } else {
    for (int j = lo; j < hi; ++j) {
      const int c = __ldg(cols + j);
      if (c < 0 || c >= K) continue;
      const uint8_t* row = inc + static_cast<size_t>(c) * T + t0;
      for (int i = 0; i < nvalid; ++i) {
        acc |= static_cast<uint64_t>(__ldg(row + i)) << (8 * i);
      }
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
deps_join_kernel(const uint8_t* __restrict__ inc,      // [K, T]
                 const int32_t* __restrict__ txn_id,   // [T, 5]
                 const int8_t* __restrict__ kind,      // [T]
                 const int8_t* __restrict__ status,    // [T]
                 const uint8_t* __restrict__ active,   // [T]
                 const int32_t* __restrict__ offsets,  // [B + 1]
                 const int32_t* __restrict__ cols,     // [N]
                 const int32_t* __restrict__ before,   // [B, 5]
                 const int8_t* __restrict__ qkind,     // [B]
                 unsigned long long wit_bits, int n_kinds, int invalidated,
                 int B, int T, int K, int packed,
                 uint8_t* __restrict__ out) {
  const int t0 = (blockIdx.x * kThreads + threadIdx.x) * kSlots;
  if (t0 >= T) return;                       // no block-wide sync below
  const int nvalid = min(kSlots, T - t0);
  const bool vec8 = (T % kSlots) == 0;       // then nvalid == 8, aligned

  int32_t lanes[kSlots][kLanes];
  int kinds[kSlots];
  bool elig[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const bool v = i < nvalid;
    const int t = t0 + i;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      lanes[i][l] = v ? __ldg(txn_id + static_cast<size_t>(t) * kLanes + l) : 0;
    }
    kinds[i] = v ? clamp_kind(__ldg(kind + t), n_kinds) : 0;
    elig[i] = v && __ldg(active + t) != 0 && __ldg(status + t) != invalidated;
  }

  const int b_end = min(B, static_cast<int>(blockIdx.y + 1) * kRows);
  for (int b = blockIdx.y * kRows; b < b_end; ++b) {
    const uint64_t acc = or_rows(inc, cols, __ldg(offsets + b),
                                 __ldg(offsets + b + 1), T, K, t0, nvalid, vec8);
    int32_t bound[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) bound[l] = __ldg(before + b * kLanes + l);
    const int qk = clamp_kind(__ldg(qkind + b), n_kinds);
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const bool share = ((acc >> (8 * i)) & 0xFF) != 0;
      const bool wit = (wit_bits >> (qk * 8 + kinds[i])) & 1ULL;
      if (share && wit && elig[i] && lex_less(lanes[i], bound)) bits |= 1u << i;
    }
    if (packed) {
      out[static_cast<size_t>(b) * (T / kSlots) + t0 / kSlots] =
          static_cast<uint8_t>(bits);
    } else if (vec8) {
      uint64_t word = 0;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        word |= static_cast<uint64_t>((bits >> i) & 1u) << (8 * i);
      }
      *reinterpret_cast<unsigned long long*>(
          out + static_cast<size_t>(b) * T + t0) = word;
    } else {
      for (int i = 0; i < nvalid; ++i) {
        out[static_cast<size_t>(b) * T + t0 + i] = (bits >> i) & 1u;
      }
    }
  }
}

__device__ __forceinline__ void take_max(int32_t* best, const int32_t* cand) {
  if (lex_less(best, cand)) {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) best[l] = cand[l];
  }
}

__global__ void __launch_bounds__(kThreads)
max_conflict_partial_kernel(const uint8_t* __restrict__ inc,     // [K, T]
                            const int32_t* __restrict__ ts,      // [T, 5]
                            const int32_t* __restrict__ txn_id,  // [T, 5]
                            const uint8_t* __restrict__ active,  // [T]
                            const int32_t* __restrict__ offsets, // [B + 1]
                            const int32_t* __restrict__ cols,    // [N]
                            int B, int T, int K,
                            int32_t* __restrict__ partial) {     // [B, nT, 5]
  __shared__ int32_t warp_best[kThreads / 32][kLanes];
  const int t0 = (blockIdx.x * kThreads + threadIdx.x) * kSlots;
  const int nvalid = max(0, min(kSlots, T - t0));   // threads past T still sync
  const bool vec8 = (T % kSlots) == 0 && nvalid == kSlots;
  const int lane_id = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int32_t vals[kSlots][kLanes];
  bool act[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const bool v = i < nvalid;
    const int t = t0 + i;
    int32_t e[kLanes], id[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      e[l] = v ? __ldg(ts + static_cast<size_t>(t) * kLanes + l) : 0;
      id[l] = v ? __ldg(txn_id + static_cast<size_t>(t) * kLanes + l) : 0;
    }
    const bool use_id = lex_less(e, id);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) vals[i][l] = use_id ? id[l] : e[l];
    act[i] = v && __ldg(active + t) != 0;
  }

  const int b_end = min(B, static_cast<int>(blockIdx.y + 1) * kRows);
  for (int b = blockIdx.y * kRows; b < b_end; ++b) {
    const uint64_t acc = nvalid > 0
        ? or_rows(inc, cols, __ldg(offsets + b), __ldg(offsets + b + 1), T, K,
                  t0, nvalid, vec8)
        : 0;
    int32_t best[kLanes] = {0, 0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (act[i] && ((acc >> (8 * i)) & 0xFF) != 0) take_max(best, vals[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      int32_t other[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        other[l] = __shfl_down_sync(0xffffffffu, best[l], off);
      }
      take_max(best, other);
    }
    if (lane_id == 0) {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) warp_best[warp][l] = best[l];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t tile_best[kLanes] = {0, 0, 0, 0, 0};
      for (int w = 0; w < kThreads / 32; ++w) take_max(tile_best, warp_best[w]);
      int32_t* dst = partial +
          (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kLanes;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) dst[l] = tile_best[l];
    }
    __syncthreads();                          // warp_best is reused next row
  }
}

__global__ void max_conflict_reduce_kernel(const int32_t* __restrict__ partial,
                                           int B, int n_tiles,
                                           int32_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t best[kLanes] = {0, 0, 0, 0, 0};
  for (int j = 0; j < n_tiles; ++j) {
    int32_t cand[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      cand[l] = partial[(static_cast<size_t>(b) * n_tiles + j) * kLanes + l];
    }
    take_max(best, cand);
  }
#pragma unroll
  for (int l = 0; l < kLanes; ++l) out[b * kLanes + l] = best[l];
}

}  // namespace

extern "C" {

int consult_tile_slots() { return kTile; }

int deps_join_launch(const void* inc, const void* txn_id, const void* kind,
                     const void* status, const void* active,
                     const void* offsets, const void* cols, const void* before,
                     const void* qkind, unsigned long long wit_bits,
                     int n_kinds, int invalidated, int B, int T, int K,
                     int packed, void* out, void* stream) {
  const dim3 grid((T + kTile - 1) / kTile, (B + kRows - 1) / kRows);
  deps_join_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(inc), static_cast<const int32_t*>(txn_id),
      static_cast<const int8_t*>(kind), static_cast<const int8_t*>(status),
      static_cast<const uint8_t*>(active), static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(cols), static_cast<const int32_t*>(before),
      static_cast<const int8_t*>(qkind), wit_bits, n_kinds, invalidated, B, T,
      K, packed, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// partial: [B, ceil(T / consult_tile_slots()), 5] int32 scratch.
int max_conflict_launch(const void* inc, const void* ts, const void* txn_id,
                        const void* active, const void* offsets,
                        const void* cols, int B, int T, int K, void* partial,
                        void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (T + kTile - 1) / kTile;
  const dim3 grid(n_tiles, (B + kRows - 1) / kRows);
  max_conflict_partial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(inc), static_cast<const int32_t*>(ts),
      static_cast<const int32_t*>(txn_id), static_cast<const uint8_t*>(active),
      static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(cols),
      B, T, K, static_cast<int32_t*>(partial));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  max_conflict_reduce_kernel<<<(B + 127) / 128, 128, 0, s>>>(
      static_cast<const int32_t*>(partial), B, n_tiles,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
