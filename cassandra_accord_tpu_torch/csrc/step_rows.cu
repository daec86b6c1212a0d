// The conflict-graph step's row writes and execution frontier on Hopper
// (sm_90a): the two kernels that let models/conflict_graph.py::txn_step run
// on the card with no host sync, so the host queues a whole step while the
// device runs it.
//
// write_rows replaces no TPU kernel: the reference's step writes the batch's
// rows with XLA scatters (`.at[slots].set`), whose CPU answer keeps the last
// row in batch order for a slot named twice.  torch's scatter leaves that
// winner undefined on CUDA, so the port first picked the winning rows with a
// `torch.nonzero` (a host sync, twice a step) and wrote the status codes as
// Python scalars (a blocking upload each, three a step).  Here the block of
// batch row b decides by itself whether b writes:
//
//   target(b) = valid[b] ? wrap(slots[b]) : T - 1   (wrap: [-T, -1] -> +T)
//   writes(b) = valid[b] & 0 <= target(b) < T
//             & no b' > b with target(b') == target(b)
//
// so a padding row writes nothing but still takes slot T - 1 from a valid
// row before it, and a slot outside [-T, T) is dropped, as the reference's
// scatter reads them (graph_state.py's module doc).  A writing row copies
// the fields the caller gives (the witness: its key incidence row, ts and
// txn_id lanes, kind, its adjacency row from the deps mask; the
// stabilisation: its executeAt lanes) and stores the status code and the
// active flag passed as launch arguments.  Winners name distinct slots, so
// no two blocks write one byte.
//
// Bound: the adjacency rows, B * T bytes read and written (16 MiB each at B
// = 256, T = 65,536: about 10 us at 3.35 TB/s); the other fields are a few
// hundred bytes a row.  A row's adjacency copy is split over blocks of
// kRowChunk bytes, 16 bytes a thread per load when T % 16 == 0 and both
// bases are 16-byte aligned (else a byte at a time); every block repeats the
// B - b compares of its row's targets, which the L1 serves.
//
// frontier replaces the dense frontier's product (ops/deps_kernels.py::
// kahn_frontier; the reference's jitted kahn_frontier, XLA, not Pallas):
//
//   ready[i] = ready[i] & !(sum_j adj[i, j] * blocked[j] > 0)
//
// in place, over a [R, N] adjacency of int8 bytes, the reference's test
// (its bf16 product summed in f32, exact here in int32; for 0/1 rows: no
// edge onto a blocked slot).  Only the rows that enter ready (about 430 of
// 65,536 at the step's backlog) read their adjacency row; every other row
// costs one byte's read.  Before, the port
// listed those rows with a `torch.nonzero` (a host sync), copied them out
// with `index_select` and multiplied; the reference multiplies every row.
// Bound: the candidates' rows, 430 * 64 KiB = 28 MB a step (about 8.4 us);
// the [N] blocked vector stays in L2.  Blocks take the rows with a grid
// stride, eight blocks an SM, so the candidates of one batch (neighbouring
// slots) fall to different SMs; a block reads the flags of its share of
// rows together (one latency, not one a row), then reads each ready row 16
// bytes a thread per load, four loads in flight, sums the bytes over the
// blocked columns with __dp4a (blocked as 0/1 bytes), and folds the warps'
// sums.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr long long kRowChunk = 16384;   // adjacency bytes a block copies
constexpr int kFrontierThreads = 256;
constexpr int kFrontierBlocksPerSm = 8;

// row b's slot as the scatter reads it (see the header)
__device__ __forceinline__ long long target(const long long* slots,
                                            const bool* valid, int b,
                                            long long t) {
  if (!valid[b]) return t - 1;
  const long long s = slots[b];
  return s < 0 ? s + t : s;
}

// grid (B, adjacency chunks); every pointer but slots, valid and the chosen
// fields' may be null, and a null source skips its field
__global__ void __launch_bounds__(kRowThreads)
write_rows_kernel(const long long* __restrict__ slots,
                  const bool* __restrict__ valid, int B, long long T, int K,
                  const int8_t* __restrict__ key_src,
                  int8_t* __restrict__ key_dst,
                  const int32_t* __restrict__ ts_src,
                  int32_t* __restrict__ ts_dst,
                  const int32_t* __restrict__ id_src,
                  int32_t* __restrict__ id_dst,
                  const int8_t* __restrict__ kind_src,
                  int8_t* __restrict__ kind_dst,
                  int8_t* __restrict__ status_dst, int status,
                  const int8_t* __restrict__ adj_src,
                  int8_t* __restrict__ adj_dst,
                  bool* __restrict__ active_dst, bool vec16) {
  const int b = blockIdx.x;
  const long long s = target(slots, valid, b, T);
  bool later = false;
  for (int j = b + 1 + threadIdx.x; j < B; j += kRowThreads) {
    later |= target(slots, valid, j, T) == s;
  }
  // uniform across the block: the row writes in every block or in none
  if (__syncthreads_or(later) || !valid[b] || s < 0 || s >= T) return;
  const size_t row = static_cast<size_t>(s);
  if (adj_src != nullptr) {
    const size_t lo = static_cast<size_t>(blockIdx.y) * kRowChunk;
    const size_t end = lo + kRowChunk;
    const size_t hi = end < static_cast<size_t>(T) ? end : T;
    const int8_t* src = adj_src + static_cast<size_t>(b) * T;
    int8_t* dst = adj_dst + row * T;
    if (vec16) {
      for (size_t i = lo + 16 * threadIdx.x; i < hi; i += 16 * kRowThreads) {
        *reinterpret_cast<uint4*>(dst + i) =
            __ldg(reinterpret_cast<const uint4*>(src + i));
      }
    } else {
      for (size_t i = lo + threadIdx.x; i < hi; i += kRowThreads) {
        dst[i] = src[i];
      }
    }
  }
  if (blockIdx.y != 0) return;
  if (key_src != nullptr) {
    for (int c = threadIdx.x; c < K; c += kRowThreads) {
      key_dst[row * K + c] = key_src[static_cast<size_t>(b) * K + c];
    }
  }
  if (threadIdx.x < kLanes) {
    const int l = threadIdx.x;
    if (ts_src != nullptr) ts_dst[row * kLanes + l] = ts_src[b * kLanes + l];
    if (id_src != nullptr) id_dst[row * kLanes + l] = id_src[b * kLanes + l];
  }
  if (threadIdx.x == 0) {
    if (kind_src != nullptr) kind_dst[row] = kind_src[b];
    if (status_dst != nullptr) status_dst[row] = static_cast<int8_t>(status);
    if (active_dst != nullptr) active_dst[row] = true;
  }
}

// row i's sum over the blocked columns, on every thread of the block
__device__ __forceinline__ int blocked_sum(const int8_t* __restrict__ row,
                                          const bool* __restrict__ blocked,
                                          long long N, bool vec16,
                                          int* s_warp) {
  int sum = 0;
  if (vec16) {
    const int4* a4 = reinterpret_cast<const int4*>(row);
    const int4* m4 = reinterpret_cast<const int4*>(blocked);
    const long long words = N / 16;
#pragma unroll 4
    for (long long w = threadIdx.x; w < words; w += kFrontierThreads) {
      const int4 a = __ldg(a4 + w), m = __ldg(m4 + w);
      sum = __dp4a(a.x, m.x, sum);
      sum = __dp4a(a.y, m.y, sum);
      sum = __dp4a(a.z, m.z, sum);
      sum = __dp4a(a.w, m.w, sum);
    }
  } else {
    for (long long j = threadIdx.x; j < N; j += kFrontierThreads) {
      sum += blocked[j] ? row[j] : 0;
    }
  }
  sum = __reduce_add_sync(kFull, sum);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = sum;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kFrontierThreads / 32; ++w) total += s_warp[w];
  __syncthreads();   // s_warp serves the next row
  return total;
}

// Block x owns rows x, x + G, x + 2G, ... (G blocks).  It reads the flags
// of its next kFrontierThreads rows at once, one a thread, lists the ready
// ones in shared memory and then tests them one after another, the whole
// block on each row.
__global__ void __launch_bounds__(kFrontierThreads)
frontier_kernel(const int8_t* __restrict__ adj,
                const bool* __restrict__ blocked, bool* __restrict__ ready,
                long long R, long long N, bool vec16) {
  __shared__ int s_warp[kFrontierThreads / 32];
  __shared__ long long s_rows[kFrontierThreads];
  __shared__ int s_count;
  const long long G = gridDim.x;
  for (long long base = blockIdx.x; base < R; base += G * kFrontierThreads) {
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    const long long mine = base + G * threadIdx.x;
    if (mine < R && ready[mine]) s_rows[atomicAdd(&s_count, 1)] = mine;
    __syncthreads();
    const int n = s_count;
    for (int c = 0; c < n; ++c) {
      const long long i = s_rows[c];
      const int total = blocked_sum(adj + static_cast<size_t>(i) * N,
                                    blocked, N, vec16, s_warp);
      if (threadIdx.x == 0 && total > 0) ready[i] = false;
    }
    __syncthreads();   // every thread has read s_count before it is reset
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Write the winning rows of a batch of B (see the header) into a state of
// T slots and K keys; a null source leaves its field as it is, a null
// status_dst or active_dst leaves the status or the active flag
int write_rows_launch(const void* slots, const void* valid, int B,
                      long long T, int K, const void* key_src, void* key_dst,
                      const void* ts_src, void* ts_dst, const void* id_src,
                      void* id_dst, const void* kind_src, void* kind_dst,
                      void* status_dst, int status, const void* adj_src,
                      void* adj_dst, void* active_dst, void* stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  const bool vec16 = adj_src != nullptr && T % 16 == 0 &&
                     aligned16(adj_src) && aligned16(adj_dst);
  const dim3 grid(B, adj_src != nullptr
                         ? static_cast<unsigned>((T + kRowChunk - 1) / kRowChunk)
                         : 1u);
  write_rows_kernel<<<grid, kRowThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(slots), static_cast<const bool*>(valid), B,
      T, K, static_cast<const int8_t*>(key_src), static_cast<int8_t*>(key_dst),
      static_cast<const int32_t*>(ts_src), static_cast<int32_t*>(ts_dst),
      static_cast<const int32_t*>(id_src), static_cast<int32_t*>(id_dst),
      static_cast<const int8_t*>(kind_src), static_cast<int8_t*>(kind_dst),
      static_cast<int8_t*>(status_dst), status,
      static_cast<const int8_t*>(adj_src), static_cast<int8_t*>(adj_dst),
      static_cast<bool*>(active_dst), vec16);
  return static_cast<int>(cudaGetLastError());
}

// ready [R] bool, in place: a row stays ready only if its adjacency row
// (int8, N bytes) sums to at most 0 over the blocked [N] bool columns
int frontier_launch(const void* adj, const void* blocked, void* ready,
                    long long R, long long N, void* stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec16 = N % 16 == 0 && aligned16(adj) && aligned16(blocked);
  const long long blocks =
      R < static_cast<long long>(kFrontierBlocksPerSm) * sms
          ? R
          : static_cast<long long>(kFrontierBlocksPerSm) * sms;
  frontier_kernel<<<static_cast<unsigned>(blocks), kFrontierThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(adj), static_cast<const bool*>(blocked),
      static_cast<bool*>(ready), R, N, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
