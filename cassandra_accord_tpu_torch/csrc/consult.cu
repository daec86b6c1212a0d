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
// Layout.  The TPU kernel densified the query to [B, K] and ran a bf16
// matmul against the whole [T, K] incidence, with the predicate built
// outside the kernel as a [B, T] f32 mask.  Protocol queries touch 1-8 of K
// keys, so here the query stays sparse (CSR: offsets[B+1], cols[N]) and each
// row ORs only the incidence rows of its own keys from the pre-transposed
// [K, T] uint8 index: nnz*T bytes instead of K*T, and no tensor cores.  The
// predicate is evaluated in the epilogue from the lane, kind, status and
// active vectors and a 6x6 witness table passed as a 64-bit mask; nothing of
// size [B, T] is built except the output.  A column in [-K, -1] names
// column c + K and any other column outside [0, K) is dropped, as the
// reference's densify (.at[row_ids, flat_cols].add) reads them.
//
// Geometry.  A thread owns 8 consecutive slots for the incidence (one
// 8-byte word per key row) and, for the slot data (lanes, codes), the 8
// slots lane + 32i of its warp's 256, so a warp's load of one lane spans 640
// bytes, not 5 KB; the overlap masks move between the two orders by 8
// shuffles.  A block covers a tile of kTile = 2048 slots with 256 threads,
// or, when T <= kTile, all of T with only the warps that own slots
// (ceil(T/8) threads rounded up to 32).  Query rows go in groups of R:
// R = 8 when that gives the card at least one block per SM, else R = 1 (a
// burn's window of 8 rows becomes 8 blocks that run side by side, not one
// block that walks 8 rows).  Each block loads its slot data once and walks
// its share of the row groups, so that the grid holds about two blocks per
// SM (one wave at 128 registers per thread).
//
// The row walk.  A row group's CSR slice is staged in shared memory with
// one cooperative load (offsets[b0 .. b0+R], every column of its rows,
// out-of-range columns marked dropped) and one barrier; the bounds K1's
// epilogue needs (before, qkind) ride along.  The incidence loads then
// start from shared memory: the first kLead = 2 keys of all the group's
// rows are issued together (16 independent 8-byte loads per thread at
// R = 8) before the first OR, and the rest of a wide row goes in bursts of
// kBurst = 8.  A call therefore waits on about three dependent misses
// (offsets, cols, incidence), not three per row as a serial row walk does.
// Rows whose columns overflow the stage (kStage = 4096 int32, 16 KB) stream
// through it in chunks, one barrier each.  The per-row epilogues are loops,
// not unrolled code: at the main path's shapes one warp runs the whole
// call, and the length of its instruction stream is its time.  A warp with
// no candidate slot for a row skips that row's compares.
//
// K1's epilogue evaluates the predicate per (row, slot) with a branchless
// lexicographic compare and the witness column of the slot's kind (the
// 6x6 table transposed once into one byte per kind), and moves the
// dependency bits back to the output order through the warp's ballots.
//
// Signed queries.  A caller that holds the index as [T, K] int8 and the
// query as [B, K] int8 (ops/deps_kernels.py's route for shapes the [T, K]
// kernels refuse) passes the query's values beside its columns and the
// index's own signed bytes; the overlap is then the reference's, a sum
// sum_c val[c] * inc[c, t] > 0 (bf16 operands summed in f32 there, exact
// int32 here), not an OR.  Those launches take one row per group (R = 1),
// and each thread keeps eight int32 sums for its slots across the staged
// chunks; without values (the service's 0/1 index and columns) nothing of
// the OR walk changes.
//
// K2's reduction.  With R = 8 each thread ranks its 8 slots once per block
// (which slot beats which), so a row's max over its candidate slots is a
// mask test per slot; the warp's max is then taken lane by lane with
// __reduce_max_sync.  Each warp writes [warps, R, 5] to shared memory; one
// barrier; one thread per row folds the warps.  When T fits one tile the
// block writes out[b] itself, zero lanes included: one launch, no fill, no
// scratch.  Across tiles each block writes its partials, fences once, and
// counts itself on a per-row-group counter; the last block of a group
// folds the group's partials into out.  The launcher zeroes the counters
// (one memset node) on the caller's stream, so every launch, graph replay
// or stream is independent of the others.
//
// Bounds on the H100.  At the main path's shapes (a burn's windows: B <= 8,
// T <= 256, 1-2 keys per row) a call is a few kilobytes: it is bound by the
// launch and the chain of dependent loads above, not by bytes or
// operations.  At T = 65,536 with 2-key rows the bound is bytes (the
// incidence rows the batch names, the slot data, the query and the output)
// but the time goes to issuing the per-(row, slot) epilogue.  Wide rows
// (1,024 keys per row) are bound by re-reading nnz*T incidence bytes
// through L2/HBM; dense_join.cu holds the dense int8 tensor-core form that
// reads each index byte once, and ops/_kernels.py::join_form picks it for
// such rows.  __launch_bounds__(256, 2) caps the registers at 128 per
// thread; ptxas (-Xptxas -v) reports 80 to 128 for the twelve
// instantiations (four of them signed) and no spills.
//
// Every entry point launches on the caller's stream and allocates nothing.
// It returns the CUDA error of its SM-count query or memset if one fails,
// else cudaGetLastError() after its launches (0 = success).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kSlots = 8;                        // slots per thread
constexpr int kMaxThreads = 256;                 // threads per block, at most
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kTile = kSlots * kMaxThreads;      // slots per block when T > kTile
constexpr int kRows = 8;                         // query rows per group (R)
constexpr int kRowsSmall = 1;                    // R when the grid is small
constexpr int kBlocksPerSM = 2;                  // grid target (128 registers)
constexpr int kStage = 4096;                     // CSR columns staged per chunk
constexpr int kLead = 2;                         // keys per row loaded together
constexpr int kBurst = 8;                        // loads per burst of a wide row
constexpr uint64_t kByteLows = 0x0101010101010101ULL;

template <int R, bool kSigned>
struct CsrStage {
  int32_t off[R + 1];                            // offsets[b0 .. b0 + nrows]
  int32_t cols[kStage];                          // columns [c0, c1), -1 = dropped
  int8_t vals[kSigned ? kStage : 1];             // their values (kSigned)
};

// bit i = bit 8i of x
__device__ __forceinline__ uint32_t gather_bytes(uint64_t x) {
  return static_cast<uint32_t>(((x & kByteLows) * 0x0102040810204080ULL) >> 56);
}

// bit c = byte c of x is nonzero
__device__ __forceinline__ uint32_t byte_mask(uint64_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return gather_bytes(x);
}

// The incidence bytes of this thread's slots [t0, t0 + nvalid) in key row c,
// one byte per slot in a 64-bit word (byte i = slot t0 + i); 0 for a dropped
// column or a thread past T.
template <bool kVec8>
__device__ __forceinline__ uint64_t inc_word(const uint8_t* __restrict__ inc,
                                             int c, int T, int t0, int nvalid) {
  if (c < 0 || nvalid <= 0) return 0;
  const uint8_t* row = inc + static_cast<size_t>(c) * T + t0;
  if (kVec8) return __ldg(reinterpret_cast<const unsigned long long*>(row));
  uint64_t w = 0;
  for (int i = 0; i < nvalid; ++i) {
    w |= static_cast<uint64_t>(__ldg(row + i)) << (8 * i);
  }
  return w;
}

// The key overlap of rows b0 .. b0 + nrows - 1 with the warp's slots, in the
// warp-strided order of the slot data: bit 8r + i = row b0 + r shares a key
// with slot wbase + lane + 32i (kSigned: the row's signed sum there is > 0).  Every thread of the block calls it: it
// holds at least one barrier, after which whatever the caller wrote to
// shared memory before the call is visible block-wide.
//
// Each thread ORs the incidence words of its 8 consecutive slots
// t0 = wbase + 8 lane .. + 7 (one 8-byte load per key row), starting from
// the rows' CSR slice staged in shared memory: the first kLead keys of
// every row are loaded together, the rest of a wide row in bursts.  The
// per-row byte masks then move to the strided order by shuffles (slot
// wbase + lane + 32i sits in byte lane % 8 of lane 4i + lane / 8).
template <bool kVec8, int R, bool kSigned>
__device__ __forceinline__ uint64_t rows_share(
    const uint8_t* __restrict__ inc, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ cols, const int8_t* __restrict__ vals, int b0,
    int nrows, int T, int K, int t0, int nvalid, CsrStage<R, kSigned>& st) {
  static_assert(!kSigned || R == 1, "signed queries take one row a group");
  uint64_t acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;
  int32_t sum[kSigned ? kSlots : 1] = {};        // kSigned: slot t0 + i's sum
  const int lo = __ldg(offsets + b0);
  const int hi = __ldg(offsets + b0 + nrows);
  const int tid = threadIdx.x;
  if (tid <= nrows) st.off[tid] = __ldg(offsets + b0 + tid);
  for (int c0 = lo;; c0 += kStage) {
    const int c1 = min(hi, c0 + kStage);
    if (c0 != lo) __syncthreads();             // the previous chunk is consumed
    for (int j = c0 + tid; j < c1; j += blockDim.x) {
      const int c = __ldg(cols + j);
      const int w = c < 0 ? c + K : c;           // wrapped once, as in JAX
      st.cols[j - c0] = (w >= 0 && w < K) ? w : -1;
      if constexpr (kSigned) st.vals[j - c0] = __ldg(vals + j);
    }
    __syncthreads();
    if constexpr (kSigned) {
      // the row's signed sum at each of this thread's slots
      const int rlo = nrows > 0 ? max(st.off[0], c0) : 0;
      const int rhi = nrows > 0 ? min(st.off[1], c1) : 0;
#pragma unroll 1
      for (int j = rlo; j < rhi; ++j) {
        const uint64_t w = inc_word<kVec8>(inc, st.cols[j - c0], T, t0, nvalid);
        const int v = st.vals[j - c0];
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          sum[i] += v * static_cast<int>(static_cast<int8_t>(w >> (8 * i)));
        }
      }
      if (c1 >= hi) break;
      continue;
    }
    // rows in flight: the first kLead keys of every row, all loads issued
    // before the first OR
    uint64_t w[R][kLead];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rlo = r < nrows ? max(st.off[r], c0) : 0;
      const int rhi = r < nrows ? min(st.off[r + 1], c1) : 0;
#pragma unroll
      for (int p = 0; p < kLead; ++p) {
        const int j = rlo + p;
        w[r][p] = inc_word<kVec8>(inc, j < rhi ? st.cols[j - c0] : -1, T, t0,
                                  nvalid);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int p = 0; p < kLead; ++p) acc[r] |= w[r][p];
    }
    // the rest of a wide row, kBurst loads at a time
#pragma unroll 1
    for (int r = 0; r < nrows; ++r) {
      const int rlo = max(st.off[r], c0) + kLead;
      const int rhi = min(st.off[r + 1], c1);
      uint64_t tail = 0;
      for (int j = rlo; j < rhi; j += kBurst) {
        uint64_t v[kBurst];
#pragma unroll
        for (int u = 0; u < kBurst; ++u) {
          v[u] = inc_word<kVec8>(inc, j + u < rhi ? st.cols[j + u - c0] : -1,
                                 T, t0, nvalid);
        }
#pragma unroll
        for (int u = 0; u < kBurst; ++u) tail |= v[u];
      }
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] |= q == r ? tail : 0;
    }
    if (c1 >= hi) break;
  }
  if constexpr (kSigned) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      acc[0] |= static_cast<uint64_t>(sum[i] > 0) << (8 * i);
    }
  }
  uint64_t m = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m |= static_cast<uint64_t>(byte_mask(acc[r])) << (8 * r);
  }
  const int lane = tid & 31;
  uint64_t share = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const uint64_t v = __shfl_sync(kFull, m, 4 * i + (lane >> 3)) >> (lane & 7);
    share |= (v & kByteLows) << i;
  }
  return share;
}

// Grid: x = tiles of T, y = blocks per tile; block y walks row groups y,
// y + gridDim.y, ... of R rows each, with the slot data loaded once.
template <bool kVec8, int R, bool kSigned>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)
deps_join_kernel(const uint8_t* __restrict__ inc,      // [K, T]
                 const int32_t* __restrict__ txn_id,   // [T, 5]
                 const int8_t* __restrict__ kind,      // [T]
                 const int8_t* __restrict__ status,    // [T]
                 const uint8_t* __restrict__ active,   // [T]
                 const int32_t* __restrict__ offsets,  // [B + 1]
                 const int32_t* __restrict__ cols,     // [N]
                 const int8_t* __restrict__ qvals,     // [N]   (kSigned)
                 const int32_t* __restrict__ before,   // [B, 5]
                 const int8_t* __restrict__ qkind,     // [B]
                 unsigned long long wit_bits, int n_kinds, int invalidated,
                 int B, int T, int K, int packed,
                 uint8_t* __restrict__ out) {
  __shared__ CsrStage<R, kSigned> st;
  __shared__ int32_t s_before[R][kLanes];
  __shared__ int32_t s_qkind[R];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t0 = (blockIdx.x * blockDim.x + tid) * kSlots;
  const int wbase = t0 - lane * kSlots;        // the warp's first slot
  const int nvalid = min(kSlots, T - t0);      // <= 0: past T, barriers only

  // slot data, warp-strided (slot i = wbase + lane + 32i, so a warp's load
  // of one lane spans 640 bytes): its lanes, and in byte i of `witnessed`
  // the query kinds (bit qk) whose rows may depend on it, 0 when the slot
  // is not eligible
  const uint64_t wit_by_kind = transpose8(wit_bits);   // byte k: column k
  int32_t lanes[kSlots][kLanes];
  uint64_t witnessed = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int t = wbase + lane + 32 * i;
    const bool v = t < T;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      lanes[i][l] = v ? __ldg(txn_id + static_cast<size_t>(t) * kLanes + l) : 0;
    }
    const bool live = v && __ldg(active + t) != 0;
    const int code = v ? __ldg(status + t) : invalidated;
    const int k = v ? clamp_kind(__ldg(kind + t), n_kinds) : 0;
    if (live && code != invalidated) {
      witnessed |= ((wit_by_kind >> (8 * k)) & 0xFFULL) << (8 * i);
    }
  }

  const int n_groups = (B + R - 1) / R;
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int b0 = g * R;
    const int nrows = min(R, B - b0);
    if (g != static_cast<int>(blockIdx.y)) __syncthreads();  // smem reuse
    for (int i = tid; i < nrows * kLanes; i += blockDim.x) {
      s_before[i / kLanes][i % kLanes] = __ldg(before + b0 * kLanes + i);
    }
    if (tid < nrows) s_qkind[tid] = clamp_kind(__ldg(qkind + b0 + tid), n_kinds);
    const uint64_t share = rows_share<kVec8, R, kSigned>(
        inc, offsets, cols, qvals, b0, nrows, T, K, t0, nvalid, st);
    if (wbase >= T) continue;                  // the whole warp is past T
#pragma unroll 1
    for (int r = 0; r < nrows; ++r) {
      const int b = b0 + r;
      int32_t bound[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) bound[l] = s_before[r][l];
      const uint32_t cand = static_cast<uint32_t>(share >> (8 * r)) &
                            gather_bytes(witnessed >> s_qkind[r]);
      // dependency bits in the strided order, back to this thread's 8
      // consecutive slots through the warp's ballots
      uint32_t word = 0;
      if (__any_sync(kFull, cand != 0)) {
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const bool dep = ((cand >> i) & 1u) && lex_less(lanes[i], bound);
          const uint32_t ballot = __ballot_sync(kFull, dep);   // wbase + 32i ..
          word = i == (lane >> 2) ? ballot : word;
        }
      }
      if (nvalid <= 0) continue;
      const uint32_t bits = (word >> (8 * (lane & 3))) & 0xFFu;
      if (packed) {
        out[static_cast<size_t>(b) * (T / kSlots) + t0 / kSlots] =
            static_cast<uint8_t>(bits);
      } else if (kVec8) {
        // bit i -> byte i: replicate, keep bit i of byte i, carry it to bit 7
        const uint64_t x = (bits * kByteLows) & 0x8040201008040201ULL;
        const uint64_t word8 = ((x + 0x7F7F7F7F7F7F7F7FULL) >> 7) & kByteLows;
        *reinterpret_cast<unsigned long long*>(
            out + static_cast<size_t>(b) * T + t0) = word8;
      } else {
        for (int i = 0; i < nvalid; ++i) {
          out[static_cast<size_t>(b) * T + t0 + i] = (bits >> i) & 1u;
        }
      }
    }
  }
}

// scratch (only when gridDim.x > 1): ceil(B / R) zeroed uint32 counters,
// one per row group, then the partials [B, gridDim.x, 5] int32.
template <bool kVec8, int R, bool kSigned>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)
max_conflict_kernel(const uint8_t* __restrict__ inc,     // [K, T]
                    const int32_t* __restrict__ ts,      // [T, 5]
                    const int32_t* __restrict__ txn_id,  // [T, 5]
                    const uint8_t* __restrict__ active,  // [T]
                    const int32_t* __restrict__ offsets, // [B + 1]
                    const int32_t* __restrict__ cols,    // [N]
                    const int8_t* __restrict__ qvals,    // [N]  (kSigned)
                    int B, int T, int K,
                    int32_t* scratch,                    // see above
                    int32_t* __restrict__ out) {         // [B, 5]
  __shared__ CsrStage<R, kSigned> st;
  __shared__ int32_t s_part[kMaxWarps][R][kLanes];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int t0 = (blockIdx.x * blockDim.x + tid) * kSlots;
  const int wbase = t0 - lane * kSlots;        // the warp's first slot
  const int nvalid = min(kSlots, T - t0);      // <= 0: past T, barriers only

  // slot data, warp-strided as in deps_join_kernel
  int32_t vals[kSlots][kLanes];
  uint32_t act = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int t = wbase + lane + 32 * i;
    const bool v = t < T;
    int32_t e[kLanes], id[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      e[l] = v ? __ldg(ts + static_cast<size_t>(t) * kLanes + l) : 0;
      id[l] = v ? __ldg(txn_id + static_cast<size_t>(t) * kLanes + l) : 0;
    }
    const bool use_id = lex_less(e, id);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) vals[i][l] = use_id ? id[l] : e[l];
    if (v && __ldg(active + t) != 0) act |= 1u << i;
  }
  // with several rows per group, which slots beat which, once: byte i of
  // `beaten` holds the slots j whose lanes are greater than slot i's, or
  // equal with j < i, so any nonempty candidate set has one top slot
  uint64_t beaten = 0;
  if constexpr (R > 1) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
#pragma unroll
      for (int j = i + 1; j < kSlots; ++j) {
        beaten |= lex_less(vals[i], vals[j]) ? 1ULL << (8 * i + j)
                                             : 1ULL << (8 * j + i);
      }
    }
  }

  const int n_tiles = gridDim.x;
  const int n_groups = (B + R - 1) / R;
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int b0 = g * R;
    const int nrows = min(R, B - b0);
    if (g != static_cast<int>(blockIdx.y)) __syncthreads();  // smem reuse
    const uint64_t share = rows_share<kVec8, R, kSigned>(
        inc, offsets, cols, qvals, b0, nrows, T, K, t0, nvalid, st);
#pragma unroll 1
    for (int r = 0; r < nrows; ++r) {
      // this thread's max over its candidate slots, then the warp's
      const uint32_t m = static_cast<uint32_t>(share >> (8 * r)) & act;
      int32_t best[kLanes] = {0, 0, 0, 0, 0};
      if (__any_sync(kFull, m != 0)) {
        int32_t mine[kLanes] = {-1, -1, -1, -1, -1};
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if constexpr (R > 1) {
            const bool top = ((m >> i) & 1u) &&
                             (static_cast<uint32_t>(beaten >> (8 * i)) & m) == 0;
#pragma unroll
            for (int l = 0; l < kLanes; ++l) mine[l] = top ? vals[i][l] : mine[l];
          } else {
            take_max(mine, vals[i], (m >> i) & 1u);
          }
        }
        warp_lex_max(mine, best);
      }
      if (lane == 0) {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) s_part[warp][r][l] = best[l];
      }
    }
    __syncthreads();
    if (tid < nrows) {
      int32_t best[kLanes] = {0, 0, 0, 0, 0};
      for (int w = 0; w < nwarps; ++w) take_max(best, s_part[w][tid]);
      const size_t b = b0 + tid;
      int32_t* dst = n_tiles == 1
          ? out + b * kLanes
          : scratch + n_groups + (b * n_tiles + blockIdx.x) * kLanes;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) dst[l] = best[l];
    }
  }
  if (n_tiles == 1) return;

  // per row group, the last block to finish folds the group's partials
  const int32_t* partial = scratch + n_groups;
  __threadfence();                             // this block's partials
  __syncthreads();
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    if (tid == 0) {
      unsigned int* counter = reinterpret_cast<unsigned int*>(scratch) + g;
      s_last = atomicAdd(counter, 1u) == static_cast<unsigned int>(n_tiles - 1);
    }
    __syncthreads();
    const bool last = s_last;
    __syncthreads();                           // s_last is reused next group
    if (!last) continue;
    __threadfence();
    const int b0 = g * R;
    const int nrows = min(R, B - b0);
    for (int r = warp; r < nrows; r += nwarps) {
      const size_t b = b0 + r;
      int32_t mine[kLanes] = {-1, -1, -1, -1, -1};
      for (int tile = lane; tile < n_tiles; tile += 32) {
        int32_t cand[kLanes];
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          cand[l] = __ldcg(partial + (b * n_tiles + tile) * kLanes + l);
        }
        take_max(mine, cand);
      }
      int32_t best[kLanes];
      warp_lex_max(mine, best);
      if (lane == 0) {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) out[b * kLanes + l] = best[l];
      }
    }
  }
}

// Rows per group: R = 8 when the card gets a block per SM that way, else 1
// (more blocks for a small call; always 1 for a signed query).  Blocks per tile: enough for kBlocksPerSM
// blocks on every SM, each walking its share of the row groups.  The SM
// count is that of the current device, read once per device; a failed
// query is returned, not guessed.
struct Geometry {
  dim3 grid;
  int threads;
  int rows;
  int groups;
};

cudaError_t geometry(int B, int T, bool is_signed, Geometry* g) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int owners = (T + kSlots - 1) / kSlots;            // threads with slots
  const int threads = T > kTile ? kMaxThreads : (owners + 31) / 32 * 32;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int rows = !is_signed &&
                           static_cast<long long>(n_tiles) * ((B + kRows - 1) / kRows) >=
                           sms ? kRows : kRowsSmall;
  const int groups = (B + rows - 1) / rows;
  const int per_tile = min((kBlocksPerSM * sms + n_tiles - 1) / n_tiles, 65535);
  const int walk = (groups + per_tile - 1) / per_tile;      // groups per block
  *g = Geometry{dim3(n_tiles, (groups + walk - 1) / walk), threads, rows,
                groups};
  return cudaSuccess;
}

template <int R, bool kSigned>
void deps_join_run(const Geometry& g, cudaStream_t s, bool vec8,
                   const void* inc, const void* txn_id, const void* kind,
                   const void* status, const void* active, const void* offsets,
                   const void* cols, const void* vals, const void* before,
                   const void* qkind, unsigned long long wit_bits, int n_kinds,
                   int invalidated, int B, int T, int K, int packed, void* out) {
  auto* kernel = vec8 ? deps_join_kernel<true, R, kSigned>
                      : deps_join_kernel<false, R, kSigned>;
  kernel<<<g.grid, g.threads, 0, s>>>(
      static_cast<const uint8_t*>(inc), static_cast<const int32_t*>(txn_id),
      static_cast<const int8_t*>(kind), static_cast<const int8_t*>(status),
      static_cast<const uint8_t*>(active), static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(cols), static_cast<const int8_t*>(vals),
      static_cast<const int32_t*>(before),
      static_cast<const int8_t*>(qkind), wit_bits, n_kinds, invalidated, B, T,
      K, packed, static_cast<uint8_t*>(out));
}

template <int R, bool kSigned>
void max_conflict_run(const Geometry& g, cudaStream_t s, bool vec8,
                      const void* inc, const void* ts, const void* txn_id,
                      const void* active, const void* offsets,
                      const void* cols, const void* vals, int B, int T, int K,
                      void* scratch, void* out) {
  auto* kernel = vec8 ? max_conflict_kernel<true, R, kSigned>
                      : max_conflict_kernel<false, R, kSigned>;
  kernel<<<g.grid, g.threads, 0, s>>>(
      static_cast<const uint8_t*>(inc), static_cast<const int32_t*>(ts),
      static_cast<const int32_t*>(txn_id), static_cast<const uint8_t*>(active),
      static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(cols),
      static_cast<const int8_t*>(vals), B, T, K,
      static_cast<int32_t*>(scratch), static_cast<int32_t*>(out));
}

}  // namespace

extern "C" {

// vals: null (the columns name 0/1 index rows, ORed), or the query's int8
// value beside each column, the index's bytes then read as int8 and summed
int deps_join_launch(const void* inc, const void* txn_id, const void* kind,
                     const void* status, const void* active,
                     const void* offsets, const void* cols, const void* vals,
                     const void* before, const void* qkind,
                     unsigned long long wit_bits, int n_kinds, int invalidated,
                     int B, int T, int K, int packed, void* out,
                     void* stream) {
  Geometry g;
  const cudaError_t err = geometry(B, T, vals != nullptr, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 8-byte loads need every key row 8-byte aligned
  const bool vec8 = T % kSlots == 0 && (reinterpret_cast<uintptr_t>(inc) & 7) == 0;
  if (vals != nullptr) {
    deps_join_run<kRowsSmall, true>(g, s, vec8, inc, txn_id, kind, status,
                                    active, offsets, cols, vals, before, qkind,
                                    wit_bits, n_kinds, invalidated, B, T, K,
                                    packed, out);
  } else if (g.rows == kRows) {
    deps_join_run<kRows, false>(g, s, vec8, inc, txn_id, kind, status, active,
                                offsets, cols, nullptr, before, qkind, wit_bits,
                                n_kinds, invalidated, B, T, K, packed, out);
  } else {
    deps_join_run<kRowsSmall, false>(g, s, vec8, inc, txn_id, kind, status,
                                     active, offsets, cols, nullptr, before,
                                     qkind, wit_bits, n_kinds, invalidated, B,
                                     T, K, packed, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// int32 elements of scratch max_conflict_launch needs: 0 when T fits one
// tile, else one counter per row group and the [B, n_tiles, 5] partials
// (is_signed: whether the launch passes values).  A failed device query
// returns minus its CUDA error.
long long max_conflict_scratch_ints(int B, int T, int is_signed) {
  Geometry g;
  const cudaError_t err = geometry(B, T, is_signed != 0, &g);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  if (g.grid.x == 1) return 0;
  return static_cast<long long>(g.groups) +
         static_cast<long long>(B) * g.grid.x * kLanes;
}

// vals: as deps_join_launch's
int max_conflict_launch(const void* inc, const void* ts, const void* txn_id,
                        const void* active, const void* offsets,
                        const void* cols, const void* vals, int B, int T,
                        int K, void* scratch, void* out, void* stream) {
  Geometry g;
  cudaError_t err = geometry(B, T, vals != nullptr, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.grid.x > 1) {
    err = cudaMemsetAsync(scratch, 0, g.groups * sizeof(unsigned int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 8-byte loads need every key row 8-byte aligned
  const bool vec8 = T % kSlots == 0 && (reinterpret_cast<uintptr_t>(inc) & 7) == 0;
  if (vals != nullptr) {
    max_conflict_run<kRowsSmall, true>(g, s, vec8, inc, ts, txn_id, active,
                                       offsets, cols, vals, B, T, K, scratch,
                                       out);
  } else if (g.rows == kRows) {
    max_conflict_run<kRows, false>(g, s, vec8, inc, ts, txn_id, active,
                                   offsets, cols, nullptr, B, T, K, scratch,
                                   out);
  } else {
    max_conflict_run<kRowsSmall, false>(g, s, vec8, inc, ts, txn_id, active,
                                        offsets, cols, nullptr, B, T, K,
                                        scratch, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
