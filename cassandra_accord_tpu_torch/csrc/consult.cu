// The dependency consult on Hopper (sm_90a): kernels K1, K2 and K12.
//
// K1 deps_join replaces the TPU kernel cassandra_accord_tpu/ops/pallas_join.py
// ::_join_kernel (launched by _pallas_join, wrapped by overlap_join_fused),
// and with it the dependency half of the consult
// (ops/deps_kernels.py::consult/consult_packed/overlap_join on their CSR
// route; the service's window takes it inside K12, below):
//
//   out[b, t] = OR_{c in cols(b)} inc[c, t]
//             & ts_less(txn_id[t], before[b])
//             & WITNESSES[qkind[b], kind[t]]
//             & active[t] & (status[t] != INVALIDATED)
//
// K2 max_conflict replaces the timestamp-proposal half of the same consult
// (ops/deps_kernels.py::max_conflict_keys, the max_lanes output of
// device_service/kernel.py::ragged_consult_t): the lexicographic max of
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
// K12 fused_consult is the service's window: K1 over the live index and
// K2 over the key index for one CSR query, in one launch, as the reference
// computes a window in one program (device_service/kernel.py::consult_t,
// two products sharing the query).  Its geometry is K2's: row groups of R
// = 8, or 1 when the grid would be small; tiles of kTile slots; one launch
// with no fill when T <= kTile; above that the per-row-group counters,
// zeroed by one memset node on the caller's stream, and the last-block
// fold.  With one row a group (every window of the burn, the CLI,
// Maelstrom and verify) each thread takes both halves: it loads its
// slots' txnId lanes, ts, kind, status and active once, each row's CSR
// slice is staged once behind one barrier, each named key's word is read
// from both indexes in the same burst, and K1's epilogue and K2's
// reduction run on the slot data still in registers, their loads and
// compares overlapping.  With R = 8 one thread holding both halves' slot
// data took 219-230 registers (or spilled 284-324 bytes under 128) and was
// slower than K1 + K2 at T = 65,536; there a block holds two halves of
// 256 threads over the same slots instead (__launch_bounds__(512, 1), one
// block an SM, the grid one wave), K1's threads on the live index and
// K2's on the key index, the CSR slice staged once for both: a thread
// holds what K1 or K2 alone holds (tools_torch/k12_compare.py --variants
// builds and times these layouts).  ptxas reports 127 registers and no
// spill for the one-thread kernel (128 and 76 bytes of spill for its
// byte-load twin, T % 8 != 0), 128 and no spill for the two halves.
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
// thread; ptxas (-Xptxas -v) reports 93 to 128 for K1's and K2's twelve
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
constexpr int kFusedThreads = 2 * kMaxThreads;   // K12: two halves a block
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

// The key overlap of rows b0 .. b0 + nrows - 1 with the warp's slots in
// each of N [K, T] indexes, read through one staged CSR slice, in the
// warp-strided order of the slot data: bit 8r + i of share[n] = row b0 + r
// shares a key of index n with slot wbase + lane + 32i (kSigned: the row's
// signed sum there is > 0).  Every thread of the block calls it: it holds at
// least one barrier, after which whatever the caller wrote to shared memory
// before the call is visible block-wide.
//
// Each thread ORs the incidence words of its 8 consecutive slots
// t0 = wbase + 8 lane .. + 7 (one 8-byte load per key row and index),
// starting from the rows' CSR slice staged in shared memory: the first kLead
// keys of every row are loaded together, the rest of a wide row in bursts.
// The per-row byte masks then move to the strided order by shuffles (slot
// wbase + lane + 32i sits in byte lane % 8 of lane 4i + lane / 8).
template <bool kVec8, int R, bool kSigned, int N>
__device__ __forceinline__ void rows_shares(
    const uint8_t* const (&inc)[N], const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ cols, const int8_t* __restrict__ vals, int b0,
    int nrows, int T, int K, int t0, int nvalid, CsrStage<R, kSigned>& st,
    uint64_t (&share)[N]) {
  static_assert(!kSigned || (R == 1 && N == 1),
                "signed queries take one row a group and one index");
  uint64_t acc[N][R];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[n][r] = 0;
  }
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
        const uint64_t w = inc_word<kVec8>(inc[0], st.cols[j - c0], T, t0,
                                           nvalid);
        const int v = st.vals[j - c0];
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          sum[i] += v * static_cast<int>(static_cast<int8_t>(w >> (8 * i)));
        }
      }
      if (c1 >= hi) break;
      continue;
    }
    // rows in flight: the first kLead keys of every row in every index, all
    // loads issued before the first OR
    uint64_t w[N][R][kLead];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rlo = r < nrows ? max(st.off[r], c0) : 0;
      const int rhi = r < nrows ? min(st.off[r + 1], c1) : 0;
#pragma unroll
      for (int p = 0; p < kLead; ++p) {
        const int j = rlo + p;
        const int c = j < rhi ? st.cols[j - c0] : -1;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          w[n][r][p] = inc_word<kVec8>(inc[n], c, T, t0, nvalid);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int p = 0; p < kLead; ++p) acc[n][r] |= w[n][r][p];
      }
    }
    // the rest of a wide row, kBurst loads an index at a time
#pragma unroll 1
    for (int r = 0; r < nrows; ++r) {
      const int rlo = max(st.off[r], c0) + kLead;
      const int rhi = min(st.off[r + 1], c1);
      uint64_t tail[N];
#pragma unroll
      for (int n = 0; n < N; ++n) tail[n] = 0;
      for (int j = rlo; j < rhi; j += kBurst) {
        uint64_t v[N][kBurst];
#pragma unroll
        for (int u = 0; u < kBurst; ++u) {
          const int c = j + u < rhi ? st.cols[j + u - c0] : -1;
#pragma unroll
          for (int n = 0; n < N; ++n) {
            v[n][u] = inc_word<kVec8>(inc[n], c, T, t0, nvalid);
          }
        }
#pragma unroll
        for (int n = 0; n < N; ++n) {
#pragma unroll
          for (int u = 0; u < kBurst; ++u) tail[n] |= v[n][u];
        }
      }
#pragma unroll
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int q = 0; q < R; ++q) acc[n][q] |= q == r ? tail[n] : 0;
      }
    }
    if (c1 >= hi) break;
  }
  if constexpr (kSigned) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      acc[0][0] |= static_cast<uint64_t>(sum[i] > 0) << (8 * i);
    }
  }
  const int lane = tid & 31;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    uint64_t m = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m |= static_cast<uint64_t>(byte_mask(acc[n][r])) << (8 * r);
    }
    uint64_t s = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const uint64_t v = __shfl_sync(kFull, m, 4 * i + (lane >> 3)) >> (lane & 7);
      s |= (v & kByteLows) << i;
    }
    share[n] = s;
  }
}

// rows_shares over one index
template <bool kVec8, int R, bool kSigned>
__device__ __forceinline__ uint64_t rows_share(
    const uint8_t* __restrict__ inc, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ cols, const int8_t* __restrict__ vals, int b0,
    int nrows, int T, int K, int t0, int nvalid, CsrStage<R, kSigned>& st) {
  const uint8_t* const idx[1] = {inc};
  uint64_t share[1];
  rows_shares<kVec8, R, kSigned, 1>(idx, offsets, cols, vals, b0, nrows, T,
                                    K, t0, nvalid, st, share);
  return share[0];
}

// The txnId lanes of this thread's 8 warp-strided slots wbase + lane + 32i
// (a warp's load of one lane spans 640 bytes), 0 past T, and whether each
// is active (bit i of the result)
__device__ __forceinline__ uint32_t load_ids(
    const int32_t* __restrict__ txn_id, const uint8_t* __restrict__ active,
    int T, int wbase, int lane, int32_t (&ids)[kSlots][kLanes]) {
  uint32_t act = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int t = wbase + lane + 32 * i;
    const bool v = t < T;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      ids[i][l] = v ? __ldg(txn_id + static_cast<size_t>(t) * kLanes + l) : 0;
    }
    if (v && __ldg(active + t) != 0) act |= 1u << i;
  }
  return act;
}

// load_ids' lanes and active bits, and in byte i of `witnessed` the query
// kinds (bit qk) whose rows may depend on slot i, 0 when the slot is not
// eligible (inactive or invalidated)
__device__ __forceinline__ uint32_t load_slots(
    const int32_t* __restrict__ txn_id, const int8_t* __restrict__ kind,
    const int8_t* __restrict__ status, const uint8_t* __restrict__ active,
    unsigned long long wit_bits, int n_kinds, int invalidated, int T,
    int wbase, int lane, int32_t (&lanes)[kSlots][kLanes],
    uint64_t& witnessed) {
  const uint64_t wit_by_kind = transpose8(wit_bits);   // byte k: column k
  const uint32_t act = load_ids(txn_id, active, T, wbase, lane, lanes);
  witnessed = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int t = wbase + lane + 32 * i;
    const bool v = t < T;
    const int code = v ? __ldg(status + t) : invalidated;
    const int k = v ? clamp_kind(__ldg(kind + t), n_kinds) : 0;
    if (((act >> i) & 1u) && code != invalidated) {
      witnessed |= ((wit_by_kind >> (8 * k)) & 0xFFULL) << (8 * i);
    }
  }
  return act;
}

// K2's value of each slot, max(ts, txnId) lexicographically, in place of
// its txnId lanes (0 past T)
__device__ __forceinline__ void slot_values(const int32_t* __restrict__ ts,
                                            int T, int wbase, int lane,
                                            int32_t (&vals)[kSlots][kLanes]) {
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int t = wbase + lane + 32 * i;
    int32_t e[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      e[l] = t < T ? __ldg(ts + static_cast<size_t>(t) * kLanes + l) : 0;
    }
    const bool use_id = lex_less(e, vals[i]);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) vals[i][l] = use_id ? vals[i][l] : e[l];
  }
}

// With several rows per group, which slots beat which, once: byte i holds
// the slots j whose values are greater than slot i's, or equal with j < i,
// so any nonempty candidate set has one top slot (0 with one row a group)
template <int R>
__device__ __forceinline__ uint64_t slot_ranks(
    const int32_t (&vals)[kSlots][kLanes]) {
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
  return beaten;
}

// K1's epilogue for one row: the dependency bits of this thread's 8
// consecutive slots (bit i = slot t0 + i) from the row's candidates `cand`
// in the strided order (key overlap, witnessed, eligible), each checked
// started-before the row's bound, moved back through the warp's ballots.
// A warp with no candidate skips the compares.  Every lane calls it.
__device__ __forceinline__ uint32_t deps_bits(
    uint32_t cand, const int32_t (&lanes)[kSlots][kLanes],
    const int32_t (&before)[kLanes], int lane) {
  int32_t bound[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) bound[l] = before[l];
  uint32_t word = 0;
  if (__any_sync(kFull, cand != 0)) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const bool dep = ((cand >> i) & 1u) && lex_less(lanes[i], bound);
      const uint32_t ballot = __ballot_sync(kFull, dep);   // wbase + 32i ..
      word = i == (lane >> 2) ? ballot : word;
    }
  }
  return (word >> (8 * (lane & 3))) & 0xFFu;
}

// row b's dependency bits for slots t0 .. t0 + nvalid - 1 (nvalid > 0)
template <bool kVec8>
__device__ __forceinline__ void store_deps(uint8_t* __restrict__ out,
                                           uint32_t bits, int b, int T,
                                           int t0, int nvalid, int packed) {
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

// K2's reduction for one row: the warp's lex max over its candidate slots
// `m` (strided order), zero lanes when none.  With R > 1 a thread's top
// candidate is a mask test per slot (`beaten`); the warp's max is taken
// lane by lane.  Every lane calls it and gets the result.
template <int R>
__device__ __forceinline__ void row_max(uint32_t m,
                                        const int32_t (&vals)[kSlots][kLanes],
                                        uint64_t beaten,
                                        int32_t (&best)[kLanes]) {
#pragma unroll
  for (int l = 0; l < kLanes; ++l) best[l] = 0;
  if (!__any_sync(kFull, m != 0)) return;
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

// After a barrier: the [nwarps, R, 5] maxima of the row group at b0 folded,
// one thread a row, into out when T fits one tile, else into the group's
// partials [B, n_tiles, 5] (behind the n_groups counters)
template <int R>
__device__ __forceinline__ void fold_warps(
    const int32_t (&s_part)[kMaxWarps][R][kLanes], int nwarps, int b0,
    int nrows, int n_groups, int32_t* scratch, int32_t* __restrict__ out) {
  const int tid = threadIdx.x;
  if (tid >= nrows) return;
  int32_t best[kLanes] = {0, 0, 0, 0, 0};
  for (int w = 0; w < nwarps; ++w) take_max(best, s_part[w][tid]);
  const size_t b = b0 + tid;
  int32_t* dst = gridDim.x == 1
      ? out + b * kLanes
      : scratch + n_groups + (b * gridDim.x + blockIdx.x) * kLanes;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) dst[l] = best[l];
}

// Across tiles (gridDim.x > 1), after the block has written its partials:
// per row group, the last block to finish (the group's counter in scratch)
// folds the group's partials into out.  Every thread of the block calls it.
template <int R>
__device__ __forceinline__ void fold_tiles(int B, int32_t* scratch,
                                           int32_t* __restrict__ out,
                                           bool& s_last) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n_tiles = gridDim.x;
  const int n_groups = (B + R - 1) / R;
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

  int32_t lanes[kSlots][kLanes];
  uint64_t witnessed;
  load_slots(txn_id, kind, status, active, wit_bits, n_kinds, invalidated, T,
             wbase, lane, lanes, witnessed);

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
      const uint32_t cand = static_cast<uint32_t>(share >> (8 * r)) &
                            gather_bytes(witnessed >> s_qkind[r]);
      const uint32_t bits = deps_bits(cand, lanes, s_before[r], lane);
      if (nvalid > 0) store_deps<kVec8>(out, bits, b0 + r, T, t0, nvalid, packed);
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
  const int t0 = (blockIdx.x * blockDim.x + tid) * kSlots;
  const int wbase = t0 - lane * kSlots;        // the warp's first slot
  const int nvalid = min(kSlots, T - t0);      // <= 0: past T, barriers only

  // slot data, warp-strided as in deps_join_kernel: the values in place of
  // the txnId lanes they come from
  int32_t vals[kSlots][kLanes];
  const uint32_t act = load_ids(txn_id, active, T, wbase, lane, vals);
  slot_values(ts, T, wbase, lane, vals);
  const uint64_t beaten = slot_ranks<R>(vals);

  const int n_groups = (B + R - 1) / R;
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int b0 = g * R;
    const int nrows = min(R, B - b0);
    if (g != static_cast<int>(blockIdx.y)) __syncthreads();  // smem reuse
    const uint64_t share = rows_share<kVec8, R, kSigned>(
        inc, offsets, cols, qvals, b0, nrows, T, K, t0, nvalid, st);
#pragma unroll 1
    for (int r = 0; r < nrows; ++r) {
      int32_t best[kLanes];
      row_max<R>(static_cast<uint32_t>(share >> (8 * r)) & act, vals, beaten,
                 best);
      if (lane == 0) {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) s_part[warp][r][l] = best[l];
      }
    }
    __syncthreads();
    fold_warps<R>(s_part, blockDim.x >> 5, b0, nrows, n_groups, scratch, out);
  }
  if (gridDim.x > 1) fold_tiles<R>(B, scratch, out, s_last);
}

// K12 with one row a group (the grids of the main path's windows): K1 over
// `live` and K2 over `key` for one CSR batch in one launch, each thread
// taking both halves on its slots.  The slot data is read once (txnId
// lanes, ts, kind, status, active), each row's CSR slice is staged once,
// each named key's word is read from both indexes in the same burst, and
// the row takes K1's epilogue and K2's reduction on the slot data still in
// registers.  Deps go out as K1's, the maxima as K2's (the same scratch,
// counters and last-block fold).
template <bool kVec8, int R>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)
fused_consult_kernel(const uint8_t* __restrict__ live,     // [K, T]
                     const uint8_t* __restrict__ key,      // [K, T]
                     const int32_t* __restrict__ ts,       // [T, 5]
                     const int32_t* __restrict__ txn_id,   // [T, 5]
                     const int8_t* __restrict__ kind,      // [T]
                     const int8_t* __restrict__ status,    // [T]
                     const uint8_t* __restrict__ active,   // [T]
                     const int32_t* __restrict__ offsets,  // [B + 1]
                     const int32_t* __restrict__ cols,     // [N]
                     const int32_t* __restrict__ before,   // [B, 5]
                     const int8_t* __restrict__ qkind,     // [B]
                     unsigned long long wit_bits, int n_kinds,
                     int invalidated, int B, int T, int K, int packed,
                     int32_t* scratch,                     // as K2's
                     int32_t* __restrict__ lanes_out,      // [B, 5]
                     uint8_t* __restrict__ deps_out) {     // [B, T (/8)]
  __shared__ CsrStage<R, false> st;
  __shared__ int32_t s_before[R][kLanes];
  __shared__ int32_t s_qkind[R];
  __shared__ int32_t s_part[kMaxWarps][R][kLanes];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = (blockIdx.x * blockDim.x + tid) * kSlots;
  const int wbase = t0 - lane * kSlots;        // the warp's first slot
  const int nvalid = min(kSlots, T - t0);      // <= 0: past T, barriers only

  int32_t lanes[kSlots][kLanes], vals[kSlots][kLanes];
  uint64_t witnessed;
  const uint32_t act = load_slots(txn_id, kind, status, active, wit_bits,
                                  n_kinds, invalidated, T, wbase, lane, lanes,
                                  witnessed);
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) vals[i][l] = lanes[i][l];
  }
  slot_values(ts, T, wbase, lane, vals);
  const uint64_t beaten = slot_ranks<R>(vals);
  const uint8_t* const idx[2] = {live, key};

  const int n_groups = (B + R - 1) / R;
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int b0 = g * R;
    const int nrows = min(R, B - b0);
    if (g != static_cast<int>(blockIdx.y)) __syncthreads();  // smem reuse
    for (int i = tid; i < nrows * kLanes; i += blockDim.x) {
      s_before[i / kLanes][i % kLanes] = __ldg(before + b0 * kLanes + i);
    }
    if (tid < nrows) s_qkind[tid] = clamp_kind(__ldg(qkind + b0 + tid), n_kinds);
    uint64_t share[2];                         // live (deps), key (max)
    rows_shares<kVec8, R, false, 2>(idx, offsets, cols, nullptr, b0, nrows, T,
                                    K, t0, nvalid, st, share);
#pragma unroll 1
    for (int r = 0; r < nrows; ++r) {
      const uint32_t cand = static_cast<uint32_t>(share[0] >> (8 * r)) &
                            gather_bytes(witnessed >> s_qkind[r]);
      const uint32_t bits = deps_bits(cand, lanes, s_before[r], lane);
      if (nvalid > 0) {
        store_deps<kVec8>(deps_out, bits, b0 + r, T, t0, nvalid, packed);
      }
      int32_t best[kLanes];
      row_max<R>(static_cast<uint32_t>(share[1] >> (8 * r)) & act, vals,
                 beaten, best);
      if (lane == 0) {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) s_part[warp][r][l] = best[l];
      }
    }
    __syncthreads();
    fold_warps<R>(s_part, blockDim.x >> 5, b0, nrows, n_groups, scratch,
                  lanes_out);
  }
  if (gridDim.x > 1) fold_tiles<R>(B, scratch, lanes_out, s_last);
}

// K12 with R rows a group (large grids): as fused_consult_kernel, but a
// thread holding both halves' slot data takes 230 registers at R = 8 (or
// spills 272-320 bytes under 128), so a block holds two halves over the
// same slots instead, each laid out as a K1 or K2 block: K1's threads (the
// first half) load the txnId lanes, kind, status and active of their slots
// and OR the live index's words, K2's threads (the second) load txnId, ts
// and active and OR the key index's words, and every row group's CSR slice
// is staged once for both, behind one barrier.  Each half then runs its own
// epilogue on its rows.  The halves' branches are warp-uniform and every
// barrier is outside them.
template <bool kVec8, int R>
__global__ void __launch_bounds__(kFusedThreads, 1)
fused_halves_kernel(const uint8_t* __restrict__ live,      // [K, T]
                    const uint8_t* __restrict__ key,       // [K, T]
                    const int32_t* __restrict__ ts,        // [T, 5]
                    const int32_t* __restrict__ txn_id,    // [T, 5]
                    const int8_t* __restrict__ kind,       // [T]
                    const int8_t* __restrict__ status,     // [T]
                    const uint8_t* __restrict__ active,    // [T]
                    const int32_t* __restrict__ offsets,   // [B + 1]
                    const int32_t* __restrict__ cols,      // [N]
                    const int32_t* __restrict__ before,    // [B, 5]
                    const int8_t* __restrict__ qkind,      // [B]
                    unsigned long long wit_bits, int n_kinds,
                    int invalidated, int B, int T, int K, int packed,
                    int32_t* scratch,                      // as K2's
                    int32_t* __restrict__ lanes_out,       // [B, 5]
                    uint8_t* __restrict__ deps_out) {      // [B, T (/8)]
  __shared__ CsrStage<R, false> st;
  __shared__ int32_t s_before[R][kLanes];
  __shared__ int32_t s_qkind[R];
  __shared__ int32_t s_part[kMaxWarps][R][kLanes];
  __shared__ bool s_last;
  const int half = blockDim.x >> 1;            // threads a half, % 32 == 0
  const bool maxes = static_cast<int>(threadIdx.x) >= half;   // K2's half
  const int tid = threadIdx.x - (maxes ? half : 0);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = (blockIdx.x * half + tid) * kSlots;
  const int wbase = t0 - lane * kSlots;        // the warp's first slot
  const int nvalid = min(kSlots, T - t0);      // <= 0: past T, barriers only

  // the half's slot data, warp-strided: K1's txnId lanes and witnessed
  // kinds, or K2's values (in place of the lanes), ranks and active bits
  int32_t lanes[kSlots][kLanes];
  uint64_t witnessed = 0, beaten = 0;
  uint32_t act = 0;
  if (maxes) {
    act = load_ids(txn_id, active, T, wbase, lane, lanes);
    slot_values(ts, T, wbase, lane, lanes);
    beaten = slot_ranks<R>(lanes);
  } else {
    load_slots(txn_id, kind, status, active, wit_bits, n_kinds, invalidated,
               T, wbase, lane, lanes, witnessed);
  }
  const uint8_t* const inc = maxes ? key : live;

  const int n_groups = (B + R - 1) / R;
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int b0 = g * R;
    const int nrows = min(R, B - b0);
    if (g != static_cast<int>(blockIdx.y)) __syncthreads();  // smem reuse
    if (!maxes) {
      for (int i = tid; i < nrows * kLanes; i += half) {
        s_before[i / kLanes][i % kLanes] = __ldg(before + b0 * kLanes + i);
      }
      if (tid < nrows) {
        s_qkind[tid] = clamp_kind(__ldg(qkind + b0 + tid), n_kinds);
      }
    }
    const uint64_t share = rows_share<kVec8, R, false>(
        inc, offsets, cols, nullptr, b0, nrows, T, K, t0, nvalid, st);
#pragma unroll 1
    for (int r = 0; r < nrows; ++r) {
      if (maxes) {
        int32_t best[kLanes];
        row_max<R>(static_cast<uint32_t>(share >> (8 * r)) & act, lanes,
                   beaten, best);
        if (lane == 0) {
#pragma unroll
          for (int l = 0; l < kLanes; ++l) s_part[warp][r][l] = best[l];
        }
      } else {
        const uint32_t cand = static_cast<uint32_t>(share >> (8 * r)) &
                              gather_bytes(witnessed >> s_qkind[r]);
        const uint32_t bits = deps_bits(cand, lanes, s_before[r], lane);
        if (nvalid > 0) {
          store_deps<kVec8>(deps_out, bits, b0 + r, T, t0, nvalid, packed);
        }
      }
    }
    __syncthreads();
    fold_warps<R>(s_part, half >> 5, b0, nrows, n_groups, scratch,
                  lanes_out);
  }
  if (gridDim.x > 1) fold_tiles<R>(B, scratch, lanes_out, s_last);
}

// Rows per group: R = 8 when the card gets a block per SM that way, else 1
// (more blocks for a small call; always 1 for a signed query).  Blocks per tile: enough for kBlocksPerSM
// blocks on every SM, each walking its share of the row groups (K12 with R
// = 8: one block of two halves an SM, rounded down, so that the grid is
// one wave).
// The SM count is that of the current device, read once per device; a
// failed query is returned, not guessed.
struct Geometry {
  dim3 grid;
  int threads;
  int rows;
  int groups;
};

cudaError_t geometry(int B, int T, bool is_signed, Geometry* g,
                     bool fused = false) {
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
  // K12 in two halves (R = kRows): one block an SM, as many blocks as SMs
  // at most
  const bool halves = fused && rows == kRows;
  const int per_tile = halves
      ? max(1, min(sms / n_tiles, 65535))
      : min((kBlocksPerSM * sms + n_tiles - 1) / n_tiles, 65535);
  const int walk = (groups + per_tile - 1) / per_tile;      // groups per block
  *g = Geometry{dim3(n_tiles, (groups + walk - 1) / walk),
                halves ? 2 * threads : threads, rows, groups};
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

// K12 on one row a group (fused_consult_kernel) or R rows in two halves
// (fused_halves_kernel)
template <int R>
void fused_consult_run(const Geometry& g, cudaStream_t s, bool vec8,
                       const void* live, const void* key, const void* ts,
                       const void* txn_id, const void* kind,
                       const void* status, const void* active,
                       const void* offsets, const void* cols,
                       const void* before, const void* qkind,
                       unsigned long long wit_bits, int n_kinds,
                       int invalidated, int B, int T, int K, int packed,
                       void* scratch, void* lanes_out, void* deps_out) {
  auto launch = [&](auto* kernel) {
    kernel<<<g.grid, g.threads, 0, s>>>(
        static_cast<const uint8_t*>(live), static_cast<const uint8_t*>(key),
        static_cast<const int32_t*>(ts), static_cast<const int32_t*>(txn_id),
        static_cast<const int8_t*>(kind), static_cast<const int8_t*>(status),
        static_cast<const uint8_t*>(active),
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(cols), static_cast<const int32_t*>(before),
        static_cast<const int8_t*>(qkind), wit_bits, n_kinds, invalidated, B,
        T, K, packed, static_cast<int32_t*>(scratch),
        static_cast<int32_t*>(lanes_out), static_cast<uint8_t*>(deps_out));
  };
  if constexpr (R == kRowsSmall) {
    launch(vec8 ? fused_consult_kernel<true, R> : fused_consult_kernel<false, R>);
  } else {
    launch(vec8 ? fused_halves_kernel<true, R> : fused_halves_kernel<false, R>);
  }
}

bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

// int32 elements of scratch a K2 or K12 launch needs: 0 when T fits one
// tile, else one counter per row group and the [B, n_tiles, 5] partials.
// A failed device query returns minus its CUDA error.
long long scratch_ints(int B, int T, bool is_signed, bool fused) {
  Geometry g;
  const cudaError_t err = geometry(B, T, is_signed, &g, fused);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  if (g.grid.x == 1) return 0;
  return static_cast<long long>(g.groups) +
         static_cast<long long>(B) * g.grid.x * kLanes;
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

// int32 elements of scratch max_conflict_launch needs (is_signed: whether
// the launch passes values), see scratch_ints
long long max_conflict_scratch_ints(int B, int T, int is_signed) {
  return scratch_ints(B, T, is_signed != 0, false);
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

// int32 elements of scratch fused_consult_launch needs, see scratch_ints
long long fused_consult_scratch_ints(int B, int T) {
  return scratch_ints(B, T, false, true);
}

// K12: deps_join_launch's deps of `live` into deps_out and
// max_conflict_launch's maxima of `key` into lanes_out, for one CSR query
// without values, in one launch (and, across tiles, its counters' memset)
int fused_consult_launch(const void* live, const void* key, const void* ts,
                         const void* txn_id, const void* kind,
                         const void* status, const void* active,
                         const void* offsets, const void* cols,
                         const void* before, const void* qkind,
                         unsigned long long wit_bits, int n_kinds,
                         int invalidated, int B, int T, int K, int packed,
                         void* scratch, void* lanes_out, void* deps_out,
                         void* stream) {
  Geometry g;
  cudaError_t err = geometry(B, T, false, &g, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.grid.x > 1) {
    err = cudaMemsetAsync(scratch, 0, g.groups * sizeof(unsigned int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 8-byte loads need every key row of both indexes 8-byte aligned, and
  // 8-byte stores of unpacked deps an aligned output
  const bool vec8 = T % kSlots == 0 && aligned8(live) && aligned8(key) &&
                    (packed || aligned8(deps_out));
  if (g.rows == kRows) {
    fused_consult_run<kRows>(g, s, vec8, live, key, ts, txn_id, kind, status,
                             active, offsets, cols, before, qkind, wit_bits,
                             n_kinds, invalidated, B, T, K, packed, scratch,
                             lanes_out, deps_out);
  } else {
    fused_consult_run<kRowsSmall>(g, s, vec8, live, key, ts, txn_id, kind,
                                  status, active, offsets, cols, before,
                                  qkind, wit_bits, n_kinds, invalidated, B, T,
                                  K, packed, scratch, lanes_out, deps_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
