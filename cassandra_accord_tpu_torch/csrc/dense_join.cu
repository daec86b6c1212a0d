// The dense form of the dependency consult on Hopper (sm_90a): kernels K1d
// and K2d, the key-overlap product on the int8 tensor cores.
//
// K1d deps_join_dense computes what K1 (consult.cu) computes, and replaces
// the same TPU kernel, cassandra_accord_tpu/ops/pallas_join.py::_join_kernel,
// in its own form: a [B, K] x [K, T] product on the matrix unit with the
// predicate applied in the epilogue,
//
//   out[b, t] = (sum_k q[b, k] * inc[k, t] > 0)
//             & ts_less(txn_id[t], before[b])
//             & WITNESSES[qkind[b], kind[t]]
//             & active[t] & (status[t] != INVALIDATED)
//
// as bool [B, T] or bit-packed [B, T/8] (bit i of byte j = slot 8j + i).
// K2d max_conflict_dense computes what K2 computes (the XLA max half of the
// reference's consult, device_service/kernel.py:55-59): per row, the
// lexicographic max of per_slot[t] = ts_less(ts[t], txn_id[t]) ? txn_id[t]
// : ts[t] over {t : product > 0 & active[t]}, zero lanes for none.  The
// arguments are K1's and K2's: the [K, T] uint8 index (T contiguous), the
// CSR query (offsets [B+1], cols [N]; duplicates legal, entries past
// offsets[B] never read, a column in [-K, -1] names column c + K and any
// other outside [0, K) is dropped), lanes, kinds, status, active.
//
// Why a second form.  The CSR kernels OR the incidence rows each query row
// names, so a batch re-reads nnz*T index bytes: 4.3 GB for 64 rows of 1,024
// keys at T = 65,536, against 134 MB for the whole [K, T] index.  Here the
// index streams from HBM once per row tile of up to 64 query rows, and the
// overlap is an int8 matrix product, so the bound is K*T bytes (0.040 ms at
// that shape on an H100 at 3.35 TB/s) while the product (2*B*K*T = 17 G
// ops, 8.7 us at 1,979 TOP/s) stays well below it.  ops/_kernels.py::
// join_form sends a call here only when its rows name many keys each.
//
// Tiles.  M = index slots: a block takes a tile of 128 slots, 32 per warp
// (two m16 tiles); N = query rows: 16 or 64 per block (NT = 2 or 8 n8
// tiles), one block per row tile and tile of slots, the row tiles of one
// slot tile neighbours in the grid so that their index reads meet in L2.
// Blocks are persistent: about four per SM, each walking the slot tiles
// y, y + gridDim.y, ... of its row tile, so it loads its query tile once.
// The contraction runs over K in stages of 64 keys (two k32 steps, straight
// code: both steps' loads can issue before the first product).
//
// The layout trap, and the route taken.  The index is [K, T] with T
// contiguous, but int8 mma.sync wants each register to hold four
// consecutive k of one row of A (and wgmma transposes in shared memory
// only for 16-bit types).  This kernel keeps the bytes as int8 and
// transposes in registers (route 1): a stage is copied as it lies ([64
// keys][128 slots], 16-byte cp.async, three stages in flight, the 16-byte
// chunks of each key row XOR-swizzled so that the fragment loads below
// hit 32 distinct banks); each thread then loads four 32-bit words, key
// rows 4c .. 4c+3 at its four slots 4g .. 4g+3 (g = lane / 4, c = lane %
// 4), and one 4x4 byte transpose (8 byte_perm) turns them into four A
// registers, one per slot, each holding keys 4c .. 4c+3.  So a thread's
// four slots are the A rows g, g+8 of both m16 tiles, and the accumulator
// rows it owns in the epilogue are exactly those four consecutive slots.
// The alternative, widening 0/1 to f16 for ldmatrix.trans, doubles the
// shared-memory traffic and halves the tensor rate for the same answer.
// mma.sync.m16n8k32 u8 x u8 -> s32: index bytes are 0..255 and query bytes
// 0/1, so a sum is >= 0 and > 0 iff some product is, and cannot wrap below
// 2^31 / 255 keys (the wrapper takes K <= 16,384).
//
// The query.  A first kernel turns the CSR query into bits, [rows][words
// | 1] uint32 in scratch (the odd stride keeps the eight rows a warp
// reads at once on eight banks; words = 2 per stage of 64 keys, zero past
// K), once per call: a thread per column wraps a negative column once,
// drops one outside [0, K), finds its row by binary search in offsets,
// and the lanes that set bits of one word OR them along the warp (a
// segmented scan by shuffles) so that one atomicOr per run of a word
// reaches memory.  A bit is 0 or 1, so duplicate columns (300 of one key)
// cannot wrap a u8 operand to 0.  Each block of the product copies its
// rows' bits into shared memory with the first stage.  Built in every
// block instead, the query is read once per block (hundreds of 256-KB
// CSR reads at config 4) and the sorted columns of a row collide on one
// shared word per warp: that took most of the call on the H100 (PERF.md
// §6).  The B fragment of a k32 step is one shared word per row: a
// nibble of it spread to four bytes by one multiply.
//
// Epilogues.  K1d: for each (row, slot) the thread owns, acc > 0 AND the
// branchless lex compare of txn_id[t] against before[b] AND the witness
// bit AND eligible; bool output as one 4-byte store of the thread's four
// slots, packed output as a nibble joined with the neighbour's (lane ^ 4)
// into one byte.  K2d: acc > 0 AND active[t], the lex max over the
// thread's four slots, then over the eight lanes that share the rows
// (three shuffle rounds), the four warps through shared memory, and a
// running max per block over its slot tiles.  Across blocks each block
// writes its rows' partials and a fold kernel, a block per row, takes
// their lex max (a last-block fold as in K2 serialises up to 528 partials
// per row on one block's 4 warps, and cost K2d about 0.05 ms at config
// 4).  K1d and K2d read different matrices (live_T, key_T) and are two
// calls, as K1 and K2 are.
//
// Measured (PERF.md §6, H100 80GB HBM3 at 700 W): at config 4 K1d takes
// about 1.7x and K2d 2.0x the byte bound, and at one wide row over K = 512
// 2.3x and 2.7x: the index streams at 1.4-1.9 TB/s, not 3.35, whichever
// the row tile (16 or 64 rows), so neither the products nor the fragment
// shuffling alone set the pace (where it goes is not measured).
// __launch_bounds__(128, 4) caps registers at 128; ptxas reports no spill
// for K1d and about 30 bytes for the 64-row K2d.
//
// Every entry point launches on the caller's stream (one memset node, the
// query kernel, the product kernel and, for K2d with several blocks per
// row tile, the fold kernel) and allocates nothing: scratch holds the
// query bits (and K2d's partials).  It returns the CUDA
// error of its device query, attribute call or memset if one fails,
// cudaErrorInvalidValue for T % 16 != 0, an index not 16-byte aligned or a
// K whose query tile does not fit shared memory, else cudaGetLastError()
// after its launches (0 = success).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileT = 32 * kWarps;              // slots per tile, 32 per warp
constexpr int kChunkK = 64;                      // keys per pipeline stage
constexpr int kSteps = kChunkK / 32;             // k32 steps per stage
constexpr int kStages = 3;
constexpr int kStageBytes = kChunkK * kTileT;    // [64 keys][128 slots] u8
constexpr int kBlocksPerSM = 4;                  // persistent grid target
constexpr int kQueryThreads = 256;               // the query kernel's blocks

enum Mode { kDeps = 0, kMax = 1 };

// the swizzle of key row r's 16-byte chunks inside a stage (bits 1-2 of
// the chunk index from bits 2-3 of the row): the fragment loads of one
// instruction (rows 4c + j, words 8w + g) then fall on 32 banks
__device__ __forceinline__ int swizzle(int r) { return ((r >> 2) & 3) << 1; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;                  // 0: zero-fill, no read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x32 u8, row) * b (32x8 u8, col)
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// r[j] = bytes (slot 0..3) of key row j  ->  a[i] = bytes (key 0..3) of slot i
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&a)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  a[0] = __byte_perm(t0, t1, 0x5410);
  a[1] = __byte_perm(t0, t1, 0x7632);
  a[2] = __byte_perm(t2, t3, 0x5410);
  a[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// qbits[row * stride + (c >> 5)] |= 1 << (c & 31) for every column c of the
// CSR query (entries offsets[0] .. offsets[B] of cols; a thread per entry
// of the n_cols the caller passed), qbits zeroed before.
__global__ void __launch_bounds__(kQueryThreads)
query_bits_kernel(const int32_t* __restrict__ offsets,
                  const int32_t* __restrict__ cols, int B, int K, int n_cols,
                  int stride, uint32_t* __restrict__ qbits) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kQueryThreads + threadIdx.x;
  const int lo = __ldg(offsets);
  const int hi = __ldg(offsets + B);
  int word = -1;
  uint32_t bits = 0;
  if (j < n_cols && j >= lo && j < hi) {
    const int c = __ldg(cols + j);
    const int w = c < 0 ? c + K : c;             // wrapped once, as in JAX
    if (w >= 0 && w < K) {
      int r0 = 0, r1 = B;                        // offsets[r0] <= j < offsets[r1]
      while (r1 - r0 > 1) {
        const int mid = (r0 + r1) >> 1;
        if (__ldg(offsets + mid) <= j) r0 = mid; else r1 = mid;
      }
      word = r0 * stride + (w >> 5);
      bits = 1u << (w & 31);
    }
  }
  // OR along runs of lanes with the same word; only bits of equal words
  // ever meet, so any order of columns is right, sorted ones cheap
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int nw = __shfl_up_sync(kFull, word, d);
    const uint32_t nb = __shfl_up_sync(kFull, bits, d);
    if (lane >= d && nw == word) bits |= nb;
  }
  const int next = __shfl_down_sync(kFull, word, 1);
  if (word >= 0 && (lane == 31 || next != word)) atomicOr(qbits + word, bits);
}

// Grid: x = row tiles of 8*NT query rows, y = persistent blocks walking
// the slot tiles y, y + gridDim.y, ...  T % 16 == 0 and a 16-byte aligned
// index (dense_launch refuses others), so every 16-byte piece of a stage
// lies wholly inside or wholly past T.
// qbits: the query bits of all row tiles, [gridDim.x * 8 * NT][stride].
// partial (kMax, gridDim.y > 1): [B, gridDim.y, 5] int32 for fold_kernel.
template <int kMode, int NT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
dense_kernel(const uint8_t* __restrict__ inc,      // [K, T]
             const int32_t* __restrict__ ts,       // [T, 5]  (K2d)
             const int32_t* __restrict__ txn_id,   // [T, 5]
             const int8_t* __restrict__ kind,      // [T]     (K1d)
             const int8_t* __restrict__ status,    // [T]     (K1d)
             const uint8_t* __restrict__ active,   // [T]
             const int32_t* __restrict__ before,   // [B, 5]  (K1d)
             const int8_t* __restrict__ qkind,     // [B]     (K1d)
             const uint32_t* __restrict__ qbits_all,  // see above
             unsigned long long wit_bits, int n_kinds, int invalidated,
             int B, int T, int K, int packed,
             int32_t* __restrict__ partial, void* __restrict__ out) {
  constexpr int kRowsT = 8 * NT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const stages = smem;
  uint32_t* const qbits = reinterpret_cast<uint32_t*>(smem + kStages * kStageBytes);
  __shared__ int32_t s_before[kRowsT][kLanes];
  __shared__ int32_t s_qkind[kRowsT];
  __shared__ int32_t s_part[kWarps][kRowsT][kLanes];
  __shared__ int32_t s_best[kRowsT][kLanes];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int n_chunks = max(1, (K + kChunkK - 1) / kChunkK);
  const int stride = (n_chunks * kSteps) | 1;    // query words per row
  const int n_tiles = (T + kTileT - 1) / kTileT;
  const int b0 = blockIdx.x * kRowsT;
  const int nrows = min(kRowsT, B - b0);
  const int my_tiles = (n_tiles - 1 - static_cast<int>(blockIdx.y)) /
                       static_cast<int>(gridDim.y) + 1;
  const int total = my_tiles * n_chunks;

  // stage `it` of this block's walk: key rows k0 .. k0+63 of slot tile
  // `tile`, zero-filled past K and T
  auto stage_load = [&](int it) {
    const int tile = blockIdx.y + (it / n_chunks) * gridDim.y;
    const int t0 = tile * kTileT;
    const int k0 = (it % n_chunks) * kChunkK;
    uint8_t* buf = stages + (it % kStages) * kStageBytes;
#pragma unroll
    for (int p = 0; p < kChunkK * 8 / kThreads; ++p) {   // 16-byte pieces
      const int q = tid + p * kThreads;
      const int r = q >> 3;
      const int ch = q & 7;
      const int k = k0 + r;
      const int t = t0 + ch * 16;
      uint8_t* dst = buf + r * kTileT + ((ch ^ swizzle(r)) << 4);
      const bool ok = k < K && t < T;
      cp_async16(dst, ok ? inc + static_cast<size_t>(k) * T + t : inc, ok);
    }
  };

  // the block's query bits ride with the first stage
  for (int i = tid; i < kRowsT * stride; i += kThreads) {
    cp_async4(qbits + i, qbits_all + static_cast<size_t>(b0) * stride + i);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) stage_load(s);
    cp_async_commit();
  }
  if constexpr (kMode == kDeps) {
    for (int i = tid; i < kRowsT * kLanes; i += kThreads) {
      const int r = i / kLanes;
      s_before[r][i % kLanes] =
          r < nrows ? __ldg(before + static_cast<size_t>(b0) * kLanes + i) : 0;
    }
    if (tid < kRowsT) {
      s_qkind[tid] = tid < nrows ? clamp_kind(__ldg(qkind + b0 + tid), n_kinds) : 0;
    }
  } else {
    for (int i = tid; i < kRowsT * kLanes; i += kThreads) (&s_best[0][0])[i] = 0;
  }

  int acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();                // stage `it` has landed
    __syncthreads();                             // ... for every thread; and
    if (it + kStages - 1 < total) stage_load(it + kStages - 1);  // its
    cp_async_commit();                           // buffer of it-1 is free
    const uint8_t* buf = stages + (it % kStages) * kStageBytes;
    const int chunk = it % n_chunks;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int qw = chunk * kSteps + ks;        // query word of this step
      uint32_t q[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) q[n] = qbits[(8 * n + g) * stride + qw];
      uint32_t lo[4], hi[4];
      {
        uint32_t r[4];
        const int word = ((g & 3) << 2);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = ks * 32 + 4 * c + j;
          r[j] = *reinterpret_cast<const uint32_t*>(
              buf + row * kTileT + (((2 * warp + (g >> 2)) ^ swizzle(row)) << 4) + word);
        }
        transpose4x4(r, lo);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = ks * 32 + 16 + 4 * c + j;
          r[j] = *reinterpret_cast<const uint32_t*>(
              buf + row * kTileT + (((2 * warp + (g >> 2)) ^ swizzle(row)) << 4) + word);
        }
        transpose4x4(r, hi);
      }
      // m16 tile 0: rows g, g+8 = slots 4g, 4g+1; tile 1: slots 4g+2, 4g+3
      const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};
      const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t b0f = nibble_bytes(q[n] >> (4 * c));
        const uint32_t b1f = nibble_bytes(q[n] >> (16 + 4 * c));
        mma_u8(acc[0][n], a0, b0f, b1f);
        mma_u8(acc[1][n], a1, b0f, b1f);
      }
    }
    if (chunk != n_chunks - 1) continue;

    // the epilogue of slot tile `tile`: this thread's slots s0 .. s0+3 and
    // query rows 8n + 2c + {0, 1}; (slot i, row e) sits in
    // acc[i / 2][n][2 * (i % 2) + e]
    const int tile = blockIdx.y + (it / n_chunks) * gridDim.y;
    const int s0 = tile * kTileT + 32 * warp + 4 * g;
    if constexpr (kMode == kDeps) {
      const uint64_t wit_by_kind = transpose8(wit_bits);   // byte k: column k
      int32_t lanes[4][kLanes];
      uint32_t wit[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = s0 + i;
        const bool v = t < T;
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          lanes[i][l] = v ? __ldg(txn_id + static_cast<size_t>(t) * kLanes + l) : 0;
        }
        const bool live = v && __ldg(active + t) != 0 &&
                          __ldg(status + t) != invalidated;
        const int k = v ? clamp_kind(__ldg(kind + t), n_kinds) : 0;
        wit[i] = live ? static_cast<uint32_t>((wit_by_kind >> (8 * k)) & 0xFFu) : 0u;
      }
      uint8_t* out8 = static_cast<uint8_t*>(out);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * n + 2 * c + e;
          uint32_t bits = 0;
          if (row < nrows) {
            const int qk = s_qkind[row];
            int32_t bound[kLanes];
#pragma unroll
            for (int l = 0; l < kLanes; ++l) bound[l] = s_before[row][l];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const bool dep = acc[i >> 1][n][2 * (i & 1) + e] > 0 &&
                               ((wit[i] >> qk) & 1u) && lex_less(lanes[i], bound);
              bits |= static_cast<uint32_t>(dep) << i;
            }
          }
          const size_t b = static_cast<size_t>(b0 + row);
          if (packed) {
            const uint32_t high = __shfl_xor_sync(kFull, bits, 4);   // slots +4
            if (row < nrows && (g & 1) == 0 && s0 < T) {
              out8[b * (T / 8) + s0 / 8] = static_cast<uint8_t>(bits | (high << 4));
            }
          } else if (row < nrows && s0 < T) {
            *reinterpret_cast<uint32_t*>(out8 + b * T + s0) = nibble_bytes(bits);
          }
        }
      }
    } else {
      int32_t vals[4][kLanes];
      uint32_t act = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = s0 + i;
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
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * n + 2 * c + e;
          int32_t mine[kLanes] = {-1, -1, -1, -1, -1};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            take_max(mine, vals[i],
                     acc[i >> 1][n][2 * (i & 1) + e] > 0 && ((act >> i) & 1u));
          }
          // over the eight lanes that hold the same rows (same c)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            int32_t other[kLanes];
#pragma unroll
            for (int l = 0; l < kLanes; ++l) {
              other[l] = __shfl_xor_sync(kFull, mine[l], off);
            }
            take_max(mine, other);
          }
          if (g == 0 && row < nrows) {
#pragma unroll
            for (int l = 0; l < kLanes; ++l) s_part[warp][row][l] = mine[l];
          }
        }
      }
      __syncthreads();
      if (tid < nrows) {
        int32_t best[kLanes];
#pragma unroll
        for (int l = 0; l < kLanes; ++l) best[l] = s_best[tid][l];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) take_max(best, s_part[w][tid]);
#pragma unroll
        for (int l = 0; l < kLanes; ++l) s_best[tid][l] = best[l];
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
  }
  cp_async_wait<0>();
  if constexpr (kMode == kMax) {
    __syncthreads();                             // s_best is final
    if (tid < nrows) {
      const size_t b = static_cast<size_t>(b0 + tid);
      int32_t* dst = gridDim.y == 1
          ? static_cast<int32_t*>(out) + b * kLanes
          : partial + (b * gridDim.y + blockIdx.y) * kLanes;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) dst[l] = s_best[tid][l];
    }
  }
}

struct DenseGeometry {
  dim3 grid;
  size_t smem;                                   // dynamic shared bytes
  int nt;                                        // n8 tiles of query rows
  int stride;                                    // query words per row
  long long qwords;                              // query bits in scratch
};

// NT = 2 (16 rows) for B <= 16, else 8 (64 rows); row tiles x persistent
// blocks, about kBlocksPerSM blocks on every SM in all.
cudaError_t dense_geometry(int B, int T, int K, DenseGeometry* g) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int nt = B <= 16 ? 2 : 8;
  const int row_tiles = (B + 8 * nt - 1) / (8 * nt);
  const int n_tiles = (T + kTileT - 1) / kTileT;
  const int per = max(1, kBlocksPerSM * sms / row_tiles);
  const int gy = min(min(n_tiles, per), 65535);
  const int n_chunks = max(1, (K + kChunkK - 1) / kChunkK);
  const int stride = (n_chunks * kSteps) | 1;
  const size_t smem = static_cast<size_t>(kStages) * kStageBytes +
                      static_cast<size_t>(8 * nt) * stride * sizeof(uint32_t);
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // the static arrays of the 64-row instantiation, at most
  constexpr size_t kStatic = sizeof(int32_t) * (64 * kLanes + 64 +
                                                kWarps * 64 * kLanes + 64 * kLanes) + 16;
  if (smem + kStatic > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  *g = DenseGeometry{dim3(row_tiles, gy), smem, nt, stride,
                     static_cast<long long>(row_tiles) * 8 * nt * stride};
  return cudaSuccess;
}

// scratch: the query bits, then (K2d, several blocks per row tile) the
// partials
long long scratch_ints(const DenseGeometry& g, int kMode, int B) {
  long long n = g.qwords;
  if (kMode == kMax && g.grid.y > 1) {
    n += static_cast<long long>(B) * g.grid.y * kLanes;
  }
  return n;
}

template <int kMode, int NT>
cudaError_t dense_run(const DenseGeometry& g, cudaStream_t s, const void* inc,
                      const void* ts, const void* txn_id, const void* kind,
                      const void* status, const void* active,
                      const void* before, const void* qkind,
                      unsigned long long wit_bits, int n_kinds,
                      int invalidated, int B, int T, int K, int packed,
                      void* scratch, void* out) {
  auto* kernel = dense_kernel<kMode, NT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  uint32_t* qbits = static_cast<uint32_t*>(scratch);
  kernel<<<g.grid, kThreads, g.smem, s>>>(
      static_cast<const uint8_t*>(inc), static_cast<const int32_t*>(ts),
      static_cast<const int32_t*>(txn_id), static_cast<const int8_t*>(kind),
      static_cast<const int8_t*>(status), static_cast<const uint8_t*>(active),
      static_cast<const int32_t*>(before), static_cast<const int8_t*>(qkind),
      qbits, wit_bits, n_kinds, invalidated, B, T, K, packed,
      reinterpret_cast<int32_t*>(qbits + g.qwords), out);
  return cudaGetLastError();
}

// memset (query bits), the query kernel, the product kernel, the fold
template <int kMode>
cudaError_t dense_launch(int B, int T, int K, int n_cols, cudaStream_t s,
                         const void* inc, const void* ts, const void* txn_id,
                         const void* kind, const void* status,
                         const void* active, const void* offsets,
                         const void* cols, const void* before,
                         const void* qkind, unsigned long long wit_bits,
                         int n_kinds, int invalidated, int packed,
                         void* scratch, void* out) {
  if (T % 16 != 0 || (reinterpret_cast<uintptr_t>(inc) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  DenseGeometry g;
  cudaError_t err = dense_geometry(B, T, K, &g);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(scratch, 0, g.qwords * sizeof(uint32_t), s);
  if (err != cudaSuccess) return err;
  if (n_cols > 0) {
    query_bits_kernel<<<(n_cols + kQueryThreads - 1) / kQueryThreads,
                        kQueryThreads, 0, s>>>(
        static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(cols),
        B, K, n_cols, g.stride, static_cast<uint32_t*>(scratch));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto* run = g.nt == 2 ? dense_run<kMode, 2> : dense_run<kMode, 8>;
  err = run(g, s, inc, ts, txn_id, kind, status, active, before, qkind,
            wit_bits, n_kinds, invalidated, B, T, K, packed, scratch, out);
  if (err != cudaSuccess || kMode != kMax || g.grid.y == 1) return err;
  fold_kernel<<<B, kFoldThreads, 0, s>>>(
      static_cast<const int32_t*>(scratch) + g.qwords, g.grid.y,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 elements of scratch deps_join_dense_launch needs, or minus the
// CUDA error of a failed query
long long deps_join_dense_scratch_ints(int B, int T, int K) {
  DenseGeometry g;
  const cudaError_t err = dense_geometry(B, T, K, &g);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return scratch_ints(g, kDeps, B);
}

// K1d: the arguments of deps_join_launch (consult.cu), and n_cols (the
// length of cols) and scratch
int deps_join_dense_launch(const void* inc, const void* txn_id,
                           const void* kind, const void* status,
                           const void* active, const void* offsets,
                           const void* cols, const void* before,
                           const void* qkind, unsigned long long wit_bits,
                           int n_kinds, int invalidated, int B, int T, int K,
                           int n_cols, int packed, void* scratch, void* out,
                           void* stream) {
  return static_cast<int>(dense_launch<kDeps>(
      B, T, K, n_cols, static_cast<cudaStream_t>(stream), inc, nullptr,
      txn_id, kind, status, active, offsets, cols, before, qkind, wit_bits,
      n_kinds, invalidated, packed, scratch, out));
}

// int32 elements of scratch max_conflict_dense_launch needs, or minus the
// CUDA error of a failed query
long long max_conflict_dense_scratch_ints(int B, int T, int K) {
  DenseGeometry g;
  const cudaError_t err = dense_geometry(B, T, K, &g);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return scratch_ints(g, kMax, B);
}

// K2d: the arguments of max_conflict_launch (consult.cu), and n_cols
int max_conflict_dense_launch(const void* inc, const void* ts,
                              const void* txn_id, const void* active,
                              const void* offsets, const void* cols, int B,
                              int T, int K, int n_cols, void* scratch,
                              void* out, void* stream) {
  return static_cast<int>(dense_launch<kMax>(
      B, T, K, n_cols, static_cast<cudaStream_t>(stream), inc, ts, txn_id,
      nullptr, nullptr, active, offsets, cols, nullptr, nullptr, 0ULL, 0, 0,
      0, scratch, out));
}

}  // extern "C"
