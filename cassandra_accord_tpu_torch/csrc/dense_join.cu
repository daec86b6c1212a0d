// The dense form of the dependency consult on the [K, T] index for Hopper
// (sm_90a): kernels K1d deps_join_dense and K2d max_conflict_dense, the
// key-overlap product on the int8 tensor cores through a TMA ring and
// wgmma with the index as the register operand.
//
// K1d computes what K1 (consult.cu) computes, and replaces the same TPU
// kernel, cassandra_accord_tpu/ops/pallas_join.py::_join_kernel, in its
// own form: a [B, K] x [K, T] product with the predicate in the epilogue,
//
//   out[b, t] = (sum_k q[b, k] * inc[k, t] > 0)
//             & ts_less(txn_id[t], before[b])
//             & WITNESSES[qkind[b], kind[t]]
//             & active[t] & (status[t] != INVALIDATED)
//
// as bool [B, T] or bit-packed [B, T/8] (bit i of byte j = slot 8j + i).
// K2d computes what K2 computes (the XLA max half of the reference's
// consult, device_service/kernel.py:55-59): per row, the lexicographic max
// of per_slot[t] = ts_less(ts[t], txn_id[t]) ? txn_id[t] : ts[t] over
// {t : product > 0 & active[t]}, zero lanes for none.  The arguments are
// K1's and K2's: the service's [K, T] uint8 index (T contiguous, any
// nonzero byte a member), the CSR query (offsets [B+1], cols [N];
// duplicates legal, entries past offsets[B] never read, a column in
// [-K, -1] names column c + K and any other outside [0, K) is dropped),
// lanes, kinds (read as common.cuh's clamp_kind reads them), status,
// active.
//
// Why a dense form.  The CSR kernels OR the incidence rows each query row
// names, so a batch re-reads nnz*T index bytes: 4.3 GB for 64 rows of
// 1,024 keys at T = 65,536, against 134 MB for the whole index.  Here the
// index streams from HBM once per call for up to 256 query rows, and the
// overlap is an int8 matrix product, so the bound is K*T bytes (0.040 ms
// at that shape on an H100 at 3.35 TB/s); the product, 2*B*K*T int8
// operations (17 G there, 8.7 us at 1,979 TOP/s), meets the byte bound
// only at 256 rows.  ops/_kernels.py::join_form sends a call here when its
// rows name many keys each.
//
// Design.
// - The query.  A first kernel writes the CSR query as 0/1 bytes into
//   scratch, [row tiles * N rows][Kq] with Kq = K rounded up to 128: a
//   thread per column wraps a negative column once, drops one outside
//   [0, K), finds its row by binary search in offsets and stores a 1 (so
//   300 duplicates of a key are one 1, and nothing wraps).  Each key goes
//   to its position in the stage's fragment order (kt_key_pos, below).
// - The index by TMA: a 2-D tensor map over [K, T] (T % 16 == 0 and a
//   16-byte aligned base, the map's row pitch), boxes of [128 keys][128
//   slots] with the 128-byte swizzle, zero past K and T; the query's map,
//   boxes of [N rows][128 keys].  The maps are built on the host by
//   cuTensorMapEncodeTiled and kept per tensor (hopper.cuh), so the
//   service's two index buffers and the reused scratch encode once.
// - A ring of 3 to 8 stages, each S slots x 128 keys of the index and N x
//   128 of the query, filled by one lane of a producer warpgroup on "full"
//   mbarriers (expect_tx of the stage's bytes) once both consumer
//   warpgroups have released the stage on its "empty" one.  The producer
//   warpgroup gives its registers to the consumers (setmaxnreg: 40 and
//   232 of the 168 a thread of a 384-thread block starts with), so that 2
//   x 64 accumulators, a stage's fragments and the pass fit unspilled.
// - The layout trap.  int8 wgmma reads B only K-major from shared memory,
//   and the index stage is slot-major.  So the index is the A operand,
//   from registers: each thread loads four 32-bit words, four slots of
//   four key rows, and one 4x4 byte transpose (8 byte_perm) turns them
//   into its fragment of the m64nNk32 A tile (the mma.m16n8k32 layout per
//   warp: rows g, g + 8 of the warp's 16, keys 4c .. 4c + 3 and 16 + 4c ..
//   of the k32 step).  A thread's four slots are rows g and g + 8 of two
//   m64 tiles, so a warpgroup covers 128 slots with two products per k32
//   step.  The loads go through the TMA swizzle (kt_stage_offset), and
//   the key order of the query makes the lanes of each load meet 32
//   banks (common.cuh; tests/test_torch_dense.py checks both in Python).
//   The query is the B operand: K-major, 128-byte swizzle, the k32 steps
//   32 bytes apart inside the swizzle atom.
// - One pass for up to 256 rows: N = 16, 64 or 128 rows (by B) with the
//   two warpgroups on the two 128-slot halves of a 256-slot stage; N = 256
//   with both on the same 128 slots, each on 128 of the rows, so that a
//   thread holds at most 2 x 64 accumulators.  More rows: row tiles of 256
//   side by side in the grid, their index reads meeting in L2.  A short
//   index (fewer slot tiles than half the SMs) takes narrower passes, so
//   that more SMs share the call.
// - A persistent grid: one block per SM, each walking slot tiles y, y +
//   gridDim.y, ...; the producer runs ahead into the next tile while the
//   consumers finish one.
// - Epilogues: the accumulators' "> 0" bytes go to shared memory ([N][S +
//   4]), beside the tile's slot data (the lanes and the witness byte; K2d:
//   the lanes of max(ts, txn_id) and the active bit).  Then each warp takes
//   rows b = warp, warp + 8, ... and each lane four consecutive slots.  The
//   pass of one tile runs in shares between the next tile's stages, after
//   each stage is released, so the producer keeps streaming.  A row that
//   shares no key with the warp's slots (K2d: no active one) skips its
//   compares.  K1d: the predicate, then one 4-byte
//   store of the lane's four bools (a warp writes 128 contiguous bytes of
//   a row) or one byte per two lanes packed.  K2d: the lane's masked lex
//   max, the warp's (__reduce_max_sync lane by lane), and a running max
//   per row in shared memory; after its last tile a block writes its rows'
//   maxima, or its partials for the fold kernel (common.cuh) where several
//   blocks share a row tile.
// u8 x u8 -> s32: index bytes are 0..255 and query bytes 0/1, so a sum is
// >= 0 and > 0 iff some product is, and stays below 2^31 (K <= 16,384).
//
// Measured (PERF.md §6, H100 80GB HBM3 at 700 W, cold L2 after a 128 MB
// write, tools_torch/kt_compare.py): at config 4 K1d 0.075 ms and K2d
// 0.077, 56 % and 53 % of the byte bound; at the wide row 0.029 and 0.031;
// at shape A's 256 rows 0.068 and 0.091, against the 64-row kernel's
// 0.076 and 0.119.  Built without the predicate pass the kernel takes
// 0.063 ms at config 4 (a plain read of the index, torch.amax, takes
// 0.060 by the same method: tools_torch/tk_probes.py) and 0.038 at shape
// A, and without the products 0.066 and 0.051: with one block an SM, the
// products and the per-tile pass are not hidden under the stream.  ptxas:
// 168 registers a thread at launch and no spill at any N.
//
// Every entry point launches on the caller's stream (a memset node, the
// query kernel, the product kernel and, for K2d with several blocks per
// row tile, the fold kernel) and allocates nothing: scratch holds the
// query bytes (and K2d's partials).  It returns cudaErrorInvalidValue for
// K < 1, T % 16 != 0, a misaligned index or a tensor map libcuda
// refuses, cudaErrorSharedObjectSymbolNotFound when libcuda's
// cuTensorMapEncodeTiled cannot be found, the error of a failed device
// query, attribute call or memset, else cudaGetLastError() after its
// launches (0 = success).

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kThreads = kConsumers + 128;       // and a producer warpgroup
constexpr int kKeys = 128;                       // keys a stage
constexpr int kBox = 128;                        // slots an index box
constexpr int kMaxStages = 8;
constexpr int kOvPad = 4;                        // bytes after each s_ov row
constexpr int kQueryThreads = 256;               // the query kernel's blocks

enum Mode { kDeps = 0, kMax = 1 };

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// d[64 x N] (+)= a[64 x 32] * b[32 x N], u8 x u8 -> s32: A from registers
// (per warp the mma.m16n8k32 fragment of its 16 rows: a[0] row g, keys
// 4c .. 4c + 3; a[1] row g + 8; a[2], a[3] the same rows, keys 16 + 4c ..),
// B K-major in shared memory; scale_d == 0 starts the sum afresh.  The
// accumulator of thread (warp w of the warpgroup, lane l), register
// 4j + 2h + e, is row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
template <int N>
__device__ __forceinline__ void wgmma_ru8(int32_t* d, const uint32_t (&a)[4],
                                          uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ru8<16>(int32_t* d, const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ru8<64>(int32_t* d, const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ru8<128>(int32_t* d, const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
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

// out[i] = the keys at fragment positions 32 ks + 16 h + 4 c .. + 3 of slot
// sl + i of an index box (the thread's four slots)
__device__ __forceinline__ void kt_fragment(const uint8_t* box, int ks, int h,
                                            int c, int sl, uint32_t (&out)[4]) {
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = kt_key_row(32 * ks + 16 * h + 4 * c + j);
    r[j] = *reinterpret_cast<const uint32_t*>(box + kt_stage_offset(row, sl));
  }
  transpose4x4(r, out);
}

// The shape of one instantiation: N query rows a tile, S slots a stage.
template <int N>
struct KtShape {
  static constexpr bool kSplit = N > 128;          // warpgroups split the rows
  static constexpr int kNw = kSplit ? N / 2 : N;   // rows of one wgmma
  static constexpr int kSlots = kSplit ? kBox : 2 * kBox;
  static constexpr int kAcc = kNw / 2;             // registers of one wgmma
  static constexpr int kOvStride = kSlots + kOvPad;
  // a stage: the index boxes [128 keys][128 slots], then the query box
  // [N rows][128 keys]
  static constexpr int kStage = (kSlots + N) * kKeys;
};

// the shared memory after the ring: s_ov [N][S + 4] bytes, s_slot [6][S],
// s_before [N][5], s_qkind [N], s_best [N][5] int32, then the full and
// empty barriers
__host__ __device__ constexpr size_t tail_bytes(int n, int slots) {
  return round16(static_cast<size_t>(n) * (slots + kOvPad)) +
         sizeof(int32_t) * (kLanes + 1) * slots +
         round16(sizeof(int32_t) * n * (2 * kLanes + 1)) +
         2 * kMaxStages * sizeof(uint64_t);
}

// q[row * kq + position of key c] = 1 for every column c of the CSR query
// (entries offsets[0] .. offsets[B] of cols; a thread per entry of the
// n_cols the caller passed), q zeroed before
__global__ void __launch_bounds__(kQueryThreads)
query_bytes_kernel(const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ cols, int B, int K, int n_cols,
                   long long kq, uint8_t* __restrict__ q) {
  const int j = blockIdx.x * kQueryThreads + threadIdx.x;
  if (j >= n_cols || j < __ldg(offsets) || j >= __ldg(offsets + B)) return;
  const int c = __ldg(cols + j);
  const int w = c < 0 ? c + K : c;               // wrapped once, as in JAX
  if (w < 0 || w >= K) return;
  int r0 = 0, r1 = B;                            // offsets[r0] <= j < offsets[r1]
  while (r1 - r0 > 1) {
    const int mid = (r0 + r1) >> 1;
    if (__ldg(offsets + mid) <= j) r0 = mid; else r1 = mid;
  }
  q[r0 * kq + (w & ~(kKeys - 1)) + kt_key_pos(w & (kKeys - 1))] = 1;
}

// Grid: x = row tiles of N query rows, y = persistent blocks walking the
// slot tiles y, y + gridDim.y, ...  partial (K2d, gridDim.y > 1): [B,
// gridDim.y, 5] int32 for fold_kernel.
template <int kMode, int N>
__global__ void __launch_bounds__(kThreads, 1)
kt_kernel(const __grid_constant__ CUtensorMap imap,   // [K, T] u8
          const __grid_constant__ CUtensorMap qmap,   // [rows, Kq] u8
          const int32_t* __restrict__ ts,             // [T, 5]  (K2d)
          const int32_t* __restrict__ txn_id,         // [T, 5]
          const int8_t* __restrict__ kind,            // [T]     (K1d)
          const int8_t* __restrict__ status,          // [T]     (K1d)
          const uint8_t* __restrict__ active,         // [T]
          const int32_t* __restrict__ before,         // [B, 5]  (K1d)
          const int8_t* __restrict__ qkind,           // [B]     (K1d)
          unsigned long long wit_bits, int n_kinds, int invalidated, int B,
          int T, int K, int packed, int stages,
          int32_t* __restrict__ partial, void* __restrict__ out) {
  using Sh = KtShape<N>;
  constexpr int kS = Sh::kSlots;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms must sit on 1024-byte boundaries
  uint8_t* const smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* const ov = smem + static_cast<size_t>(stages) * Sh::kStage;
  int32_t* const s_slot =
      reinterpret_cast<int32_t*>(ov + round16(static_cast<size_t>(N) * Sh::kOvStride));
  int32_t* const s_before = s_slot + (kLanes + 1) * kS;
  int32_t* const s_qkind = s_before + N * kLanes;
  int32_t* const s_best = s_qkind + N;
  const uint32_t full0 = smem_addr(ov + tail_bytes(N, kS) - 2 * kMaxStages * sizeof(uint64_t));
  const uint32_t empty0 = full0 + kMaxStages * sizeof(uint64_t);
  const uint32_t ring0 = smem_addr(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nk = (K + kKeys - 1) / kKeys;
  const int n_tiles = (T + kS - 1) / kS;
  const int b0 = blockIdx.x * N;
  const int nrows = min(N, B - b0);
  const int my_tiles = (n_tiles - 1 - static_cast<int>(blockIdx.y)) /
                       static_cast<int>(gridDim.y) + 1;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);                // the producer's expect_tx
      mbar_init(empty0 + 8 * s, kConsumers / 32); // a lane of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < N * kLanes; i += kThreads) {
    s_before[i] = kMode == kDeps && i / kLanes < nrows
        ? __ldg(before + static_cast<size_t>(b0) * kLanes + i) : 0;
    s_best[i] = 0;
  }
  for (int i = tid; i < N; i += kThreads) {
    s_qkind[i] = kMode == kDeps && i < nrows
        ? clamp_kind(__ldg(qkind + b0 + i), n_kinds) : 0;
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {                  // the producer warpgroup
    // gives its registers to the consumers: 128 x 40 + 256 x 232 fit the
    // SM's 65,536, where the block's 384 threads start at 168 each
    setmaxnreg_dec<40>();
    if (warp == kConsumers / 32 && lane == 0) {
      const int total = my_tiles * nk;
      for (int it = 0; it < total; ++it) {
        const int s = it % stages;
        mbar_wait(empty0 + 8 * s, ((it / stages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, Sh::kStage);
        const int tile = blockIdx.y + (it / nk) * gridDim.y;
        const int k0 = (it % nk) * kKeys;
        const uint32_t dst = ring0 + s * Sh::kStage;
#pragma unroll
        for (int h = 0; h < kS / kBox; ++h) {
          tma_load(dst + h * kBox * kKeys, &imap, tile * kS + h * kBox, k0,
                   full0 + 8 * s);
        }
        tma_load(dst + kS * kKeys, &qmap, k0, b0, full0 + 8 * s);
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes the index box at slot0 of a stage
  // and the query rows from row0; a thread, slots sl .. sl + 3 of the box
  setmaxnreg_inc<232>();
  const int wg = warp >> 2;
  const int wl = warp & 3;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int slot0 = Sh::kSplit ? 0 : wg * kBox;
  const int row0 = Sh::kSplit ? wg * Sh::kNw : 0;
  const int sl = 32 * wl + 4 * g;
  int32_t acc[2][Sh::kAcc];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < Sh::kAcc; ++i) acc[m][i] = 0;
  const uint64_t wit_by_kind = transpose8(wit_bits);   // byte k: column k
  uint8_t* const out8 = static_cast<uint8_t*>(out);

  // The predicate pass of a tile runs while the next tile's stages
  // stream in: its overlap bytes wait in s_ov and its slot data in s_slot
  // (six words per slot, word-major: K1d the five lanes and the witness
  // byte, 0 where the slot is not eligible; K2d the five lanes of the
  // slot's max(ts, txn_id) and whether it is active), and each stage's
  // consumers take a share of the pass's items after releasing the stage.
  // This warp's items: rows warp, warp + 8, ... (rows_w of them) of each
  // 128-slot group, a lane's four slots at a time.
  const int rows_w = nrows > warp ? (nrows - warp + 7) / 8 : 0;
  const int n_items = (kS / 128) * rows_w;
  int pend = -1;                                 // the tile pending in s_ov
  int done = 0;                                  // its items done here
  auto run_items = [&](int upto) {
    for (; done < upto; ++done) {
      const int gq = done / rows_w;
      const int row = warp + 8 * (done - gq * rows_w);
      const int i0 = gq * 128 + 4 * lane;        // the lane's slots in the tile
      const int s0 = pend * kS + i0;
      const uint32_t o = *reinterpret_cast<const uint32_t*>(
          ov + row * Sh::kOvStride + i0);
      const uint4 extra = *reinterpret_cast<const uint4*>(s_slot + kLanes * kS + i0);
      const uint32_t flags[4] = {extra.x, extra.y, extra.z, extra.w};
      uint32_t cand = 0;
      const int qk = kMode == kDeps ? s_qkind[row] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool f = kMode == kDeps ? ((flags[i] >> qk) & 1u) != 0 : flags[i] != 0;
        cand |= static_cast<uint32_t>(((o >> (8 * i)) & 0xFFu) != 0 && f) << i;
      }
      const bool any = __any_sync(kFull, cand != 0);
      int32_t v[4][kLanes];
      if (any) {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          const int4 w = *reinterpret_cast<const int4*>(s_slot + l * kS + i0);
          v[0][l] = w.x;
          v[1][l] = w.y;
          v[2][l] = w.z;
          v[3][l] = w.w;
        }
      }
      if constexpr (kMode == kDeps) {
        uint32_t bits = 0;
        if (any) {
          int32_t bound[kLanes];
#pragma unroll
          for (int l = 0; l < kLanes; ++l) bound[l] = s_before[row * kLanes + l];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            bits |= static_cast<uint32_t>(((cand >> i) & 1u) &&
                                          lex_less(v[i], bound)) << i;
          }
        }
        const size_t b = static_cast<size_t>(b0 + row);
        if (packed) {
          const uint32_t high = __shfl_xor_sync(kFull, bits, 1);   // slots +4
          if ((lane & 1) == 0 && s0 < T) {
            out8[b * (T / 8) + s0 / 8] = static_cast<uint8_t>(bits | (high << 4));
          }
        } else if (s0 < T) {
          *reinterpret_cast<uint32_t*>(out8 + b * T + s0) = nibble_bytes(bits);
        }
      } else if (any) {
        int32_t mine[kLanes] = {-1, -1, -1, -1, -1};
#pragma unroll
        for (int i = 0; i < 4; ++i) take_max(mine, v[i], (cand >> i) & 1u);
        int32_t best[kLanes];
        warp_lex_max(mine, best);
        if (lane == 0) take_max(s_best + row * kLanes, best);   // row's warp
      }
    }
  };

  int it = 0;
  for (int j = 0; j < my_tiles; ++j) {
    const int tile = blockIdx.y + j * gridDim.y;
    const int share = (n_items + nk - 1) / nk;   // pending items a stage
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % stages;
      mbar_wait(full0 + 8 * s, (it / stages) & 1);
      const uint8_t* box = smem + static_cast<size_t>(s) * Sh::kStage + slot0 * kKeys;
      const uint32_t q0 = ring0 + s * Sh::kStage + (kS + row0) * kKeys;
      // the stage's A fragments: k32 step, m64 tile (slots sl + 2m, + 1)
      uint32_t a[kKeys / 32][2][4];
#pragma unroll
      for (int ks = 0; ks < kKeys / 32; ++ks) {
        uint32_t lo[4], hi[4];
        kt_fragment(box, ks, 0, c, sl, lo);
        kt_fragment(box, ks, 1, c, sl, hi);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[ks][m][0] = lo[2 * m];
          a[ks][m][1] = lo[2 * m + 1];
          a[ks][m][2] = hi[2 * m];
          a[ks][m][3] = hi[2 * m + 1];
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) fence_regs<Sh::kAcc>(acc[m]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKeys / 32; ++ks) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          wgmma_ru8<Sh::kNw>(acc[m], a[ks][m], sw128_desc(q0 + ks * 32),
                             (kc | ks) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int m = 0; m < 2; ++m) fence_regs<Sh::kAcc>(acc[m]);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);   // this warp is done
      if (pend >= 0) run_items(min(n_items, (kc + 1) * share));
    }
    if (pend >= 0) run_items(n_items);
    consumers_sync();                            // s_ov and s_slot are free

    // the tile's overlap as bytes: s_ov[row][slot] = product > 0; the
    // thread's rows row0 + 8jn + 2c + e, its slots sl + 2m + h
#pragma unroll
    for (int jn = 0; jn < Sh::kNw / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t w = 0;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            w |= static_cast<uint32_t>(acc[m][4 * jn + 2 * h + e] > 0)
                 << (8 * (2 * m + h));
          }
        }
        const int row = row0 + 8 * jn + 2 * c + e;
        *reinterpret_cast<uint32_t*>(ov + row * Sh::kOvStride + slot0 + sl) = w;
      }
    }
    // and its slot data
    for (int i = tid; i < kS; i += kConsumers) {
      const int t = tile * kS + i;
      const bool v = t < T;
      int32_t id[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        id[l] = v ? __ldg(txn_id + static_cast<size_t>(t) * kLanes + l) : 0;
      }
      if constexpr (kMode == kDeps) {
        const bool live = v && __ldg(active + t) != 0 &&
                          __ldg(status + t) != invalidated;
        const int k = v ? clamp_kind(__ldg(kind + t), n_kinds) : 0;
#pragma unroll
        for (int l = 0; l < kLanes; ++l) s_slot[l * kS + i] = id[l];
        s_slot[kLanes * kS + i] =
            live ? static_cast<int32_t>((wit_by_kind >> (8 * k)) & 0xFFu) : 0;
      } else {
        int32_t e[kLanes];
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          e[l] = v ? __ldg(ts + static_cast<size_t>(t) * kLanes + l) : 0;
        }
        const bool use_id = lex_less(e, id);
#pragma unroll
        for (int l = 0; l < kLanes; ++l) s_slot[l * kS + i] = use_id ? id[l] : e[l];
        s_slot[kLanes * kS + i] = v && __ldg(active + t) != 0;
      }
    }
    consumers_sync();                            // both are in place
    pend = tile;
    done = 0;
  }
  if (pend >= 0) run_items(n_items);
  if constexpr (kMode == kMax) {
    consumers_sync();                            // s_best is final
    for (int r = tid; r < nrows; r += kConsumers) {
      const size_t b = static_cast<size_t>(b0 + r);
      int32_t* dst = gridDim.y == 1
          ? static_cast<int32_t*>(out) + b * kLanes
          : partial + (b * gridDim.y + blockIdx.y) * kLanes;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) dst[l] = s_best[r * kLanes + l];
    }
  }
}

struct KtGeometry {
  dim3 grid;
  size_t smem;                                   // dynamic shared bytes
  int n;                                         // query rows a tile
  int slots;                                     // slots a stage
  int stages;
  long long kq;                                  // query bytes a row
  long long qbytes;                              // query bytes in scratch
};

template <int N>
constexpr int kt_slots() { return KtShape<N>::kSlots; }

template <int N>
constexpr size_t kt_stage() { return KtShape<N>::kStage; }

// N = 16, 64, 128 or 256 rows by B (more rows: several row tiles of 256),
// fewer while the grid would leave more than half the SMs idle (a short
// index: its passes meet in L2); as many stages as shared memory holds, up
// to kMaxStages; row tiles x persistent blocks, about one block on every
// SM in all.
cudaError_t kt_geometry(int B, int T, int K, KtGeometry* g) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  int n = B <= 16 ? 16 : B <= 64 ? 64 : B <= 128 ? 128 : 256;
  for (;;) {
    const long long s = n > 128 ? kBox : 2 * kBox;
    const long long blocks = (B + n - 1) / n * ((T + s - 1) / s);
    if (n == 16 || 2 * blocks >= sms) break;
    n = n == 256 ? 128 : n == 128 ? 64 : 16;
  }
  const int slots = n == 16 ? kt_slots<16>() : n == 64 ? kt_slots<64>()
                  : n == 128 ? kt_slots<128>() : kt_slots<256>();
  const size_t stage = n == 16 ? kt_stage<16>() : n == 64 ? kt_stage<64>()
                     : n == 128 ? kt_stage<128>() : kt_stage<256>();
  const int row_tiles = (B + n - 1) / n;
  const int n_tiles = (T + slots - 1) / slots;
  const int gy = min(min(n_tiles, max(1, sms / row_tiles)), 65535);
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t fixed = tail_bytes(n, slots) + 1024;      // + the alignment
  if (static_cast<size_t>(optin) < fixed + 2 * stage) return cudaErrorInvalidValue;
  const size_t fit = (static_cast<size_t>(optin) - fixed) / stage;
  const int stages = fit < kMaxStages ? static_cast<int>(fit) : kMaxStages;
  const long long kq = (static_cast<long long>(K) + kKeys - 1) / kKeys * kKeys;
  *g = KtGeometry{dim3(row_tiles, gy), fixed + stages * stage, n, slots, stages,
                  kq, static_cast<long long>(row_tiles) * n * kq};
  return cudaSuccess;
}

// scratch: the query bytes, then (K2d, several blocks per row tile) the
// partials
long long scratch_ints(const KtGeometry& g, int kMode, int B) {
  long long n = g.qbytes / static_cast<long long>(sizeof(int32_t));
  if (kMode == kMax && g.grid.y > 1) {
    n += static_cast<long long>(B) * g.grid.y * kLanes;
  }
  return n;
}

template <int kMode, int N>
cudaError_t kt_run(const KtGeometry& g, cudaStream_t s, const CUtensorMap& imap,
                   const CUtensorMap& qmap, const void* ts, const void* txn_id,
                   const void* kind, const void* status, const void* active,
                   const void* before, const void* qkind,
                   unsigned long long wit_bits, int n_kinds, int invalidated,
                   int B, int T, int K, int packed, int32_t* partial,
                   void* out) {
  auto* kernel = kt_kernel<kMode, N>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  kernel<<<g.grid, kThreads, g.smem, s>>>(
      imap, qmap, static_cast<const int32_t*>(ts),
      static_cast<const int32_t*>(txn_id), static_cast<const int8_t*>(kind),
      static_cast<const int8_t*>(status), static_cast<const uint8_t*>(active),
      static_cast<const int32_t*>(before), static_cast<const int8_t*>(qkind),
      wit_bits, n_kinds, invalidated, B, T, K, packed, g.stages, partial, out);
  return cudaGetLastError();
}

// memset (query bytes), the query kernel, the tensor maps, the product
// kernel, the fold
template <int kMode>
cudaError_t dense_launch(int B, int T, int K, int n_cols, cudaStream_t s,
                         const void* inc, const void* ts, const void* txn_id,
                         const void* kind, const void* status,
                         const void* active, const void* offsets,
                         const void* cols, const void* before,
                         const void* qkind, unsigned long long wit_bits,
                         int n_kinds, int invalidated, int packed,
                         void* scratch, void* out) {
  if (K < 1 || T % 16 != 0 || (reinterpret_cast<uintptr_t>(inc) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  KtGeometry g;
  cudaError_t err = kt_geometry(B, T, K, &g);
  if (err != cudaSuccess) return err;
  uint8_t* const q = static_cast<uint8_t*>(scratch);
  err = cudaMemsetAsync(q, 0, g.qbytes, s);
  if (err != cudaSuccess) return err;
  if (n_cols > 0) {
    query_bytes_kernel<<<(n_cols + kQueryThreads - 1) / kQueryThreads,
                         kQueryThreads, 0, s>>>(
        static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(cols),
        B, K, n_cols, g.kq, q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  CUtensorMap imap, qmap;
  err = encode_map(&imap, inc, K, T, kKeys, kBox);
  if (err != cudaSuccess) return err;
  err = encode_map(&qmap, q, static_cast<long long>(g.grid.x) * g.n, g.kq, g.n,
                   kKeys);
  if (err != cudaSuccess) return err;
  int32_t* const partial = reinterpret_cast<int32_t*>(q + g.qbytes);
  auto* run = g.n == 16 ? kt_run<kMode, 16>
            : g.n == 64 ? kt_run<kMode, 64>
            : g.n == 128 ? kt_run<kMode, 128> : kt_run<kMode, 256>;
  err = run(g, s, imap, qmap, ts, txn_id, kind, status, active, before, qkind,
            wit_bits, n_kinds, invalidated, B, T, K, packed, partial, out);
  if (err != cudaSuccess || kMode != kMax || g.grid.y == 1) return err;
  fold_kernel<<<B, kFoldThreads, 0, s>>>(partial, g.grid.y,
                                         static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 elements of scratch deps_join_dense_launch needs, or minus the
// CUDA error of a failed query
long long deps_join_dense_scratch_ints(int B, int T, int K) {
  KtGeometry g;
  const cudaError_t err = kt_geometry(B, T, K, &g);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return scratch_ints(g, kDeps, B);
}

// K1d: the arguments of deps_join_launch (consult.cu) but vals, and n_cols
// (the length of cols) and scratch
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
  KtGeometry g;
  const cudaError_t err = kt_geometry(B, T, K, &g);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return scratch_ints(g, kMax, B);
}

// K2d: the arguments of max_conflict_launch (consult.cu) but vals, and
// n_cols
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
