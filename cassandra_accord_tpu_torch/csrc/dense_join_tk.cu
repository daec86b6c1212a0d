// The dense form of the dependency consult on the index as it lies, [T, K]
// (K contiguous), for Hopper (sm_90a): kernels K1d deps_join_dense_tk and
// K2d max_conflict_dense_tk, the key-overlap product on the int8 tensor
// cores through a TMA ring and wgmma.
//
// K1d computes what the TPU join kernel computes
// (cassandra_accord_tpu/ops/pallas_join.py::_join_kernel), on its own
// operand layout: the [B, K] query against the [T, K] index, contracting
// dimension 1 of both, with the predicate in the epilogue,
//
//   out[b, t] = (sum_k q[b, k] * inc[t, k] > 0)
//             & ts_less(txn_id[t], before[b])
//             & WITNESSES[qkind[b], kind[t]]
//             & active[t] & (status[t] != INVALIDATED)
//
// as bool [B, T] or bit-packed [B, T/8] (bit i of byte j = slot 8j + i).
// K2d computes the consult's max half (the reference's XLA code beside the
// join, device_service/kernel.py:55-59): per row, the lexicographic max of
// per_slot[t] = ts_less(ts[t], txn_id[t]) ? txn_id[t] : ts[t] over
// {t : product > 0 & active[t]}, zero lanes for none.  Inputs as the
// one-shot callers hold them (ops/deps_kernels.py): the index [T, K] and
// the query [B, K] as int8 values, the reference's operands (it sums their
// bf16 products in f32 and tests > 0; s8 x s8 sums them exactly in int32,
// |sum| <= 2^14 * K < 2^31 for the K <= 16,384 the wrapper takes, so the
// two agree wherever the reference's f32 sum is exact), lanes [*, 5]
// int32, kinds and statuses int8, active bool.  No transpose of the index
// and no CSR query: the callers' [T, K] -> [K, T] copy and their nonzero
// read-back go.
//
// Bound.  The index is read once per tile of up to 256 query rows, so a
// call moves K*T bytes (134 MB at BASELINE config 4, T = 65,536, K = 2,048:
// 0.040 ms at 3.35 TB/s), while the product, 2*B*K*T int8 operations (17 G
// at config 4, 8.7 us at 1,979 TOP/s), stays below it up to B ~ 256.
//
// Design.  int8 wgmma takes both operands K-major from shared memory, which
// is how the index and the query lie, so a stage is copied as it lies:
// - A ring of stages in shared memory, each [S slots][128 keys] of the index
//   and [N rows][128 keys] of the query, 128 bytes a row with the 128-byte
//   swizzle, filled by the Tensor Memory Accelerator from two 2-D tensor
//   maps (built on the host by cuTensorMapEncodeTiled and kept per tensor,
//   hopper.cuh; passed as __grid_constant__ parameters, so a CUDA graph
//   captures them with the launch).  The maps clip the T and K tails and the query rows past B
//   with zeros: T is free, K needs only K % 16 == 0 (the 16-byte row
//   stride) and both bases 16-byte alignment.
// - One producer warp: one lane issues both copies of a stage on its
//   "full" mbarrier (expect_tx of the stage's bytes) once the stage's
//   "empty" mbarrier says both consumers are done with it.
// - Two consumer warpgroups, each owning half of a stage's slots: per k32
//   step one wgmma.mma_async m64nNk32.s32.s8.s8 for each 64 slots and each
//   128 rows, both descriptors K-major with the 128-byte swizzle (8-row
//   groups 1024 bytes apart; the k32 steps advance the start address by 32
//   bytes inside the swizzle atom).  N = 16, 64, 128 or 256 (two n128
//   products) query rows by B; S = 256 slots a stage (N <= 128) or 128
//   (N = 256), so that a thread holds at most 128 accumulators.
// - A persistent grid: one block per SM (shared memory holds 3 to 6
//   stages), the row tiles of one slot tile neighbours in the grid, each
//   block walking slot tiles y, y + gridDim.y, ...; its producer runs ahead
//   into the next tile while the consumers finish one.
// - Epilogue per slot tile: the accumulators' "> 0" bytes go to shared
//   memory ([N][S + 4], the padding spreads a warp's stores over 8 banks);
//   then each warp takes query rows b = warp, warp + 8, ... and each lane
//   four consecutive slots, whose lanes, kind and status it loaded once per
//   tile.  K1d: the predicate, then one 4-byte store of the lane's four
//   bools (a warp writes 128 contiguous bytes of a row) or one byte per two
//   lanes packed.  K2d: the lane's masked lex max, the warp's
//   (__reduce_max_sync lane by lane), and a running max per row in shared
//   memory; after its last tile a block writes its rows' maxima, or its
//   partials for the fold kernel (common.cuh) where several blocks share a
//   row tile.
//
// Measured (PERF.md §6, H100 80GB HBM3 at 700 W, cold L2 after a 128 MB
// write): at config 4 K1d 0.072 ms and K2d 0.077, 58 % and 53 % of the byte
// bound (1.9 TB/s of index); at the wide row 0.029 and 0.030, 37 % and 36 %,
// where a plain read of the same 33.5 MB (torch.amax) takes 0.023 ms after
// the same flush.  Built with the products removed, the kernel is 3-5 %
// faster at config 4 and the wide row (19 % at 256 query rows), and with
// 128 slots a stage 3 % slower (tools_torch/tk_probes.py): the stream, not
// the products or the epilogue, sets the pace below 256 rows.  K2d pays
// the fold's second launch over K1d.
//
// Every entry point launches on the caller's stream (the product kernel,
// and K2d's fold where gridDim.y > 1) and allocates nothing.  It returns
// cudaErrorInvalidValue for K % 16 != 0, K < 16, a misaligned base or a
// tensor map the driver refuses, cudaErrorSharedObjectSymbolNotFound when
// the driver's cuTensorMapEncodeTiled cannot be found, the error of a
// failed device query or attribute call, else cudaGetLastError() after its
// launches (0 = success).

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kTkThreads = kConsumers + 32;      // and the producer warp
constexpr int kKeyBox = 128;                     // keys (bytes) a stage row
constexpr int kMaxStages = 8;
constexpr int kOvPad = 4;                        // bytes after each s_ov row

enum TkMode { kTkDeps = 0, kTkMax = 1 };

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// d[64 x N] (+)= a[64 x 32] * b[32 x N], s8 x s8 -> s32, both operands
// K-major in shared memory; scale_d == 0 starts the sum afresh.  The
// accumulator of thread (warp w of the warpgroup, lane l), register
// 4j + 2h + e, is row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
template <int N>
__device__ __forceinline__ void wgmma_s8(int32_t* d, uint64_t a, uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int32_t* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int32_t* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int32_t* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The shape of one instantiation: N query rows a tile, S slots a stage.
template <int N>
struct TkShape {
  static constexpr int kMsub = N <= 128 ? 2 : 1;    // m64 tiles a warpgroup
  static constexpr int kSlots = 2 * 64 * kMsub;     // S
  static constexpr int kNw = N <= 128 ? N : 128;    // columns of one wgmma
  static constexpr int kNsub = N / kNw;             // wgmmas across the rows
  static constexpr int kAcc = kNw / 2;              // registers of one wgmma
  static constexpr int kOvStride = kSlots + kOvPad;
  // a stage: the index box [S][128 keys], then the query box [N][128 keys]
  static constexpr int kStage = (kSlots + N) * kKeyBox;
};

// the shared memory after the ring: s_ov [N][S + 4] bytes, s_before [N][5],
// s_qkind [N], s_best [N][5] int32, then the full and empty barriers
__host__ __device__ constexpr size_t tail_bytes(int n, int slots) {
  return round16(static_cast<size_t>(n) * (slots + kOvPad)) +
         round16(sizeof(int32_t) * n * (2 * kLanes + 1)) +
         2 * kMaxStages * sizeof(uint64_t);
}

// Grid: x = row tiles of N query rows, y = persistent blocks walking the
// slot tiles y, y + gridDim.y, ...  partial (K2d, gridDim.y > 1): [B,
// gridDim.y, 5] int32 for fold_kernel.
template <int kMode, int N>
__global__ void __launch_bounds__(kTkThreads, 1)
tk_kernel(const __grid_constant__ CUtensorMap imap,   // [T, K] s8
          const __grid_constant__ CUtensorMap qmap,   // [B, K] s8
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
  using Sh = TkShape<N>;
  constexpr int kS = Sh::kSlots;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms must sit on 1024-byte boundaries
  uint8_t* const smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* const ov = smem + static_cast<size_t>(stages) * Sh::kStage;
  int32_t* const s_before =
      reinterpret_cast<int32_t*>(ov + round16(static_cast<size_t>(N) * Sh::kOvStride));
  int32_t* const s_qkind = s_before + N * kLanes;
  int32_t* const s_best = s_qkind + N;
  const uint32_t full0 = smem_addr(ov + tail_bytes(N, kS) - 2 * kMaxStages * sizeof(uint64_t));
  const uint32_t empty0 = full0 + kMaxStages * sizeof(uint64_t);
  const uint32_t ring0 = smem_addr(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nk = (K + kKeyBox - 1) / kKeyBox;
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
  for (int i = tid; i < N * kLanes; i += kTkThreads) {
    s_before[i] = kMode == kTkDeps && i / kLanes < nrows
        ? __ldg(before + static_cast<size_t>(b0) * kLanes + i) : 0;
    s_best[i] = 0;
  }
  for (int i = tid; i < N; i += kTkThreads) {
    s_qkind[i] = kMode == kTkDeps && i < nrows
        ? clamp_kind(__ldg(qkind + b0 + i), n_kinds) : 0;
  }
  __syncthreads();

  if (warp == kConsumers / 32) {                  // the producer
    if (lane == 0) {
      const int total = my_tiles * nk;
      for (int it = 0; it < total; ++it) {
        const int s = it % stages;
        mbar_wait(empty0 + 8 * s, ((it / stages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, Sh::kStage);
        const int tile = blockIdx.y + (it / nk) * gridDim.y;
        const int k0 = (it % nk) * kKeyBox;
        const uint32_t dst = ring0 + s * Sh::kStage;
        tma_load(dst, &imap, k0, tile * kS, full0 + 8 * s);
        tma_load(dst + kS * kKeyBox, &qmap, k0, b0, full0 + 8 * s);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns slots wg*S/2 .. of each stage
  const int wg = warp >> 2;
  const int wl = warp & 3;
  int32_t acc[Sh::kMsub][Sh::kNsub][Sh::kAcc];
#pragma unroll
  for (int m = 0; m < Sh::kMsub; ++m)
#pragma unroll
    for (int n = 0; n < Sh::kNsub; ++n)
#pragma unroll
      for (int i = 0; i < Sh::kAcc; ++i) acc[m][n][i] = 0;
  const uint64_t wit_by_kind = transpose8(wit_bits);   // byte k: column k
  uint8_t* const out8 = static_cast<uint8_t*>(out);
  int it = 0;
  for (int j = 0; j < my_tiles; ++j) {
    const int tile = blockIdx.y + j * gridDim.y;
    for (int c = 0; c < nk; ++c, ++it) {
      const int s = it % stages;
      mbar_wait(full0 + 8 * s, (it / stages) & 1);
      const uint32_t a0 = ring0 + s * Sh::kStage + wg * Sh::kMsub * 64 * kKeyBox;
      const uint32_t q0 = ring0 + s * Sh::kStage + kS * kKeyBox;
#pragma unroll
      for (int m = 0; m < Sh::kMsub; ++m)
#pragma unroll
        for (int n = 0; n < Sh::kNsub; ++n) fence_regs<Sh::kAcc>(acc[m][n]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKeyBox / 32; ++ks) {
#pragma unroll
        for (int m = 0; m < Sh::kMsub; ++m) {
#pragma unroll
          for (int n = 0; n < Sh::kNsub; ++n) {
            wgmma_s8<Sh::kNw>(acc[m][n], sw128_desc(a0 + m * 64 * kKeyBox + ks * 32),
                              sw128_desc(q0 + n * Sh::kNw * kKeyBox + ks * 32),
                              (c | ks) != 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int m = 0; m < Sh::kMsub; ++m)
#pragma unroll
        for (int n = 0; n < Sh::kNsub; ++n) fence_regs<Sh::kAcc>(acc[m][n]);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);   // this warp is done
    }

    // the tile's overlap as bytes: s_ov[row][slot] = product > 0
#pragma unroll
    for (int m = 0; m < Sh::kMsub; ++m) {
#pragma unroll
      for (int n = 0; n < Sh::kNsub; ++n) {
#pragma unroll
        for (int i = 0; i < Sh::kAcc; ++i) {
          const int slot = (wg * Sh::kMsub + m) * 64 + 16 * wl + (lane >> 2) +
                           8 * ((i >> 1) & 1);
          const int row = n * Sh::kNw + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          ov[row * Sh::kOvStride + slot] = acc[m][n][i] > 0 ? 1 : 0;
        }
      }
    }
    consumers_sync();

    // rows warp, warp + 8, ...; lane: slots s0 .. s0 + 3 of each 128
#pragma unroll
    for (int g = 0; g < kS / 128; ++g) {
      const int s0 = tile * kS + g * 128 + 4 * lane;
      if constexpr (kMode == kTkDeps) {
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
        for (int row = warp; row < nrows; row += kConsumers / 32) {
          const uint32_t o = *reinterpret_cast<const uint32_t*>(
              ov + row * Sh::kOvStride + g * 128 + 4 * lane);
          const int qk = s_qkind[row];
          int32_t bound[kLanes];
#pragma unroll
          for (int l = 0; l < kLanes; ++l) bound[l] = s_before[row * kLanes + l];
          uint32_t bits = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool dep = ((o >> (8 * i)) & 0xFFu) != 0 &&
                             ((wit[i] >> qk) & 1u) && lex_less(lanes[i], bound);
            bits |= static_cast<uint32_t>(dep) << i;
          }
          const size_t b = static_cast<size_t>(b0 + row);
          if (packed) {
            const uint32_t high = __shfl_xor_sync(kFull, bits, 1);   // slots +4
            if ((lane & 1) == 0 && s0 < T) {
              out8[b * (T / 8) + s0 / 8] = static_cast<uint8_t>(bits | (high << 4));
            }
          } else if ((T & 3) == 0 && s0 < T) {
            *reinterpret_cast<uint32_t*>(out8 + b * T + s0) = nibble_bytes(bits);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (s0 + i < T) out8[b * T + s0 + i] = (bits >> i) & 1u;
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
        for (int row = warp; row < nrows; row += kConsumers / 32) {
          const uint32_t o = *reinterpret_cast<const uint32_t*>(
              ov + row * Sh::kOvStride + g * 128 + 4 * lane);
          int32_t mine[kLanes] = {-1, -1, -1, -1, -1};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            take_max(mine, vals[i],
                     ((o >> (8 * i)) & 0xFFu) != 0 && ((act >> i) & 1u));
          }
          int32_t best[kLanes];
          warp_lex_max(mine, best);
          if (lane == 0) take_max(s_best + row * kLanes, best);   // row's warp
        }
      }
    }
    consumers_sync();                            // s_ov free for the next tile
  }
  if constexpr (kMode == kTkMax) {
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

struct TkGeometry {
  dim3 grid;
  size_t smem;                                   // dynamic shared bytes
  int n;                                         // query rows a tile
  int slots;                                     // slots a stage
  int stages;
};

// N = 16, 64, 128 or 256 rows by B (more rows: several row tiles of 256);
// as many stages as shared memory holds, up to kMaxStages; row tiles x
// persistent blocks, about one block on every SM in all.
template <int N>
constexpr int tk_slots() { return TkShape<N>::kSlots; }

template <int N>
constexpr size_t tk_stage() { return TkShape<N>::kStage; }

cudaError_t tk_geometry(int B, int T, TkGeometry* g) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int n = B <= 16 ? 16 : B <= 64 ? 64 : B <= 128 ? 128 : 256;
  const int slots = n == 16 ? tk_slots<16>() : n == 64 ? tk_slots<64>()
                  : n == 128 ? tk_slots<128>() : tk_slots<256>();
  const size_t stage = n == 16 ? tk_stage<16>() : n == 64 ? tk_stage<64>()
                     : n == 128 ? tk_stage<128>() : tk_stage<256>();
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
  *g = TkGeometry{dim3(row_tiles, gy), fixed + stages * stage, n, slots, stages};
  return cudaSuccess;
}

long long tk_scratch_ints(const TkGeometry& g, int kMode, int B) {
  return kMode == kTkMax && g.grid.y > 1
      ? static_cast<long long>(B) * g.grid.y * kLanes : 0;
}

template <int kMode, int N>
cudaError_t tk_run(const TkGeometry& g, cudaStream_t s, const CUtensorMap& imap,
                   const CUtensorMap& qmap, const void* ts, const void* txn_id,
                   const void* kind, const void* status, const void* active,
                   const void* before, const void* qkind,
                   unsigned long long wit_bits, int n_kinds, int invalidated,
                   int B, int T, int K, int packed, void* scratch, void* out) {
  auto* kernel = tk_kernel<kMode, N>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  kernel<<<g.grid, kTkThreads, g.smem, s>>>(
      imap, qmap, static_cast<const int32_t*>(ts),
      static_cast<const int32_t*>(txn_id), static_cast<const int8_t*>(kind),
      static_cast<const int8_t*>(status), static_cast<const uint8_t*>(active),
      static_cast<const int32_t*>(before), static_cast<const int8_t*>(qkind),
      wit_bits, n_kinds, invalidated, B, T, K, packed, g.stages,
      static_cast<int32_t*>(scratch), out);
  return cudaGetLastError();
}

// the tensor maps, the product kernel, the fold
template <int kMode>
cudaError_t tk_launch(int B, int T, int K, cudaStream_t s, const void* inc,
                      const void* query, const void* ts, const void* txn_id,
                      const void* kind, const void* status,
                      const void* active, const void* before,
                      const void* qkind, unsigned long long wit_bits,
                      int n_kinds, int invalidated, int packed, void* scratch,
                      void* out) {
  if (K < 16 || K % 16 != 0 || (reinterpret_cast<uintptr_t>(inc) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(query) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  TkGeometry g;
  cudaError_t err = tk_geometry(B, T, &g);
  if (err != cudaSuccess) return err;
  CUtensorMap imap, qmap;
  err = encode_map(&imap, inc, T, K, g.slots, kKeyBox);
  if (err != cudaSuccess) return err;
  err = encode_map(&qmap, query, B, K, g.n, kKeyBox);
  if (err != cudaSuccess) return err;
  auto* run = g.n == 16 ? tk_run<kMode, 16>
            : g.n == 64 ? tk_run<kMode, 64>
            : g.n == 128 ? tk_run<kMode, 128> : tk_run<kMode, 256>;
  err = run(g, s, imap, qmap, ts, txn_id, kind, status, active, before, qkind,
            wit_bits, n_kinds, invalidated, B, T, K, packed, scratch, out);
  if (err != cudaSuccess || kMode != kTkMax || g.grid.y == 1) return err;
  fold_kernel<<<B, kFoldThreads, 0, s>>>(static_cast<const int32_t*>(scratch),
                                         g.grid.y, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1d on [T, K]: inc [T, K] and query [B, K] int8 (the overlap is their
// product's sign), txn_id [T, 5], kind, status [T] int8, active [T] bool, before
// [B, 5], qkind [B] int8; out [B, T] bool or [B, T/8] uint8 (packed)
int deps_join_tk_launch(const void* inc, const void* query,
                        const void* txn_id, const void* kind,
                        const void* status, const void* active,
                        const void* before, const void* qkind,
                        unsigned long long wit_bits, int n_kinds,
                        int invalidated, int B, int T, int K, int packed,
                        void* out, void* stream) {
  return static_cast<int>(tk_launch<kTkDeps>(
      B, T, K, static_cast<cudaStream_t>(stream), inc, query, nullptr, txn_id,
      kind, status, active, before, qkind, wit_bits, n_kinds, invalidated,
      packed, nullptr, out));
}

// int32 elements of scratch max_conflict_tk_launch needs, or minus the
// CUDA error of a failed query
long long max_conflict_tk_scratch_ints(int B, int T) {
  TkGeometry g;
  const cudaError_t err = tk_geometry(B, T, &g);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return tk_scratch_ints(g, kTkMax, B);
}

// K2d on [T, K]: inc, query as K1d's, ts and txn_id [T, 5], active [T];
// out [B, 5] int32
int max_conflict_tk_launch(const void* inc, const void* query, const void* ts,
                           const void* txn_id, const void* active, int B,
                           int T, int K, void* scratch, void* out,
                           void* stream) {
  return static_cast<int>(tk_launch<kTkMax>(
      B, T, K, static_cast<cudaStream_t>(stream), inc, query, ts, txn_id,
      nullptr, nullptr, active, nullptr, nullptr, 0ULL, 0, 0, 0, scratch,
      out));
}

}  // extern "C"
