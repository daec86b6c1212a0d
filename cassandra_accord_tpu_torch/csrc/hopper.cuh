// Hopper (sm_90a) building blocks shared by the dense consult kernels
// (dense_join.cu on the [K, T] index, dense_join_tk.cu on [T, K]): mbarrier
// waits that trap instead of hanging, 2-D TMA loads and the host's tensor
// maps (encoded by libcuda, cached per tensor), the shared-memory
// matrix descriptor of a K-major tile with the 128-byte swizzle, and the
// wgmma fences.
#pragma once

#include <dlfcn.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
               "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the phase of parity `parity` to complete; a wait of about ten
// seconds (a lost copy or arrival) traps, so a fault fails the launch
// instead of hanging the card
constexpr long long kHangCycles = 1LL << 34;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done = 0;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kHangCycles) {
      __trap();
    }
  }
}

// a box of the tensor map at coordinates (c0 = inner, c1 = outer) into
// shared memory at dst, completing on the mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the shared-memory matrix descriptor of a K-major tile of 128-byte rows
// with the 128-byte swizzle: start address, 8-row groups 1024 bytes apart
// (the leading offset is not read for this layout)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// the registers of each thread of the calling warpgroup, lowered or raised
// to R (every warp of the warpgroup executes it)
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(int32_t* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process has loaded (the CUDA
// runtime does), found once
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A [rows, cols] byte tensor (row pitch cols) as boxes of [box_rows][box_cols]
// with the 128-byte swizzle; out-of-range rows and columns read as zero.
// A map holds only the address, shape, strides and box, so the maps of
// the last few tensors are kept and a repeated call (the service's two
// index buffers, a reused scratch) encodes nothing: it cannot go stale.
struct MapKey {
  const void* base;
  long long rows, cols;
  int box_rows, box_cols;
};

constexpr int kMapCache = 16;

cudaError_t encode_map(CUtensorMap* map, const void* base, long long rows,
                       long long cols, int box_rows, int box_cols) {
  static std::mutex mu;
  static MapKey keys[kMapCache];
  static CUtensorMap maps[kMapCache];
  static int used = 0, next = 0;
  const MapKey key{base, rows, cols, box_rows, box_cols};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (std::memcmp(&keys[i], &key, sizeof key) == 0) {
      *map = maps[i];
      return cudaSuccess;
    }
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMapCache;
  used = used < kMapCache ? used + 1 : used;
  return cudaSuccess;
}

}  // namespace
