// Hopper building blocks shared by csrc/matmul.cu, csrc/attention.cu and csrc/wkv.cu: PTX
// wrappers for cp.async, ldmatrix, mma.sync, mbarriers, named barriers, 2^x, TMA loads and
// wgmma, and the host-side encode of bf16 TMA tensor maps (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint, so a library needs no -lcuda), cached by everything a map
// depends on.
//
// Each source includes this once; everything here has internal linkage, so the shared
// libraries keep separate copies (and separate map caches and encode counts).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <unordered_map>

namespace {

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination without reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mbarriers (shared::cta) -----------------------------------------------------
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 2-D TMA box into shared memory; completion counts bytes on ``bar``.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// One 3-D TMA box into shared memory; completion counts bytes on ``bar``.
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Named barrier over the first ``n`` threads of the block (id 1; id 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// Named barriers by id: bar_sync waits until ``n`` threads have arrived (itself included);
// bar_arrive counts this thread and goes on.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error ~2^-22, 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of 16-byte chunk ``chunk`` of row ``row`` in a box of 128-byte rows under
// the TMA's 128-byte swizzle (the chunk index XOR the row within its 8-row atom).
__device__ __forceinline__ unsigned swz128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma -------------------------------------------------------------------------
// Shared-memory matrix descriptor: start address, leading and stride byte offsets (16-byte
// units) and the swizzle mode (1 = 128B, 2 = 64B).
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo, unsigned sbo,
                                               uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a wgmma fence/wait.
template <int NF>
__device__ __forceinline__ void fence_acc(float (&d)[NF][4]) {
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[f][e])::"memory");
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map depends on nothing but these fields, so a cached map is never stale.
struct MapKey {
  uintptr_t ptr;
  uint64_t dims[3];
  uint32_t box[3], rank, swizzle;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rank == o.rank && swizzle == o.swizzle && dims[0] == o.dims[0] &&
           dims[1] == o.dims[1] && dims[2] == o.dims[2] && box[0] == o.box[0] && box[1] == o.box[1] &&
           box[2] == o.box[2];
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = k.ptr * 0x9E3779B97F4A7C15ull;
    h ^= ((k.dims[0] * 31 + k.dims[1]) * 31 + k.dims[2]) * 0xC2B2AE3D27D4EB4Full;
    h ^= ((uint64_t)k.box[0] << 40) ^ ((uint64_t)k.box[1] << 20) ^ ((uint64_t)k.box[2] << 8) ^
         (k.rank << 4) ^ k.swizzle;
    return static_cast<size_t>(h ^ (h >> 29));
  }
};

constexpr size_t kMapCacheCap = 4096;  // activations bring new pointers: bound the cache
std::mutex g_map_mu;
std::unordered_map<MapKey, CUtensorMap, MapKeyHash> g_maps;
std::atomic<long long> g_map_encodes{0};

// A contiguous bf16 tensor of ``rank`` (2 or 3) dims, innermost first, cut into ``box``
// boxes (innermost first) swizzled by ``swizzle`` bytes (128, 64, 32, or 0: none). Boxes
// that cross an edge of the tensor are zero-filled there.
cudaError_t tensor_map(CUtensorMap* out, const void* ptr, uint32_t rank, const uint64_t (&dims)[3],
                       const uint32_t (&box)[3], uint32_t swizzle) {
  const MapKey key{reinterpret_cast<uintptr_t>(ptr),
                   {dims[0], rank > 1 ? dims[1] : 0, rank > 2 ? dims[2] : 0},
                   {box[0], rank > 1 ? box[1] : 0, rank > 2 ? box[2] : 0},
                   rank, swizzle};
  {
    std::lock_guard<std::mutex> lock(g_map_mu);
    auto it = g_maps.find(key);
    if (it != g_maps.end()) {
      *out = it->second;
      return cudaSuccess;
    }
  }
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t gdims[3] = {dims[0], dims[1], dims[2]};
  const cuuint64_t strides[2] = {dims[0] * sizeof(__nv_bfloat16), dims[0] * dims[1] * sizeof(__nv_bfloat16)};
  const cuuint32_t gbox[3] = {box[0], box[1], box[2]};
  const cuuint32_t estride[3] = {1, 1, 1};
  CUtensorMap map;
  auto run = [&] {
    return encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gdims, strides, gbox,
                  estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                  : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                  : swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                  : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = run();
  if (r == CUDA_ERROR_INVALID_CONTEXT) {
    // cuTensorMapEncodeTiled needs a current context, and a thread whose first CUDA work is this
    // encode has none (autograd's device thread, when a backward's first op is a GEMM that
    // reads its operands in place): bind the device's primary context, then encode again.
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess || cudaFree(nullptr) != cudaSuccess)
      return cudaErrorInvalidValue;
    r = run();
  }
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  g_map_encodes.fetch_add(1, std::memory_order_relaxed);
  std::lock_guard<std::mutex> lock(g_map_mu);
  if (g_maps.size() >= kMapCacheCap) g_maps.clear();
  g_maps.emplace(key, map);
  *out = map;
  return cudaSuccess;
}

// Opts a kernel in to its dynamic shared memory once per device (above 48 KB a kernel
// may use it only after cudaFuncSetAttribute).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace
