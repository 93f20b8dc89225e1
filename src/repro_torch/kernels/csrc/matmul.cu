// Tiled GEMM for Hopper (sm_90a): C(m,n) = A(m,k) @ B(k,n), row-major, f32 accumulate.
//
// Replaces: src/repro/kernels/matmul.py::matmul_pallas (body _matmul_kernel), the TPU
// kernel behind every Q/K/V/O, FFN and vocab projection that ops.matmul dispatches.
// It computes the same function: an f32 accumulator and one cast to the output type
// on the store.
//
// Bound on this card: at the served sizes every call is bandwidth-bound. The H100
// needs ~295 bf16 FLOP per byte of HBM traffic before the tensor cores are the limit;
// a decode GEMM (m <= 128) does 2*m FLOP per weight element (2 bytes), i.e. <= 128
// FLOP/byte. So the floor is the weight bytes over 3.35 TB/s (w_gate, 4096x14336 bf16:
// 117 MB, ~35 us).
//
// What the design does about it:
//   * Each CTA owns one (BM, BN) output tile and runs its own loop over k (no state
//     carried between CTAs, unlike the TPU's sequential k grid axis with VMEM scratch).
//   * Tiles stream through shared memory with a kStages-deep (3) cp.async ring, so several
//     16-byte loads per thread are in flight while the tensor cores work on an earlier
//     stage: that depth is what hides HBM latency when m is tiny and the CTA count is
//     small.
//   * Ragged m, n and k edges are masked (cp.async zero-fill, or scalar loads when a row
//     is not 16-byte aligned), which replaces the TPU kernel's padding copies.
//   * bf16 inputs use tensor cores via mma.sync m16n8k16 (bf16 x bf16 -> f32), fed by
//     ldmatrix from padded (bank-conflict-free) shared tiles.
//   * f32 inputs use a tiled SIMT FMA path in full f32 (no TF32), matching
//     preferred_element_type=f32 on the TPU.
// Not done yet (later PRs): wgmma, TMA, split-k for small-n decode, persistent tiles.
//
// Plain C interface, loaded with ctypes; every entry point returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kStages = 3;

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

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

// ---------------------------------------------------------------------------
// Tile geometry shared by the kernels and the host-side launch code.
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK>
struct Bf16Tile {
  static constexpr int WARPS_M = BM >= 64 ? 2 : 1;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int THREADS = 128;
  static constexpr int WTM = BM / WARPS_M;  // warp tile rows
  static constexpr int WTN = BN / WARPS_N;  // warp tile cols
  static constexpr int MT = WTM / 16;       // m16 MMA tiles per warp
  static constexpr int NT = WTN / 8;        // n8 MMA tiles per warp
  static constexpr int AS = BK + 8;         // padded smem row stride of A (elements)
  static constexpr int BS = BN + 8;         // padded smem row stride of B (elements)
  static constexpr int A_STAGE = BM * AS;
  static constexpr int B_STAGE = BK * BS;
  static constexpr int SMEM = kStages * (A_STAGE + B_STAGE) * 2;
  static_assert(WTM % 16 == 0, "warp tile rows must be a multiple of 16");
  static_assert(WTN % 16 == 0, "warp tile cols must be a multiple of 16");
  static_assert(BK % 16 == 0, "BK must be a multiple of 16");
};

template <int BM, int BN, int BK>
struct F32Tile {
  static constexpr int THREADS = 256;  // 16 x 16 threads
  static constexpr int TM = BM / 16;   // rows per thread
  static constexpr int TN = BN / 16;   // cols per thread
  static constexpr int SMEM = (BK * BM + BK * BN) * 4;
  static_assert(BM % 16 == 0 && BN % 16 == 0, "f32 tile must be a multiple of 16");
};

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK, bool VEC, typename OutT>
__global__ void __launch_bounds__(128)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, OutT* __restrict__ C,
                     int M, int N, int K, int order) {
  using T = Bf16Tile<BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + kStages * T::A_STAGE;

  const int tm = order == 0 ? blockIdx.y : blockIdx.x;
  const int tn = order == 0 ? blockIdx.x : blockIdx.y;
  const int m0 = tm * BM, n0 = tn * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int ktiles = (K + BK - 1) / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* a_dst = sA + stage * T::A_STAGE;
    bf16* b_dst = sB + stage * T::B_STAGE;
    constexpr int A_CPR = BK / 8;  // 8-element chunks per A row
    for (int c = tid; c < BM * A_CPR; c += T::THREADS) {
      const int r = c / A_CPR, cc = (c % A_CPR) * 8;
      const int gm = m0 + r, gk = k0 + cc;
      bf16* dst = a_dst + r * T::AS + cc;
      if (VEC) {  // K % 8 == 0: a chunk is wholly inside or wholly outside
        const bool ok = gm < M && gk < K;
        cp_async16(dst, ok ? A + (size_t)gm * K + gk : A, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < M && gk + e < K) ? A[(size_t)gm * K + gk + e] : __float2bfloat16(0.f);
      }
    }
    constexpr int B_CPR = BN / 8;
    for (int c = tid; c < BK * B_CPR; c += T::THREADS) {
      const int r = c / B_CPR, cc = (c % B_CPR) * 8;
      const int gk = k0 + r, gn = n0 + cc;
      bf16* dst = b_dst + r * T::BS + cc;
      if (VEC) {  // N % 8 == 0
        const bool ok = gk < K && gn < N;
        cp_async16(dst, ok ? B + (size_t)gk * N + gn : B, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gn + e < N) ? B[(size_t)gk * N + gn + e] : __float2bfloat16(0.f);
      }
    }
  };

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();               // ... and everyone's; stage (kt-1) is free again
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, next);
    cp_async_commit();

    const bf16* a_s = sA + (kt % kStages) * T::A_STAGE;
    const bf16* b_s = sB + (kt % kStages) * T::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[T::MT][4];
      unsigned bfr[T::NT][2];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const int row = wm * T::WTM + i * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[i], a_s + row * T::AS + col);
      }
#pragma unroll
      for (int j = 0; j < T::NT; j += 2) {
        const int krow = kk + (lane & 15);
        const int col = wn * T::WTN + j * 8 + (lane >> 4) * 8;
        unsigned r[4];
        ldmatrix_x4_trans(r, b_s + krow * T::BS + col);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: the m16n8 accumulator layout puts (row g, cols 2t, 2t+1) in c0/c1 and
  // row g+8 in c2/c3, with g = lane / 4 and t = lane % 4.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const int row = m0 + wm * T::WTM + i * 16 + g;
      const int col = n0 + wn * T::WTN + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= M) continue;
        if (col < N) store_out(C + (size_t)r * N + col, acc[i][j][2 * h]);
        if (col + 1 < N) store_out(C + (size_t)r * N + col + 1, acc[i][j][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 SIMT kernel (full-precision FMA, no TF32)
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                    int M, int N, int K, int order) {
  using T = F32Tile<BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sA = reinterpret_cast<float*>(smem_raw);  // [BK][BM], transposed
  float* sB = sA + BK * BM;                        // [BK][BN]

  const int tm = order == 0 ? blockIdx.y : blockIdx.x;
  const int tn = order == 0 ? blockIdx.x : blockIdx.y;
  const int m0 = tm * BM, n0 = tn * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * BK; c += T::THREADS) {
      const int r = c / BK, kk = c % BK;  // consecutive threads read one row: coalesced
      const int gm = m0 + r, gk = k0 + kk;
      sA[kk * BM + r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int c = tid; c < BK * BN; c += T::THREADS) {
      const int kk = c / BN, cn = c % BN;
      const int gk = k0 + kk, gn = n0 + cn;
      sB[kk * BN + cn] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[T::TM], b[T::TN];
#pragma unroll
      for (int i = 0; i < T::TM; ++i) a[i] = sA[kk * BM + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < T::TN; ++j) b[j] = sB[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int cn = n0 + tx + 16 * j;
      if (cn < N) C[(size_t)r * N + cn] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// host-side launch
// ---------------------------------------------------------------------------
dim3 grid_for(int M, int N, int BM, int BN, int order) {
  const unsigned gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  return order == 0 ? dim3(gn, gm) : dim3(gm, gn);
}

template <int BM, int BN, int BK, typename OutT>
cudaError_t run_bf16(const void* a, const void* b, void* c, int M, int N, int K, int order,
                     cudaStream_t stream) {
  using T = Bf16Tile<BM, BN, BK>;
  typedef void (*Kernel)(const bf16*, const bf16*, OutT*, int, int, int, int);
  // 16-byte cp.async needs every row start 16-byte aligned: K % 8 for A, N % 8 for B.
  const bool vec = K % 8 == 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  Kernel kernel = vec ? &gemm_bf16_kernel<BM, BN, BK, true, OutT>
                      : &gemm_bf16_kernel<BM, BN, BK, false, OutT>;
  // Above 48 KB a kernel may use dynamic shared memory only after opting in.
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(M, N, BM, BN, order), T::THREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<OutT*>(c), M, N, K,
      order);
  return cudaGetLastError();
}

template <int BM, int BN, int BK>
cudaError_t run_f32(const void* a, const void* b, void* c, int M, int N, int K, int order,
                    cudaStream_t stream) {
  using T = F32Tile<BM, BN, BK>;
  typedef void (*Kernel)(const float*, const float*, float*, int, int, int, int);
  Kernel kernel = &gemm_f32_kernel<BM, BN, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(M, N, BM, BN, order), T::THREADS, T::SMEM, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), M, N,
      K, order);
  return cudaGetLastError();
}

}  // namespace

// The compiled (BM, BN, BK) tiles. The Python side (kernels/matmul.py::_TILES) lists
// the same set and checks it against repro_matmul_tiles() when the library loads.
#define REPRO_MATMUL_TILES(X) \
  X(16, 64, 128)              \
  X(16, 128, 64)              \
  X(32, 64, 64)               \
  X(64, 128, 32)              \
  X(128, 128, 32)

extern "C" {

// Writes (bm, bn, bk, bf16 smem bytes, f32 smem bytes) per compiled tile; returns the count.
int repro_matmul_tiles(int* out, int cap) {
  int n = 0;
#define X(bm, bn, bk)                                  \
  if (n < cap) {                                       \
    out[5 * n + 0] = bm;                               \
    out[5 * n + 1] = bn;                               \
    out[5 * n + 2] = bk;                               \
    out[5 * n + 3] = Bf16Tile<bm, bn, bk>::SMEM;       \
    out[5 * n + 4] = F32Tile<bm, bn, bk>::SMEM;        \
  }                                                    \
  ++n;
  REPRO_MATMUL_TILES(X)
#undef X
  return n;
}

// bf16 inputs; out_f32 selects an f32 (else bf16) output. order 0 = "mnk" (n tiles on
// blockIdx.x), 1 = "nmk" (m tiles on blockIdx.x).
int repro_matmul_bf16(int bm, int bn, int bk, int order, int out_f32, const void* a,
                      const void* b, void* c, int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define X(bm_, bn_, bk_)                                                               \
  if (bm == bm_ && bn == bn_ && bk == bk_)                                             \
    return out_f32 ? (int)run_bf16<bm_, bn_, bk_, float>(a, b, c, M, N, K, order, s)   \
                   : (int)run_bf16<bm_, bn_, bk_, bf16>(a, b, c, M, N, K, order, s);
  REPRO_MATMUL_TILES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// f32 inputs and output.
int repro_matmul_f32(int bm, int bn, int bk, int order, const void* a, const void* b, void* c,
                     int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define X(bm_, bn_, bk_) \
  if (bm == bm_ && bn == bn_ && bk == bk_) return (int)run_f32<bm_, bn_, bk_>(a, b, c, M, N, K, order, s);
  REPRO_MATMUL_TILES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
