// Tiled GEMM for Hopper (sm_90a): C(m,n) = A(m,k) @ B(k,n), row-major, f32 accumulate.
//
// Replaces: src/repro/kernels/matmul.py::matmul_pallas (body _matmul_kernel), the TPU
// kernel behind every Q/K/V/O, FFN and vocab projection that ops.matmul dispatches.
// It computes the same function: an f32 accumulator and one cast to the output type
// on the store.
//
// Bound on this card: the H100 needs ~295 bf16 FLOP per byte of HBM traffic before the
// tensor cores are the limit. A GEMM does 2*m FLOP per weight element (2 bytes), so up
// to m ~ 150 rows the weight bytes over 3.35 TB/s bound it (w_gate, 4096x14336 bf16:
// 117 MB, ~35 us), and above that the 989 TFLOP/s of the tensor cores do.
//
// What the design does about it (the bf16 path):
//   * In-kernel split-k fills the card in one launch. At decode (m = 4) an (m, n) grid
//     of output tiles has as few as 1 CTA; the wrapper (kernels/matmul.py::split_k)
//     splits the k steps across blockIdx.z until the grid holds 64 CTAs, which stream
//     the weights as fast as more do here (scripts/split_sweep.py on the H100). Every
//     split writes its f32 partial tile to a workspace; the last CTA to reach a tile (a
//     per-tile counter, atomicAdd after __threadfence) sums the partials in split order,
//     so the result does not depend on which CTA came last, stores C and resets the
//     counter for the next call. No second kernel, no memset, no float atomics.
//   * A TMA ring fed by one producer warp. Tiles of A and B come in by
//     cp.async.bulk.tensor into a ring of 5-8 stages (as many as ~110 KB hold, so two
//     CTAs share an SM), each stage guarded by a full and an empty mbarrier. One thread
//     issues the copies; the consumer warps spend no instructions on addresses and no
//     block-wide barrier runs per k step. The boxes land 128-byte swizzled (64-byte for
//     a 32-wide A box), so the reads below are free of bank conflicts. Tensor maps are
//     encoded on the host (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so
//     the library needs no -lcuda) and cached by (pointer, dims, box): a weight's map is
//     encoded once. TMA zero-fills boxes that cross the m, n or k edge.
//   * 64- and 128-row tiles: one consumer warpgroup per 64 rows issues
//     wgmma.mma_async m64n128k16 (bf16 -> f32) with both operands in shared memory; B
//     is read MN-major (n contiguous, as it lies in memory), which wgmma allows for
//     16-bit types. Each stage is released after the next stage's wgmma group is issued.
//   * 16- and 32-row tiles keep mma.sync m16n8k16 fed by ldmatrix, now from the TMA
//     ring. At m <= 32 these tiles are bytes-bound and the tensor cores are not their
//     limit; wgmma would need Cᵀ = Bᵀ·Aᵀ with a transposed epilogue for no gain there.
//     These warps too release a stage one step late (see the consumer loop).
//   * Shapes TMA cannot take (a row stride that is not a multiple of 16 bytes, or an
//     unaligned base) run a 3-stage cp.async ring (scalar loads where a row is not
//     16-byte aligned) with the same split-k epilogue. The wrapper chooses the path
//     and counts its launches per path.
//   * f32 inputs use a tiled SIMT FMA path in full f32 (no TF32), matching
//     preferred_element_type=f32 on the TPU; it takes no split.
// Left for later: persistent tiles, clusters with TMA multicast, stages and warps as
// config axes, a TMA store epilogue.
//
// Plain C interface, loaded with ctypes; every entry point returns a cudaError_t.

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kStages = 3;             // cp.async ring depth of the fallback kernel
constexpr int kRingBudget = 110 * 1024;  // TMA ring bytes per CTA: two CTAs fit on one SM
constexpr int kMaxTmaStages = 8;

// wgmma (the PTX helpers, mbarriers, TMA and the wgmma fence are in hopper.cuh) --------
// D(64x128, f32) += A(64x16, K-major, smem) * B(16x128, MN-major, smem).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
        "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]),
        "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]),
        "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]),
        "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// Epilogue shared by every bf16 kernel. A consumer thread holds NF fragments of the
// m16n8 accumulator layout: fragment f covers (r0, c0), (r0, c0+1), (r0+8, c0),
// (r0+8, c0+1), with r0 = rows[f] and c0 = cols[f].
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(bf16* p, float a) { *p = __float2bfloat16(a); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename OutT>
__device__ __forceinline__ void store_frag(OutT* C, int M, int N, int r0, int c0, float4 v) {
  if (c0 >= N) return;
  const bool pair = c0 + 1 < N && (N & 1) == 0;  // an odd row length leaves pairs unaligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= M) continue;
    const float x = h ? v.z : v.x, y = h ? v.w : v.y;
    OutT* p = C + (size_t)r * N + c0;
    if (pair) {
      store2(p, x, y);
    } else {
      store1(p, x);
      if (c0 + 1 < N) store1(p + 1, y);
    }
  }
}

// With one split the tile is stored. Otherwise the partial goes to the workspace slot
// (tile, split) in fragment order (coalesced 16-byte stores), and the last CTA of the
// tile sums the slots in split order, stores C and resets the tile's counter.
template <int NF, int NC, typename OutT>
__device__ __forceinline__ void finish_tile(const float (&acc)[NF][4], const int (&rows)[NF],
                                            const int (&cols)[NF], OutT* C, int M, int N,
                                            int tile, float* ws, int* counters, int ctid,
                                            volatile int* flag) {
  const int splits = gridDim.z;
  if (splits == 1) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
      store_frag(C, M, N, rows[f], cols[f], make_float4(acc[f][0], acc[f][1], acc[f][2], acc[f][3]));
    return;
  }
  float4* tile_ws = reinterpret_cast<float4*>(ws) + (size_t)tile * splits * (NF * NC);
  float4* mine = tile_ws + (size_t)blockIdx.z * (NF * NC);
#pragma unroll
  for (int f = 0; f < NF; ++f)
    mine[f * NC + ctid] = make_float4(acc[f][0], acc[f][1], acc[f][2], acc[f][3]);
  __threadfence();  // this CTA's partial is visible device-wide before it is counted
  named_sync(NC);
  if (ctid == 0) *flag = atomicAdd(counters + tile, 1) == splits - 1;
  named_sync(NC);
  if (!*flag) return;
  __threadfence();  // acquire: every other split's partial is visible
  // Sum in split order, so the result is the same whichever CTA is last; U splits'
  // loads (at least 8 per thread) are issued before their adds, to overlap L2 latency.
  constexpr int U = NF >= 8 ? 1 : 8 / NF;
  float4 v[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) v[f] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < splits; s0 += U) {
    float4 p[U][NF];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int f = 0; f < NF; ++f)
        if (s0 + u < splits) p[u][f] = __ldcg(tile_ws + (size_t)(s0 + u) * (NF * NC) + f * NC + ctid);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int f = 0; f < NF; ++f)
        if (s0 + u < splits) {
          v[f].x += p[u][f].x; v[f].y += p[u][f].y; v[f].z += p[u][f].z; v[f].w += p[u][f].w;
        }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) store_frag(C, M, N, rows[f], cols[f], v[f]);
  if (ctid == 0) counters[tile] = 0;  // ready for the next call on this stream
}

// The k steps of this CTA's split: [kt0, kt0 + nk). Every split but the last has
// ceil(steps / splits) steps; kernels/matmul.py::split_k picks splits so none is empty.
__device__ __forceinline__ void split_range(int K, int BK, int& kt0, int& nk) {
  const int steps = (K + BK - 1) / BK;
  const int per = (steps + gridDim.z - 1) / gridDim.z;
  kt0 = blockIdx.z * per;
  nk = min(steps, kt0 + per) - kt0;
}

// Output tile of this CTA from blockIdx.x. The tiles are walked in bands of kBand
// along the order's fast axis (n for "mnk", so CTAs that share an A row-block run
// together; m for "nmk"): 132 CTAs in flight then touch ~8 blocks of one operand and
// ~17 of the other, which stay in the 50 MB L2, instead of sweeping a whole operand
// that does not fit once per tile row.
constexpr int kBand = 8;
__device__ __forceinline__ void tile_coords(int order, int gm, int gn, int& tm, int& tn) {
  const int fast_n = order == 0 ? gn : gm, slow_n = order == 0 ? gm : gn;
  const int pid = blockIdx.x;
  const int band = pid / (kBand * slow_n), within = pid % (kBand * slow_n);
  const int width = min(kBand, fast_n - band * kBand);
  const int fast = band * kBand + within % width, slow = within / width;
  tm = order == 0 ? slow : fast;
  tn = order == 0 ? fast : slow;
}

// ---------------------------------------------------------------------------
// Tile geometry shared by the kernels and the host-side launch code.
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK>
struct Bf16Tile {  // warp layout of the mma.sync kernels (TMA and cp.async)
  static constexpr int WARPS_M = BM >= 64 ? 2 : 1;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int THREADS = 128;
  static constexpr int WTM = BM / WARPS_M;  // warp tile rows
  static constexpr int WTN = BN / WARPS_N;  // warp tile cols
  static constexpr int MT = WTM / 16;       // m16 MMA tiles per warp
  static constexpr int NT = WTN / 8;        // n8 MMA tiles per warp
  static constexpr int AS = BK + 8;         // padded smem row stride of A (elements), cp.async path
  static constexpr int BS = BN + 8;         // padded smem row stride of B (elements), cp.async path
  static constexpr int A_STAGE = BM * AS;
  static constexpr int B_STAGE = BK * BS;
  static constexpr int SMEM = kStages * (A_STAGE + B_STAGE) * 2;
  static_assert(WTM % 16 == 0, "warp tile rows must be a multiple of 16");
  static_assert(WTN % 16 == 0, "warp tile cols must be a multiple of 16");
  static_assert(BK % 16 == 0, "BK must be a multiple of 16");
};

template <int BM, int BN, int BK>
struct TmaTile {
  static constexpr bool WGMMA = BM >= 64;
  static constexpr int AW = BK < 64 ? BK : 64;  // A box width in k (elements): one swizzle row
  static constexpr int A_SWIZZLE = AW * 2;      // bytes: 128, or 64 for a 32-wide box
  static constexpr int A_BOXES = BK / AW;
  static constexpr int A_BOX = BM * AW * 2;
  static constexpr int B_BOXES = BN / 64;  // B boxes are 64 n (128 bytes) wide
  static constexpr int B_BOX = BK * 128;
  static constexpr int A_BYTES = A_BOXES * A_BOX;
  static constexpr int STAGE = A_BYTES + B_BOXES * B_BOX;
  static constexpr int STAGES = kRingBudget / STAGE < kMaxTmaStages ? kRingBudget / STAGE : kMaxTmaStages;
  static constexpr int CONSUMERS = WGMMA ? (BM / 64) * 128 : 128;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  // 1 KB of alignment slack, the ring, a full and an empty barrier per stage, the flag.
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8 + 16;
  static_assert(BK % AW == 0 && (AW == 64 || AW == 32), "A box must be 32 or 64 wide");
  static_assert(BN % 64 == 0, "B tile must be whole 64-wide boxes");
  static_assert(STAGES >= 4, "the ring needs at least 4 stages");
  static_assert(!WGMMA || (BM % 64 == 0 && BN == 128), "wgmma tiles are 64k x 128");
  static_assert(WGMMA || AW == 64, "mma.sync tiles read 128-byte swizzled A rows");
};

template <int BM, int BN, int BK>
struct F32Tile {
  static constexpr int THREADS = 256;  // 16 x 16 threads
  static constexpr int TM = BM / 16;   // rows per thread
  static constexpr int TN = BN / 16;   // cols per thread
  static constexpr int SMEM = (BK * BM + BK * BN) * 4;
  static_assert(BM % 16 == 0 && BN % 16 == 0, "f32 tile must be a multiple of 16");
};

// Rows of the A box: whole 64-row slabs up to BM for the wgmma tiles, BM for the others.
template <int BM>
__host__ __device__ __forceinline__ int a_box_rows(int M) {
  if (BM < 64) return BM;
  const int slabs = (M + 63) / 64 * 64;
  return slabs < BM ? slabs : BM;
}

// ---------------------------------------------------------------------------
// bf16 kernel, TMA ring + warp specialisation (the path every aligned shape takes)
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK, typename OutT>
__global__ void __launch_bounds__(TmaTile<BM, BN, BK>::THREADS)
    gemm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, OutT* __restrict__ C, int M, int N,
                    int K, int order, float* __restrict__ ws, int* __restrict__ counters) {
  using T = TmaTile<BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char tma_smem[];
  const unsigned raw = smem_addr(tma_smem);
  const unsigned ring = (raw + 1023) & ~1023u;  // swizzle atoms need 1024-byte alignment
  unsigned char* gen = tma_smem + (ring - raw);
  const unsigned full0 = ring + T::STAGES * T::STAGE;
  const unsigned empty0 = full0 + T::STAGES * 8;
  volatile int* flag = reinterpret_cast<volatile int*>(gen + T::STAGES * T::STAGE + 2 * T::STAGES * 8);

  const int gn = (N + BN - 1) / BN;
  int tm, tn;
  tile_coords(order, (M + BM - 1) / BM, gn, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int tile = tm * gn + tn;
  int kt0, nk;
  split_range(K, BK, kt0, nk);

  // Rows of A each stage loads: a wgmma tile loads only the 64-row slabs that hold a
  // row of A (one of two at decode), and only their warpgroups compute.
  const int a_rows = a_box_rows<BM>(M);
  const int active = T::WGMMA ? a_rows * 2 : T::CONSUMERS;  // consumer threads that compute
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);            // the producer's arrive + the bytes
      mbar_init(empty0 + 8 * s, active / 32);  // one arrive per computing warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= T::CONSUMERS) {  // producer warp: one thread issues every copy
    if (threadIdx.x == T::CONSUMERS) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % T::STAGES;
        if (it >= T::STAGES) mbar_wait(empty0 + 8 * s, ((it / T::STAGES) - 1) & 1);
        const unsigned bar = full0 + 8 * s;
        mbar_arrive_expect_tx(bar, T::A_BOXES * T::AW * 2 * a_rows + T::B_BOXES * T::B_BOX);
        const unsigned st = ring + s * T::STAGE;
        const int k0 = (kt0 + it) * BK;
#pragma unroll
        for (int b = 0; b < T::A_BOXES; ++b) tma_load_2d(st + b * T::A_BOX, &map_a, k0 + b * T::AW, m0, bar);
#pragma unroll
        for (int b = 0; b < T::B_BOXES; ++b)
          tma_load_2d(st + T::A_BYTES + b * T::B_BOX, &map_b, n0 + 64 * b, k0, bar);
      }
    }
    return;
  }

  const int ctid = threadIdx.x, lane = ctid & 31, warp = ctid >> 5;
  const int g = lane >> 2, q = lane & 3;
  if constexpr (T::WGMMA) {
    constexpr int NF = BN / 8;
    const int wg = warp >> 2;
    float acc[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
    for (int it = 0; ctid < active && it < nk; ++it) {
      const int s = it % T::STAGES;
      mbar_wait(full0 + 8 * s, (it / T::STAGES) & 1);
      const unsigned st = ring + s * T::STAGE;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: K-major, rows of AW elements swizzled in 8-row atoms (SBO = 8 rows); this
        // warpgroup's 64 rows start 64 * AW * 2 bytes in, k16 slices 32 bytes apart.
        const unsigned a_addr = st + (kk * 16 / T::AW) * T::A_BOX + wg * 64 * T::AW * 2 + (kk * 16 % T::AW) * 2;
        // B: MN-major, 128-byte rows of 64 n; the second 64 columns are the next box
        // (LBO), 8-row k groups 1024 bytes apart (SBO), k16 slices 2048 bytes apart.
        const unsigned b_addr = st + T::A_BYTES + kk * 16 * 128;
        const uint64_t da = wgmma_desc(a_addr, 16, 8 * T::AW * 2, T::AW == 64 ? 1 : 2);
        const uint64_t db = wgmma_desc(b_addr, T::B_BOX, 1024, 1);
        wgmma_m64n128k16(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release its buffers
      fence_acc(acc);
      if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % T::STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // m64nN accumulator: warp w of the warpgroup holds rows 16w + g (+8); n8 block f
    // holds cols 8f + 2q (+1).
    int rows[NF], cols[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      rows[f] = m0 + wg * 64 + (warp & 3) * 16 + g;
      cols[f] = n0 + f * 8 + 2 * q;
    }
    finish_tile<NF, T::CONSUMERS>(acc, rows, cols, C, M, N, tile, ws, counters, ctid, flag);
  } else {
    using W = Bf16Tile<BM, BN, BK>;
    constexpr int NF = W::MT * W::NT;
    const int wm = warp / W::WARPS_N, wn = warp % W::WARPS_N;
    float acc[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % T::STAGES;
      mbar_wait(full0 + 8 * s, (it / T::STAGES) & 1);
      const unsigned a_s = ring + s * T::STAGE;
      const unsigned b_s = a_s + T::A_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned af[W::MT][4];
        unsigned bfr[W::NT][2];
#pragma unroll
        for (int i = 0; i < W::MT; ++i) {
          const int row = wm * W::WTM + i * 16 + (lane & 15);
          const int col = kk + (lane >> 4) * 8;
          ldmatrix_x4(af[i], a_s + (col >> 6) * T::A_BOX + swz128(row, (col & 63) >> 3));
        }
#pragma unroll
        for (int j = 0; j < W::NT; j += 2) {
          const int krow = kk + (lane & 15);
          const int col = wn * W::WTN + j * 8 + (lane >> 4) * 8;
          unsigned r[4];
          ldmatrix_x4_trans(r, b_s + (col >> 6) * T::B_BOX + swz128(krow, (col & 63) >> 3));
          bfr[j][0] = r[0];
          bfr[j][1] = r[1];
          bfr[j + 1][0] = r[2];
          bfr[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < W::MT; ++i)
#pragma unroll
          for (int j = 0; j < W::NT; ++j) mma_bf16_16816(acc[i * W::NT + j], af[i], bfr[j][0], bfr[j][1]);
      }
      // Release the previous stage, not this one: its ldmatrix results fed this warp's
      // earlier mma.syncs, and this stage's full-barrier wait (an acquire) orders the
      // arrive after them. An arrive right after this stage's ldmatrix can overtake
      // loads still in flight, and the producer's next TMA then overwrites them.
      __syncwarp();
      if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % T::STAGES));
    }
    int rows[NF], cols[NF];
#pragma unroll
    for (int i = 0; i < W::MT; ++i)
#pragma unroll
      for (int j = 0; j < W::NT; ++j) {
        rows[i * W::NT + j] = m0 + wm * W::WTM + i * 16 + g;
        cols[i * W::NT + j] = n0 + wn * W::WTN + j * 8 + 2 * q;
      }
    finish_tile<NF, T::CONSUMERS>(acc, rows, cols, C, M, N, tile, ws, counters, ctid, flag);
  }
}

// ---------------------------------------------------------------------------
// bf16 kernel, cp.async ring (shapes TMA cannot take: a row stride that is not a
// multiple of 16 bytes or an unaligned base; VEC = false loads element by element)
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK, bool VEC, typename OutT>
__global__ void __launch_bounds__(128)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, OutT* __restrict__ C,
                     int M, int N, int K, int order, float* __restrict__ ws,
                     int* __restrict__ counters) {
  using T = Bf16Tile<BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int flag;
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + kStages * T::A_STAGE;

  const int gn = (N + BN - 1) / BN;
  int tm, tn;
  tile_coords(order, (M + BM - 1) / BM, gn, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  int kt0, ktiles;
  split_range(K, BK, kt0, ktiles);

  auto load_stage = [&](int stage, int kt) {
    const int k0 = (kt0 + kt) * BK;
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

  constexpr int NF = T::MT * T::NT;
  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;

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
        ldmatrix_x4(af[i], smem_addr(a_s + row * T::AS + col));
      }
#pragma unroll
      for (int j = 0; j < T::NT; j += 2) {
        const int krow = kk + (lane & 15);
        const int col = wn * T::WTN + j * 8 + (lane >> 4) * 8;
        unsigned r[4];
        ldmatrix_x4_trans(r, smem_addr(b_s + krow * T::BS + col));
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j) mma_bf16_16816(acc[i * T::NT + j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  // The m16n8 accumulator layout puts (row g, cols 2t, 2t+1) in c0/c1 and row g+8 in
  // c2/c3, with g = lane / 4 and t = lane % 4.
  const int g = lane >> 2, t = lane & 3;
  int rows[NF], cols[NF];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      rows[i * T::NT + j] = m0 + wm * T::WTM + i * 16 + g;
      cols[i * T::NT + j] = n0 + wn * T::WTN + j * 8 + 2 * t;
    }
  finish_tile<NF, T::THREADS>(acc, rows, cols, C, M, N, tm * gn + tn, ws, counters, tid, &flag);
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
// The f32 kernel: a 2-D grid, the order's fast axis on blockIdx.x.
dim3 grid_for(int M, int N, int BM, int BN, int order) {
  const unsigned gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  return order == 0 ? dim3(gn, gm) : dim3(gm, gn);
}

// The bf16 kernels: every output tile on blockIdx.x (tile_coords), the splits on z.
dim3 grid_banded(int M, int N, int BM, int BN, int splits) {
  return dim3(((M + BM - 1) / BM) * ((N + BN - 1) / BN), 1, splits);
}

template <int BM, int BN, int BK, typename OutT>
cudaError_t run_tma(const void* a, const void* b, void* c, int M, int N, int K, int order,
                    int splits, float* ws, int* counters, cudaStream_t stream) {
  using T = TmaTile<BM, BN, BK>;
  if (K % 8 || N % 8 || reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return cudaErrorInvalidValue;  // the wrapper sends these shapes to the cp.async path
  CUtensorMap map_a, map_b;
  // Row-major bf16 (rows, cols) matrices as 2-D maps, innermost dim first.
  const uint64_t dims_a[3] = {(uint64_t)K, (uint64_t)M, 1}, dims_b[3] = {(uint64_t)N, (uint64_t)K, 1};
  const uint32_t box_a[3] = {(uint32_t)T::AW, (uint32_t)a_box_rows<BM>(M), 1}, box_b[3] = {64, BK, 1};
  cudaError_t err = tensor_map(&map_a, a, 2, dims_a, box_a, T::A_SWIZZLE);
  if (err != cudaSuccess) return err;
  err = tensor_map(&map_b, b, 2, dims_b, box_b, 128);
  if (err != cudaSuccess) return err;
  static std::atomic<unsigned long long> done{0};
  auto kernel = &gemm_tma_kernel<BM, BN, BK, OutT>;
  err = opt_in(kernel, T::SMEM, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid_banded(M, N, BM, BN, splits), T::THREADS, T::SMEM, stream>>>(
      map_a, map_b, static_cast<OutT*>(c), M, N, K, order, ws, counters);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, typename OutT>
cudaError_t run_cp_async(const void* a, const void* b, void* c, int M, int N, int K, int order,
                         int splits, float* ws, int* counters, cudaStream_t stream) {
  using T = Bf16Tile<BM, BN, BK>;
  // 16-byte cp.async needs every row start 16-byte aligned: K % 8 for A, N % 8 for B.
  const bool vec = K % 8 == 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  static std::atomic<unsigned long long> done_vec{0}, done_scalar{0};
  auto kernel = vec ? &gemm_bf16_kernel<BM, BN, BK, true, OutT> : &gemm_bf16_kernel<BM, BN, BK, false, OutT>;
  cudaError_t err = opt_in(kernel, T::SMEM, vec ? done_vec : done_scalar);
  if (err != cudaSuccess) return err;
  kernel<<<grid_banded(M, N, BM, BN, splits), T::THREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<OutT*>(c), M, N, K,
      order, ws, counters);
  return cudaGetLastError();
}

template <int BM, int BN, int BK>
cudaError_t run_f32(const void* a, const void* b, void* c, int M, int N, int K, int order,
                    cudaStream_t stream) {
  using T = F32Tile<BM, BN, BK>;
  static std::atomic<unsigned long long> done{0};
  auto kernel = &gemm_f32_kernel<BM, BN, BK>;
  cudaError_t err = opt_in(kernel, T::SMEM, done);
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

// Writes (bm, bn, bk, TMA ring stages, TMA smem bytes, cp.async smem bytes, f32 smem
// bytes) per compiled tile; returns the count.
int repro_matmul_tiles(int* out, int cap) {
  int n = 0;
#define X(bm, bn, bk)                                  \
  if (n < cap) {                                       \
    out[7 * n + 0] = bm;                               \
    out[7 * n + 1] = bn;                               \
    out[7 * n + 2] = bk;                               \
    out[7 * n + 3] = TmaTile<bm, bn, bk>::STAGES;      \
    out[7 * n + 4] = TmaTile<bm, bn, bk>::SMEM;        \
    out[7 * n + 5] = Bf16Tile<bm, bn, bk>::SMEM;       \
    out[7 * n + 6] = F32Tile<bm, bn, bk>::SMEM;        \
  }                                                    \
  ++n;
  REPRO_MATMUL_TILES(X)
#undef X
  return n;
}

// bf16 inputs; out_f32 selects an f32 (else bf16) output. order 0 = "mnk" (n tiles run
// fastest, in bands of kBand), 1 = "nmk" (m tiles fastest). tma = 1 takes the TMA kernel (K and N
// multiples of 8, 16-byte aligned bases), 0 the cp.async one. splits > 1 splits k across
// blockIdx.z: ws then holds splits * (output tiles) * bm * bn floats and counters one
// zeroed int per output tile, both private to the stream.
int repro_matmul_bf16(int bm, int bn, int bk, int order, int out_f32, int tma, const void* a,
                      const void* b, void* c, int M, int N, int K, int splits, void* ws,
                      void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* ctr = static_cast<int*>(counters);
  if (splits < 1 || (splits > 1 && (w == nullptr || ctr == nullptr))) return (int)cudaErrorInvalidValue;
#define X(bm_, bn_, bk_)                                                                         \
  if (bm == bm_ && bn == bn_ && bk == bk_) {                                                     \
    if (tma)                                                                                     \
      return out_f32 ? (int)run_tma<bm_, bn_, bk_, float>(a, b, c, M, N, K, order, splits, w, ctr, s) \
                     : (int)run_tma<bm_, bn_, bk_, bf16>(a, b, c, M, N, K, order, splits, w, ctr, s); \
    return out_f32 ? (int)run_cp_async<bm_, bn_, bk_, float>(a, b, c, M, N, K, order, splits, w, ctr, s) \
                   : (int)run_cp_async<bm_, bn_, bk_, bf16>(a, b, c, M, N, K, order, splits, w, ctr, s); \
  }
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

// Tensor maps encoded since the library loaded (a cached map is not counted again).
long long repro_matmul_map_encodes() { return g_map_encodes.load(); }

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
