// Tiled GEMM for Hopper (sm_90a): C(m,n) = A(m,k) @ B(k,n), f32 accumulate.
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
// Operands are row-major, or (bf16, TMA path) the transpose of a row-major tensor: A
// as Aᵀ (k, m) with m contiguous (TA = 1), B as Bᵀ (n, k) with k contiguous (TB = 1).
// The gradient's GEMMs take them so (grad_lhs = g·rhsᵀ reads rhs as it lies, grad_rhs
// = lhsᵀ·g reads lhs as it lies): the tensor maps are built over the tensor as it lies,
// wgmma reads A M-major or B K-major by its transpose bits, and the mma.sync tiles read
// an M-major A with ldmatrix.trans and a K-major B with ldmatrix.
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
//   * A TMA ring fed by one producer warp (gemm_tma_kernel, every call that splits k or
//     has at most one tile row). Tiles of A and B come in by cp.async.bulk.tensor into a
//     ring of 4-8 stages (as many as ~110 KB hold, so two CTAs share an SM; ~200 KB for
//     the 128 x 256 tile, one CTA an SM), each stage guarded by a full and an empty
//     mbarrier. One thread issues the copies; the consumer warps spend no instructions on
//     addresses and no block-wide barrier runs per k step. The boxes land 128-byte
//     swizzled (64-byte for a 32-wide box), so the reads below are free of bank
//     conflicts. Tensor maps are encoded on the host (cuTensorMapEncodeTiled through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda) and cached by (pointer,
//     dims, box): a weight's map is encoded once. TMA zero-fills boxes that cross an edge.
//   * 64- and 128-row tiles: one consumer warpgroup per 64 rows issues
//     wgmma.mma_async m64n128k16 or m64n256k16 (bf16 -> f32) with both operands in
//     shared memory. Each stage is released after the next stage's wgmma group is issued.
//   * 16- and 32-row tiles keep mma.sync m16n8k16 fed by ldmatrix, now from the TMA
//     ring. At m <= 32 these tiles are bytes-bound and the tensor cores are not their
//     limit; wgmma would need Cᵀ = Bᵀ·Aᵀ with a transposed epilogue for no gain there.
//     These warps too release a stage one step late (see the consumer loop).
//   * The compute-bound calls (the 128-row tiles, one split, more than one tile row:
//     kernels/matmul.py::uses_persistent) take gemm_persistent_kernel instead:
//       - persistent: a grid of clusters sized to what the card holds at once, each
//         walking output tiles in the config's order (mnk / nmk, in bands) with a fixed
//         stride, so the schedule is the same every call;
//       - warp-specialised: one producer warpgroup (setmaxnreg.dec to 40 registers; one
//         thread issues the copies) and two consumer warpgroups (setmaxnreg.inc to 232),
//         each issuing m64nBNk16 over its 64 rows; the ring takes what the SM's 227 KB
//         hold beside the epilogue's staging, one CTA an SM: 4 stages of 128 x 256 x 64,
//         6 of 128 x 128 x 64 (a stage holds two k steps of the 128 x 128 x 32 tile, in
//         order: half the barrier round trips, the same sums);
//       - clusters of 2 along m: the two CTAs of a cluster work on vertically adjacent
//         tiles of one tile column, so they share B. Each CTA loads half of each B stage
//         and multicasts it into both CTAs (cp.async.bulk.tensor .multicast::cluster),
//         halving B's L2 traffic; a stage's empty barrier counts the consumer warps of
//         both CTAs (each releases a stage in its own CTA and, by mapa, in its peer's).
//         Where the tile rows are odd, the second CTA of the last pair falls off the m
//         edge: its A boxes are wholly out of range (TMA fills zeros), it keeps the ring
//         protocol with its peer and stores nothing;
//       - the producer runs ahead across tiles, so the next tile's loads run under the
//         current tile's epilogue. The epilogue stages each warp's 16 rows through shared
//         memory, 32 columns at a time (padded rows: no bank conflict), and stores them
//         with 16-byte coalesced stores.
//   * Shapes TMA cannot take (a row stride that is not a multiple of 16 bytes, or an
//     unaligned base) run a 3-stage cp.async ring (scalar loads where a row is not
//     16-byte aligned) with the same split-k epilogue. The wrapper chooses the path
//     and counts its launches per path; it copies a transposed operand for this path.
//
// The f32 path (f32 inputs and output; the training path, which trains in f32). It
// computes preferred_element_type=f32 in full f32: FFMA on f32 values, no TF32 and no
// 3xTF32, either of which would change what is computed. Its bound is operations: 2mnk
// FLOP over the 67 TFLOP/s of the FP32 pipes outside the tensor cores (a granite-8b
// layer GEMM at 1024 rows does 230-340 FLOP per byte of its operands and output; the
// card turns 20 FLOP per HBM byte). So the design gives as many instruction slots as it
// can to FFMA:
//   * A ring of 3-4 stages of A and B tiles (as many as ~110 KB hold, so two CTAs share
//     an SM) filled by 16-byte cp.async (4-byte ones where a row is not 16-byte aligned
//     or K or N is not a multiple of 4). Step s + STAGES - 1 loads while step s
//     computes; one __syncthreads a step both publishes the stage that landed and frees
//     the stage computed last.
//   * A stays m-major in shared memory, as it lies in memory, and each thread reads it
//     as float4 along k (LDS.128): one load gives a row's next 4 k. The 8 lanes of a
//     quarter-warp (one LDS.128 wavefront) share their rows, so every A load is a
//     broadcast: no bank conflict, no padding. Transposing A on its way in to a [k][m]
//     layout would need register-staged loads in place of cp.async, and padding against
//     the 32-way conflict of a warp storing one row's k values.
//   * Warp-tiled register micro-tiles of contiguous 4-wide fragments: at 128 x 128, 256
//     threads of 8 x 8 outputs, a warp 32 x 64 as 4 x 8 lanes, a thread's 8 columns two
//     float4 fragments 32 apart. Each 4 k steps a thread reads 8 float4 of A and 8 of B
//     for 256 FFMA: one LDS.128 per 16 FFMA (scalar reads of an 8 x 8 micro-tile
//     strided by 16 rows and columns: one LDS.32 per 4). The 8 lanes of a
//     quarter-warp read 128 contiguous bytes of B: no conflict. 64 x 128 tiles take 8 x
//     8 at 128 threads; the 16- and 32-row tiles 4 x 4 (2 x 4 at 16 x 64) at 128.
//   * In-kernel split-k along blockIdx.z with the bf16 path's ordered epilogue
//     (reduce_tile: partials in the per-stream workspace, the last CTA sums them in
//     split order). The wrapper (kernels/matmul.py::split_k_f32) splits only an (m, n)
//     grid smaller than the card, into the count whose grid leaves the fewest SM slots
//     idle (up to two CTAs an SM, at least 8 k steps a split). At 1024 rows that is
//     granite-8b's K/V projection and seamless's 256,256-term head gradient (64 tiles
//     each): 4 splits fill the card, and each thread sums a quarter of the terms.
// The 128 x 256 x 64 tile's cp.async and f32 launches run the 128 x 128 x 32 kernels of
// those paths (a 128 x 256 register tile does not fit a thread of either).
// Left for later: a TMA-store epilogue, stages and warps as config axes, the split-k
// calls on the persistent schedule.
//
// Plain C interface, loaded with ctypes; every entry point returns a cudaError_t.

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kStages = 3;             // cp.async ring depth of the fallback kernel
constexpr int kRingBudget = 110 * 1024;  // TMA and f32 ring bytes per CTA: two CTAs fit on one SM
constexpr int kWideRingBudget = 200 * 1024;  // the TMA ring of a 128 x 256 tile: one CTA an SM
constexpr int kMaxTmaStages = 8;
constexpr int kMinF32Stages = 3;         // the f32 ring: 3-4 stages within kRingBudget
constexpr int kMaxF32Stages = 4;
constexpr int kSmemLimit = 232448;       // dynamic shared memory one CTA may use (227 KB)
constexpr int kMaxPersistStages = 8;
constexpr int kEpiWarpBytes = 16 * 160;  // a consumer warp's epilogue staging: 16 rows of 32 f32 + 32 bytes
constexpr int kProducerRegs = 40;        // setmaxnreg of the persistent kernel's warpgroups
constexpr int kConsumerRegs = 232;

// Clusters (the persistent kernel) -------------------------------------------------
__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of both CTAs arrives (release) and waits (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// Arrive on the mbarrier at ``bar`` (a shared::cta address) of CTA ``cta`` of the cluster,
// with the default release at CTA scope: what the arrive orders are this warp's wgmma
// reads of the stage, which its wgmma wait has completed; a release at cluster scope
// would also wait for every earlier global store (the last tile's epilogue) each stage.
__device__ __forceinline__ void mbar_arrive_cluster(unsigned bar, unsigned cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// One 2-D TMA box into the same shared-memory offset of every CTA in ``mask``; each
// CTA's mbarrier at ``bar`` counts the bytes that land in it.
__device__ __forceinline__ void tma_load_2d_multicast(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                                      unsigned bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma (the PTX helpers, mbarriers, TMA and the wgmma fence are in hopper.cuh) --------
// D(64x128, f32) += A(64x16) * B(16x128), both in shared memory. TA = 1 reads A M-major and
// TB = 1 reads B K-major (the transposed operands of the backward); else A is K-major and B
// MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
        "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]),
        "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB == 0 ? 1 : 0));
}

// D(64x256, f32) += A(64x16) * B(16x256), both in shared memory. TA = 1 reads A M-major and
// TB = 1 reads B K-major (the transposed operands of the backward); else A is K-major and B
// MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[32][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
        "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]),
        "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]),
        "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]),
        "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]),
        "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]),
        "+f"(d[25][2]), "+f"(d[25][3]), "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]), "+f"(d[28][0]), "+f"(d[28][1]),
        "+f"(d[28][2]), "+f"(d[28][3]), "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]), "+f"(d[31][0]), "+f"(d[31][1]),
        "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB == 0 ? 1 : 0));
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

// With one split the tile is stored (store(f, v) for each of a thread's NF float4
// fragments). Otherwise the partial goes to the workspace slot (tile, split) in fragment
// order (coalesced 16-byte stores), and the last CTA of the tile sums the slots in split
// order, stores C and resets the tile's counter.
template <int NF, int NC, typename Store>
__device__ __forceinline__ void reduce_tile(const float (&acc)[NF][4], Store store, int tile, float* ws,
                                            int* counters, int ctid, volatile int* flag) {
  const int splits = gridDim.z;
  if (splits == 1) {
#pragma unroll
    for (int f = 0; f < NF; ++f) store(f, make_float4(acc[f][0], acc[f][1], acc[f][2], acc[f][3]));
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
  for (int f = 0; f < NF; ++f) store(f, v[f]);
  if (ctid == 0) counters[tile] = 0;  // ready for the next call on this stream
}

// The bf16 kernels' epilogue: fragments in the m16n8 accumulator layout (store_frag).
template <int NF, int NC, typename OutT>
__device__ __forceinline__ void finish_tile(const float (&acc)[NF][4], const int (&rows)[NF],
                                            const int (&cols)[NF], OutT* C, int M, int N,
                                            int tile, float* ws, int* counters, int ctid,
                                            volatile int* flag) {
  reduce_tile<NF, NC>(acc, [&](int f, float4 v) { store_frag(C, M, N, rows[f], cols[f], v); }, tile, ws,
                      counters, ctid, flag);
}

// The k steps of this CTA's split: [kt0, kt0 + nk). Every split but the last has
// ceil(steps / splits) steps; kernels/matmul.py::split_k picks splits so none is empty.
__device__ __forceinline__ void split_range(int K, int BK, int& kt0, int& nk) {
  const int steps = (K + BK - 1) / BK;
  const int per = (steps + gridDim.z - 1) / gridDim.z;
  kt0 = blockIdx.z * per;
  nk = min(steps, kt0 + per) - kt0;
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
struct F32Tile {  // the f32 kernel: thread micro-tiles, warp layout and cp.async ring
  static constexpr int TN = BM >= 64 ? 8 : 4;  // cols a thread: TN / 4 float4 fragments
  static constexpr int TM = BM >= 64 ? 8 : (BM * BN / 512 < 4 ? BM * BN / 512 : 4);  // rows a thread
  static constexpr int TY = BM / TM, TX = BN / TN;  // the tile's threads, as a TY x TX grid
  static constexpr int THREADS = TY * TX;
  static constexpr int LX = 8, LY = 4;              // a warp: 4 x 8 threads, lane = 8 ly + lx
  static constexpr int WX = TX / LX, WY = TY / LY;  // warps along n and m
  static constexpr int WTM = LY * TM, WTN = LX * TN;  // warp tile
  static constexpr int NFN = TN / 4;                // float4 fragments along n, 4 LX apart
  static constexpr int NF = TM * NFN;               // float4 fragments a thread holds
  static constexpr int A_STAGE = BM * BK, B_STAGE = BK * BN;  // floats: A [BM][BK], B [BK][BN]
  static constexpr int STAGE = (A_STAGE + B_STAGE) * 4;
  static constexpr int FIT = kRingBudget / STAGE;
  static constexpr int STAGES = FIT < kMinF32Stages ? kMinF32Stages : (FIT > kMaxF32Stages ? kMaxF32Stages : FIT);
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(TX % LX == 0 && TY % LY == 0 && THREADS == 32 * WX * WY, "whole warps of 4 x 8 threads");
  static_assert(TN % 4 == 0 && BK % 4 == 0, "float4 fragments along n and k");
  static_assert((A_STAGE / 4) % THREADS == 0 && (B_STAGE / 4) % THREADS == 0, "whole 16-byte chunks a thread");
};

// Rows of the A box: whole 64-row slabs up to BM for the wgmma tiles, BM for the others.
template <int BM>
__host__ __device__ __forceinline__ int a_box_rows(int M) {
  if (BM < 64) return BM;
  const int slabs = (M + 63) / 64 * 64;
  return slabs < BM ? slabs : BM;
}

// Output tile ``pid`` of a gm x gn grid of tiles. The tiles are walked in bands of kBand
// along the order's fast axis (n for "mnk", so CTAs that share an A row-block run
// together; m for "nmk"): 132 CTAs in flight then touch ~8 blocks of one operand and
// ~17 of the other, which stay in the 50 MB L2, instead of sweeping a whole operand
// that does not fit once per tile row. The persistent kernel walks pairs of tile rows
// (one cluster's) the same way.
constexpr int kBand = 8;
__device__ __forceinline__ void tile_coords(int order, int gm, int gn, int pid, int& tm, int& tn) {
  const int fast_n = order == 0 ? gn : gm, slow_n = order == 0 ? gm : gn;
  const int band = pid / (kBand * slow_n), within = pid % (kBand * slow_n);
  const int width = min(kBand, fast_n - band * kBand);
  const int fast = band * kBand + within % width, slow = within / width;
  tm = order == 0 ? slow : fast;
  tn = order == 0 ? fast : slow;
}

template <int BM, int BN, int BK>
struct TmaTile {
  static constexpr bool WGMMA = BM >= 64;
  // A K-major (as it lies, TA = 0): boxes of AW k x BM rows.
  static constexpr int AW = BK < 64 ? BK : 64;  // A box width in k (elements): one swizzle row
  static constexpr int A_SWIZZLE = AW * 2;      // bytes: 128, or 64 for a 32-wide box
  static constexpr int A_BOXES = BK / AW;
  static constexpr int A_BOX = BM * AW * 2;
  static constexpr int A_BYTES = BM * BK * 2;
  // A M-major (a transposed lhs, TA = 1): the wgmma tiles take boxes of 64 m (128 bytes,
  // swizzled) x BK k rows, one per 64-row slab; the mma.sync tiles one unswizzled box of
  // BM m x BK k rows, read with ldmatrix.trans.
  static constexpr int AT_BOX = WGMMA ? BK * 128 : BM * BK * 2;
  // B MN-major (as it lies, TB = 0): boxes of 64 n (128 bytes) x BK k rows.
  static constexpr int B_BOXES = BN / 64;
  static constexpr int B_BOX = BK * 128;
  // B K-major (a transposed rhs, TB = 1): boxes of BW k x BN rows (the persistent kernel
  // loads each as two halves of BN / 2 rows, one from each CTA of the cluster).
  static constexpr int BW = BK < 64 ? BK : 64;
  static constexpr int BT_BOX = BN * BW * 2;
  static constexpr int STAGE = A_BYTES + BK * BN * 2;
  static constexpr int BUDGET = BM * BN >= 128 * 256 ? kWideRingBudget : kRingBudget;
  static constexpr int STAGES = BUDGET / STAGE < kMaxTmaStages ? BUDGET / STAGE : kMaxTmaStages;
  static constexpr int CONSUMERS = WGMMA ? (BM / 64) * 128 : 128;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  // 1 KB of alignment slack, the ring, a full and an empty barrier per stage, the flag.
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8 + 16;
  static_assert(BK % AW == 0 && (AW == 64 || AW == 32), "A box must be 32 or 64 wide");
  static_assert(BN % 64 == 0, "B tile must be whole 64-wide boxes");
  static_assert(!WGMMA || (BM % 64 == 0 && (BN == 128 || BN == 256)), "wgmma tiles are 64k x 128 or 64k x 256");
  static_assert(WGMMA || (AW == 64 && BW == 64), "mma.sync tiles read 128-byte swizzled rows");
  static_assert(SMEM <= kSmemLimit, "the ring must fit one CTA's shared memory");
};

template <int BM, int BN, int BK>
struct PersistTile {  // the persistent kernel: the ring of TmaTile's boxes, one CTA an SM
  // k a stage: at least 64 (two k steps of a 32-deep tile: half the barrier round trips a
  // product; the k16 slices run in the same order, so the sums are the same).
  static constexpr int SK = BK < 64 ? 64 : BK;
  using R = TmaTile<BM, BN, SK>;
  static constexpr int CONSUMERS = (BM / 64) * 128;
  static constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
  static constexpr int EPI = (CONSUMERS / 32) * kEpiWarpBytes;
  static constexpr int STAGE = R::STAGE;
  static constexpr int FIT = (kSmemLimit - 1024 - EPI - 256) / STAGE;
  static constexpr int STAGES = FIT < kMaxPersistStages ? FIT : kMaxPersistStages;
  // 1 KB of alignment slack, the ring, the epilogue's staging, a full and an empty barrier a stage.
  static constexpr int SMEM = 1024 + STAGES * STAGE + EPI + 2 * STAGES * 8;
  // A stage is free once every consumer warp of both CTAs has released it.
  static constexpr int EMPTY_ARRIVALS = 2 * (CONSUMERS / 32);
  static_assert(BM == 128 && R::WGMMA, "two consumer warpgroups of 64 rows");
  static_assert(STAGES >= 4 && SMEM <= kSmemLimit, "4 stages at least, within one CTA's shared memory");
  static_assert(kProducerRegs * 128 + kConsumerRegs * CONSUMERS <= 65536, "setmaxnreg within the SM's file");
};

// The wgmma descriptors of k16 slice ``kk`` of warpgroup ``wg``'s 64 rows in the stage at ``st``.
template <int BM, int BN, int BK, int TA, int TB>
__device__ __forceinline__ void stage_descs(unsigned st, int wg, int kk, uint64_t& da, uint64_t& db) {
  using T = TmaTile<BM, BN, BK>;
  if constexpr (TA == 0) {
    // A: K-major, rows of AW elements swizzled in 8-row atoms (SBO = 8 rows); this
    // warpgroup's 64 rows start 64 * AW * 2 bytes in, k16 slices 32 bytes apart.
    const unsigned a = st + (kk * 16 / T::AW) * T::A_BOX + wg * 64 * T::AW * 2 + (kk * 16 % T::AW) * 2;
    da = wgmma_desc(a, 16, 8 * T::AW * 2, T::AW == 64 ? 1 : 2);
  } else {
    // A: M-major, this warpgroup's 64 m are one box of 128-byte rows, 8-row k groups
    // 1024 bytes apart (SBO), k16 slices 2048 bytes apart.
    da = wgmma_desc(st + wg * T::AT_BOX + kk * 16 * 128, T::AT_BOX, 1024, 1);
  }
  if constexpr (TB == 0) {
    // B: MN-major, 128-byte rows of 64 n; each next 64 columns are the next box (LBO),
    // 8-row k groups 1024 bytes apart (SBO), k16 slices 2048 bytes apart.
    db = wgmma_desc(st + T::A_BYTES + kk * 16 * 128, T::B_BOX, 1024, 1);
  } else {
    // B: K-major, BN rows of BW k swizzled in 8-row atoms, k16 slices 32 bytes apart.
    const unsigned b = st + T::A_BYTES + (kk * 16 / T::BW) * T::BT_BOX + (kk * 16 % T::BW) * 2;
    db = wgmma_desc(b, 16, 8 * T::BW * 2, T::BW == 64 ? 1 : 2);
  }
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 8][4], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k16<TA, TB>(d, da, db);
  else
    wgmma_m64n128k16<TA, TB>(d, da, db);
}

// ---------------------------------------------------------------------------
// bf16 kernel, TMA ring + warp specialisation (every aligned call that splits k or has
// one tile row; the persistent kernel below takes the others)
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK, int TA, int TB, typename OutT>
__global__ void __launch_bounds__(TmaTile<BM, BN, BK>::THREADS)
    gemm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, OutT* __restrict__ C, int M, int N,
                    int K, int order, float* __restrict__ ws, int* __restrict__ counters) {
  using T = TmaTile<BM, BN, BK>;
  static_assert(T::STAGES >= 4, "the ring needs at least 4 stages");
  extern __shared__ __align__(16) unsigned char tma_smem[];
  const unsigned raw = smem_addr(tma_smem);
  const unsigned ring = (raw + 1023) & ~1023u;  // swizzle atoms need 1024-byte alignment
  unsigned char* gen = tma_smem + (ring - raw);
  const unsigned full0 = ring + T::STAGES * T::STAGE;
  const unsigned empty0 = full0 + T::STAGES * 8;
  volatile int* flag = reinterpret_cast<volatile int*>(gen + T::STAGES * T::STAGE + 2 * T::STAGES * 8);

  const int gn = (N + BN - 1) / BN;
  int tm, tn;
  tile_coords(order, (M + BM - 1) / BM, gn, blockIdx.x, tm, tn);
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
        mbar_arrive_expect_tx(bar, BK * 2 * a_rows + BK * BN * 2);
        const unsigned st = ring + s * T::STAGE;
        const int k0 = (kt0 + it) * BK;
        if constexpr (TA == 0) {
#pragma unroll
          for (int b = 0; b < T::A_BOXES; ++b) tma_load_2d(st + b * T::A_BOX, &map_a, k0 + b * T::AW, m0, bar);
        } else if constexpr (T::WGMMA) {
          for (int b = 0; b < a_rows / 64; ++b) tma_load_2d(st + b * T::AT_BOX, &map_a, m0 + 64 * b, k0, bar);
        } else {
          tma_load_2d(st, &map_a, m0, k0, bar);
        }
        if constexpr (TB == 0) {
#pragma unroll
          for (int b = 0; b < T::B_BOXES; ++b)
            tma_load_2d(st + T::A_BYTES + b * T::B_BOX, &map_b, n0 + 64 * b, k0, bar);
        } else {
#pragma unroll
          for (int j = 0; j < BK / T::BW; ++j)
            tma_load_2d(st + T::A_BYTES + j * T::BT_BOX, &map_b, k0 + j * T::BW, n0, bar);
        }
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
        uint64_t da, db;
        stage_descs<BM, BN, BK, TA, TB>(st, wg, kk, da, db);
        wgmma_tile<BN, TA, TB>(acc, da, db);
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
          if constexpr (TA == 0) {
            const int row = wm * W::WTM + i * 16 + (lane & 15);
            const int col = kk + (lane >> 4) * 8;
            ldmatrix_x4(af[i], a_s + (col >> 6) * T::A_BOX + swz128(row, (col & 63) >> 3));
          } else {
            // [k][m] rows of BM m: matrices (m 0-7 | 8-15) x (k 0-7 | 8-15), transposed.
            const int m = wm * W::WTM + i * 16 + ((lane >> 3) & 1) * 8;
            const int krow = kk + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4_trans(af[i], a_s + krow * (BM * 2) + m * 2);
          }
        }
#pragma unroll
        for (int j = 0; j < W::NT; j += 2) {
          unsigned r[4];
          if constexpr (TB == 0) {
            const int krow = kk + (lane & 15);
            const int col = wn * W::WTN + j * 8 + (lane >> 4) * 8;
            ldmatrix_x4_trans(r, b_s + (col >> 6) * T::B_BOX + swz128(krow, (col & 63) >> 3));
          } else {
            // [n][k] rows of 64 k: matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, ...).
            const int n = wn * W::WTN + j * 8 + (lane & 7) + ((lane >> 4) << 3);
            const int kcol = kk + ((lane >> 3) & 1) * 8;
            ldmatrix_x4(r, b_s + (kcol >> 6) * T::BT_BOX + swz128(n, (kcol & 63) >> 3));
          }
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
// bf16 kernel, persistent, warp-specialised, clusters of 2 multicasting B (the
// compute-bound calls: 128-row tiles, one split, more than one tile row)
// ---------------------------------------------------------------------------
// A consumer warp's 16 rows of its warpgroup's m64nBN accumulator (fragment f: rows r0 + g
// and r0 + g + 8, cols n0 + 8f + 2q, +1), staged 32 columns at a time in ``stage`` and
// stored 16 bytes a lane (N % 8 == 0 on this path, so a 16-byte piece is wholly inside or
// wholly outside).
template <int NF, typename OutT>
__device__ __forceinline__ void store_rows(const float (&acc)[NF][4], unsigned char* stage, OutT* __restrict__ C,
                                           int M, int N, int r0, int n0, int lane) {
  constexpr bool F32 = sizeof(OutT) == 4;
  constexpr int ROW = F32 ? 160 : 80;  // bytes a staged row: 32 values and padding against conflicts
  constexpr int VEC = 16 / sizeof(OutT);  // values a 16-byte piece
  constexpr int PIECES = 16 * 32 / VEC;   // pieces a chunk of 16 rows x 32 columns
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int c = 0; c < NF / 4; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = acc[c * 4 + j][2 * h], y = acc[c * 4 + j][2 * h + 1];
        unsigned char* p = stage + (g + 8 * h) * ROW + (j * 8 + 2 * q) * sizeof(OutT);
        if constexpr (F32)
          *reinterpret_cast<float2*>(p) = make_float2(x, y);
        else
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < PIECES / 32; ++u) {
      const int i = lane + 32 * u, row = i / (32 / VEC), piece = i % (32 / VEC);
      const int r = r0 + row, col = n0 + c * 32 + piece * VEC;
      if (r < M && col < N)
        *reinterpret_cast<uint4*>(C + (size_t)r * N + col) = *reinterpret_cast<const uint4*>(stage + row * ROW + piece * 16);
    }
    __syncwarp();
  }
}

template <int BM, int BN, int BK, int TA, int TB, typename OutT>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(PersistTile<BM, BN, BK>::THREADS, 1)
    gemm_persistent_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                           OutT* __restrict__ C, int M, int N, int K, int order) {
  using P = PersistTile<BM, BN, BK>;
  using T = typename P::R;
  constexpr int SK = P::SK;
  extern __shared__ __align__(16) unsigned char tma_smem[];
  const unsigned raw = smem_addr(tma_smem);
  const unsigned ring = (raw + 1023) & ~1023u;  // swizzle atoms need 1024-byte alignment
  unsigned char* epi = tma_smem + (ring - raw) + P::STAGES * P::STAGE;
  const unsigned full0 = ring + P::STAGES * P::STAGE + P::EPI;
  const unsigned empty0 = full0 + P::STAGES * 8;
  const unsigned rank = cluster_ctarank();
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN, pairs = (gm + 1) / 2;
  const int units = pairs * gn, nk = (K + SK - 1) / SK;
  const int first = blockIdx.x / 2, stride = gridDim.x / 2;  // this cluster, the clusters

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                     // the producer's arrive + the bytes
      mbar_init(empty0 + 8 * s, P::EMPTY_ARRIVALS);   // every consumer warp of both CTAs
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both CTAs' barriers are set before any multicast or remote arrive

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int u = first; u < units; u += stride) {
        int pair, tn;
        tile_coords(order, pairs, gn, u, pair, tn);
        const int m0 = (2 * pair + (int)rank) * BM, n0 = tn * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % P::STAGES;
          if (it >= P::STAGES) mbar_wait(empty0 + 8 * s, ((it / P::STAGES) - 1) & 1);
          const unsigned bar = full0 + 8 * s;
          mbar_arrive_expect_tx(bar, P::STAGE);  // A, this CTA's half of B and the peer's
          const unsigned st = ring + s * P::STAGE;
          const int k0 = kt * SK;
          if constexpr (TA == 0) {
#pragma unroll
            for (int b = 0; b < T::A_BOXES; ++b) tma_load_2d(st + b * T::A_BOX, &map_a, k0 + b * T::AW, m0, bar);
          } else {
#pragma unroll
            for (int b = 0; b < BM / 64; ++b) tma_load_2d(st + b * T::AT_BOX, &map_a, m0 + 64 * b, k0, bar);
          }
          if constexpr (TB == 0) {
            constexpr int HALF = T::B_BOXES / 2;
#pragma unroll
            for (int b = (int)rank * HALF; b < ((int)rank + 1) * HALF; ++b)
              tma_load_2d_multicast(st + T::A_BYTES + b * T::B_BOX, &map_b, n0 + 64 * b, k0, bar, 0x3);
          } else {
#pragma unroll
            for (int j = 0; j < SK / T::BW; ++j)
              tma_load_2d_multicast(st + T::A_BYTES + j * T::BT_BOX + rank * (T::BT_BOX / 2), &map_b,
                                    k0 + j * T::BW, n0 + (int)rank * (BN / 2), bar, 0x3);
          }
        }
      }
    }
  } else {  // two consumer warpgroups, 64 rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int ctid = threadIdx.x - 128, lane = ctid & 31, warp = ctid >> 5, wg = warp >> 2;
    unsigned char* stage_buf = epi + warp * kEpiWarpBytes;
    constexpr int NF = BN / 8;
    float acc[NF][4];
    int it = 0;
    for (int u = first; u < units; u += stride) {
      int pair, tn;
      tile_coords(order, pairs, gn, u, pair, tn);
      const int m0 = (2 * pair + (int)rank) * BM, n0 = tn * BN;
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % P::STAGES;
        mbar_wait(full0 + 8 * s, (it / P::STAGES) & 1);
        const unsigned st = ring + s * P::STAGE;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SK / 16; ++kk) {
          uint64_t da, db;
          stage_descs<BM, BN, SK, TA, TB>(st, wg, kk, da, db);
          wgmma_tile<BN, TA, TB>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it in both CTAs
        fence_acc(acc);
        if (kt > 0 && lane == 0) {
          const unsigned prev = empty0 + 8 * ((it - 1) % P::STAGES);
          mbar_arrive_cluster(prev, 0);
          mbar_arrive_cluster(prev, 1);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) {  // the tile's last stage
        const unsigned last = empty0 + 8 * ((it - 1) % P::STAGES);
        mbar_arrive_cluster(last, 0);
        mbar_arrive_cluster(last, 1);
      }
      store_rows<NF>(acc, stage_buf, C, M, N, m0 + wg * 64 + (warp & 3) * 16, n0, lane);
    }
  }
  cluster_sync();  // neither CTA leaves while its peer may still multicast into it or arrive on it
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
  tile_coords(order, (M + BM - 1) / BM, gn, blockIdx.x, tm, tn);
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
// f32 kernel (full-precision FFMA, no TF32): cp.async ring, warp-tiled micro-tiles,
// split-k (VEC = false copies element by element: a row that is not 16-byte aligned)
// ---------------------------------------------------------------------------
// 4-byte async copy; pred = false zero-fills the destination without reading.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
}

template <int BM, int BN, int BK, bool VEC>
__global__ void __launch_bounds__(F32Tile<BM, BN, BK>::THREADS, 2)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                    int M, int N, int K, int order, float* __restrict__ ws, int* __restrict__ counters) {
  using T = F32Tile<BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int flag;
  float* sA = reinterpret_cast<float*>(smem_raw);  // STAGES x [BM][BK]
  float* sB = sA + T::STAGES * T::A_STAGE;         // STAGES x [BK][BN]

  const int gn = (N + BN - 1) / BN;
  int tm, tn;
  tile_coords(order, (M + BM - 1) / BM, gn, blockIdx.x, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (warp / T::WX) * T::WTM + (lane / T::LX) * T::TM;  // this thread's TM rows
  const int col0 = (warp % T::WX) * T::WTN + (lane % T::LX) * 4;      // its first fragment's cols
  int kt0, nk;
  split_range(K, BK, kt0, nk);

  auto load_stage = [&](int stage, int kt) {
    const int k0 = (kt0 + kt) * BK;
    float* a_dst = sA + stage * T::A_STAGE;
    float* b_dst = sB + stage * T::B_STAGE;
    constexpr int A_CPR = BK / 4, B_CPR = BN / 4;  // 16-byte chunks a row
#pragma unroll
    for (int it = 0; it < BM * A_CPR / T::THREADS; ++it) {
      const int c = tid + it * T::THREADS;
      const int r = c / A_CPR, cc = (c % A_CPR) * 4;
      const int gm = m0 + r, gk = k0 + cc;
      float* dst = a_dst + r * BK + cc;
      if (VEC) {  // K % 4 == 0: a chunk is wholly inside or wholly outside
        const bool ok = gm < M && gk < K;
        cp_async16(dst, ok ? A + (size_t)gm * K + gk : A, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gm < M && gk + e < K;
          cp_async4(dst + e, ok ? A + (size_t)gm * K + gk + e : A, ok);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < BK * B_CPR / T::THREADS; ++it) {
      const int c = tid + it * T::THREADS;
      const int r = c / B_CPR, cc = (c % B_CPR) * 4;
      const int gk = k0 + r, gc = n0 + cc;
      float* dst = b_dst + r * BN + cc;
      if (VEC) {  // N % 4 == 0
        const bool ok = gk < K && gc < N;
        cp_async16(dst, ok ? B + (size_t)gk * N + gc : B, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gk < K && gc + e < N;
          cp_async4(dst + e, ok ? B + (size_t)gk * N + gc + e : B, ok);
        }
      }
    }
  };

  // acc[i * NFN + j] holds row row0 + i, cols col0 + 4 LX j .. + 3.
  float acc[T::NF][4];
#pragma unroll
  for (int f = 0; f < T::NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<T::STAGES - 2>();  // step kt has landed (this thread's copies)
    __syncthreads();                 // ... and everyone's; the stage of step kt - 1 is free again
    const int next = kt + T::STAGES - 1;
    if (next < nk) load_stage(next % T::STAGES, next);
    cp_async_commit();

    const float* a_s = sA + (kt % T::STAGES) * T::A_STAGE + row0 * BK;
    const float* b_s = sB + (kt % T::STAGES) * T::B_STAGE + col0;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[T::TM];  // rows row0 + i, k = kk .. kk + 3
#pragma unroll
      for (int i = 0; i < T::TM; ++i) a[i] = *reinterpret_cast<const float4*>(a_s + i * BK + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4 b[T::NFN];
#pragma unroll
        for (int j = 0; j < T::NFN; ++j)
          b[j] = *reinterpret_cast<const float4*>(b_s + (kk + q) * BN + j * 4 * T::LX);
#pragma unroll
        for (int i = 0; i < T::TM; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < T::NFN; ++j) {
            float* c = acc[i * T::NFN + j];
            c[0] = fmaf(av, b[j].x, c[0]);
            c[1] = fmaf(av, b[j].y, c[1]);
            c[2] = fmaf(av, b[j].z, c[2]);
            c[3] = fmaf(av, b[j].w, c[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool vec_out = (N & 3) == 0;  // C comes from torch.empty: 16-byte aligned rows then
  auto store = [&](int f, float4 v) {
    const int r = m0 + row0 + f / T::NFN, c = n0 + col0 + (f % T::NFN) * 4 * T::LX;
    if (r >= M || c >= N) return;
    float* p = C + (size_t)r * N + c;
    if (vec_out) {  // N % 4 == 0: the fragment is wholly inside
      *reinterpret_cast<float4*>(p) = v;
    } else {
      p[0] = v.x;
      if (c + 1 < N) p[1] = v.y;
      if (c + 2 < N) p[2] = v.z;
      if (c + 3 < N) p[3] = v.w;
    }
  };
  reduce_tile<T::NF, T::THREADS>(acc, store, tm * gn + tn, ws, counters, tid, &flag);
}


// ---------------------------------------------------------------------------
// host-side launch
// ---------------------------------------------------------------------------
// The split/ring kernels: every output tile on blockIdx.x (tile_coords), the splits on z.
dim3 grid_banded(int M, int N, int BM, int BN, int splits) {
  return dim3(((M + BM - 1) / BM) * ((N + BN - 1) / BN), 1, splits);
}

// The tensor maps of a bf16 call's operands as they lie: A (M, K) row-major or, with TA,
// Aᵀ (K, M) row-major; B (K, N) row-major or, with TB, Bᵀ (N, K) row-major. ``b_rows``:
// rows of a K-major B box (BN, or BN / 2 where each CTA of a cluster loads half).
template <int BM, int BN, int BK, int TA, int TB>
cudaError_t operand_maps(const void* a, const void* b, int M, int N, int K, int a_rows, int b_rows,
                         CUtensorMap* map_a, CUtensorMap* map_b) {
  using T = TmaTile<BM, BN, BK>;
  // Each map's row stride (its innermost dim x 2 bytes) must be a multiple of 16 bytes.
  if ((TA ? M : K) % 8 || (TB ? K : N) % 8 || N % 8 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return cudaErrorInvalidValue;  // the wrapper sends these shapes to the cp.async path
  cudaError_t err;
  if constexpr (TA == 0) {
    const uint64_t dims[3] = {(uint64_t)K, (uint64_t)M, 1};
    const uint32_t box[3] = {(uint32_t)T::AW, (uint32_t)a_rows, 1};
    err = tensor_map(map_a, a, 2, dims, box, T::A_SWIZZLE);
  } else {
    const uint64_t dims[3] = {(uint64_t)M, (uint64_t)K, 1};
    const uint32_t box[3] = {(uint32_t)(T::WGMMA ? 64 : BM), (uint32_t)BK, 1};
    err = tensor_map(map_a, a, 2, dims, box, T::WGMMA ? 128 : 0);
  }
  if (err != cudaSuccess) return err;
  if constexpr (TB == 0) {
    const uint64_t dims[3] = {(uint64_t)N, (uint64_t)K, 1};
    const uint32_t box[3] = {64, (uint32_t)BK, 1};
    return tensor_map(map_b, b, 2, dims, box, 128);
  } else {
    const uint64_t dims[3] = {(uint64_t)K, (uint64_t)N, 1};
    const uint32_t box[3] = {(uint32_t)T::BW, (uint32_t)b_rows, 1};
    return tensor_map(map_b, b, 2, dims, box, T::BW * 2);
  }
}

template <int BM, int BN, int BK, int TA, int TB, typename OutT>
cudaError_t run_tma(const void* a, const void* b, void* c, int M, int N, int K, int order, int splits, float* ws,
                    int* counters, cudaStream_t stream) {
  using T = TmaTile<BM, BN, BK>;
  CUtensorMap map_a, map_b;
  cudaError_t err = operand_maps<BM, BN, BK, TA, TB>(a, b, M, N, K, a_box_rows<BM>(M), BN, &map_a, &map_b);
  if (err != cudaSuccess) return err;
  static std::atomic<unsigned long long> done{0};
  auto kernel = &gemm_tma_kernel<BM, BN, BK, TA, TB, OutT>;
  err = opt_in(kernel, T::SMEM, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid_banded(M, N, BM, BN, splits), T::THREADS, T::SMEM, stream>>>(
      map_a, map_b, static_cast<OutT*>(c), M, N, K, order, ws, counters);
  return cudaGetLastError();
}

// Clusters of 2 the card holds at once with ``kernel``'s block and shared memory
// (cudaOccupancyMaxActiveClusters: SMs a GPC cannot pair stay idle), else half its SMs.
template <typename Kernel>
int resident_clusters(Kernel kernel, int threads, int smem) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms - sms % 2, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg) != cudaSuccess || n < 1) {
    cudaGetLastError();  // clear it: the launch below reports its own errors
    n = sms / 2;
  }
  return n;
}

template <int BM, int BN, int BK, int TA, int TB, typename OutT>
cudaError_t run_persistent(const void* a, const void* b, void* c, int M, int N, int K, int order,
                           cudaStream_t stream) {
  using P = PersistTile<BM, BN, BK>;
  CUtensorMap map_a, map_b;
  cudaError_t err = operand_maps<BM, BN, P::SK, TA, TB>(a, b, M, N, K, BM, BN / 2, &map_a, &map_b);
  if (err != cudaSuccess) return err;
  static std::atomic<unsigned long long> done{0};
  static std::atomic<int> clusters{0};
  auto kernel = &gemm_persistent_kernel<BM, BN, BK, TA, TB, OutT>;
  err = opt_in(kernel, P::SMEM, done);
  if (err != cudaSuccess) return err;
  if (clusters.load() == 0) {
    // setmaxnreg moves 128 x (launch registers - kProducerRegs) to the consumers, which ask
    // for kConsumerRegs: with fewer launch registers their setmaxnreg.inc would wait forever.
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * P::THREADS < kProducerRegs * 128 + kConsumerRegs * P::CONSUMERS)
      return cudaErrorInvalidConfiguration;
    clusters.store(resident_clusters(kernel, P::THREADS, P::SMEM));
  }
  const int units = ((M + BM - 1) / BM + 1) / 2 * ((N + BN - 1) / BN);
  const int grid = 2 * (units < clusters.load() ? units : clusters.load());
  kernel<<<grid, P::THREADS, P::SMEM, stream>>>(map_a, map_b, static_cast<OutT*>(c), M, N, K, order);
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
cudaError_t run_f32(const void* a, const void* b, void* c, int M, int N, int K, int order, int splits,
                    float* ws, int* counters, cudaStream_t stream) {
  using T = F32Tile<BM, BN, BK>;
  // 16-byte cp.async needs every row start 16-byte aligned: K % 4 for A, N % 4 for B.
  const bool vec = K % 4 == 0 && N % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  static std::atomic<unsigned long long> done_vec{0}, done_scalar{0};
  auto kernel = vec ? &gemm_f32_kernel<BM, BN, BK, true> : &gemm_f32_kernel<BM, BN, BK, false>;
  cudaError_t err = opt_in(kernel, T::SMEM, vec ? done_vec : done_scalar);
  if (err != cudaSuccess) return err;
  kernel<<<grid_banded(M, N, BM, BN, splits), T::THREADS, T::SMEM, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), M, N, K, order, ws,
      counters);
  return cudaGetLastError();
}

// The cp.async and f32 kernels at a tile they compile (its own cp.async / f32 tile).
template <int BM, int BN, int BK, int PM, int PN, int PK, typename OutT>
cudaError_t run_cp_async_at(const void* a, const void* b, void* c, int M, int N, int K, int order, int splits,
                            float* ws, int* counters, cudaStream_t stream) {
  if constexpr (BM == PM && BN == PN && BK == PK)
    return run_cp_async<BM, BN, BK, OutT>(a, b, c, M, N, K, order, splits, ws, counters, stream);
  else
    return cudaErrorInvalidValue;
}
template <int BM, int BN, int BK, int PM, int PN, int PK>
cudaError_t run_f32_at(const void* a, const void* b, void* c, int M, int N, int K, int order, int splits,
                       float* ws, int* counters, cudaStream_t stream) {
  if constexpr (BM == PM && BN == PN && BK == PK)
    return run_f32<BM, BN, BK>(a, b, c, M, N, K, order, splits, ws, counters, stream);
  else
    return cudaErrorInvalidValue;
}

// One bf16 call on the TMA path: the ring kernel (persistent = 0) or the persistent one,
// with the operands' transposes (one at most) as template arguments.
template <int BM, int BN, int BK, bool PERSISTENT, typename OutT>
cudaError_t run_tma_path(int trans_a, int trans_b, const void* a, const void* b, void* c, int M, int N, int K,
                         int order, int splits, float* ws, int* counters, cudaStream_t s) {
  if (trans_a && trans_b) return cudaErrorInvalidValue;
  if constexpr (PERSISTENT) {
    if (splits != 1) return cudaErrorInvalidValue;
    if (trans_a) return run_persistent<BM, BN, BK, 1, 0, OutT>(a, b, c, M, N, K, order, s);
    if (trans_b) return run_persistent<BM, BN, BK, 0, 1, OutT>(a, b, c, M, N, K, order, s);
    return run_persistent<BM, BN, BK, 0, 0, OutT>(a, b, c, M, N, K, order, s);
  } else {
    if (trans_a) return run_tma<BM, BN, BK, 1, 0, OutT>(a, b, c, M, N, K, order, splits, ws, counters, s);
    if (trans_b) return run_tma<BM, BN, BK, 0, 1, OutT>(a, b, c, M, N, K, order, splits, ws, counters, s);
    return run_tma<BM, BN, BK, 0, 0, OutT>(a, b, c, M, N, K, order, splits, ws, counters, s);
  }
}

}  // namespace

// The compiled (BM, BN, BK) tiles, each with the tile its cp.async and f32 launches run
// (its own, but for 128 x 256 x 64). The Python side (kernels/matmul.py::_TILES,
// _PATH_TILES) lists the same and checks it against repro_matmul_tiles() when the library
// loads.
#define REPRO_MATMUL_TILES(X)   \
  X(16, 64, 128, 16, 64, 128)   \
  X(16, 128, 64, 16, 128, 64)   \
  X(32, 64, 64, 32, 64, 64)     \
  X(64, 128, 32, 64, 128, 32)   \
  X(128, 128, 32, 128, 128, 32) \
  X(128, 256, 64, 128, 128, 32)
// The tiles the persistent kernel runs (kernels/matmul.py::PERSISTENT_TILES).
#define REPRO_MATMUL_PERSISTENT_TILES(X) \
  X(128, 128, 32)                        \
  X(128, 256, 64)

extern "C" {

// Writes (bm, bn, bk, TMA ring stages, TMA smem bytes, cp.async smem bytes, f32 smem
// bytes) per compiled tile, the last two of the tile those paths run; returns the count.
int repro_matmul_tiles(int* out, int cap) {
  int n = 0;
#define X(bm, bn, bk, pm, pn, pk)                      \
  if (n < cap) {                                       \
    out[7 * n + 0] = bm;                               \
    out[7 * n + 1] = bn;                               \
    out[7 * n + 2] = bk;                               \
    out[7 * n + 3] = TmaTile<bm, bn, bk>::STAGES;      \
    out[7 * n + 4] = TmaTile<bm, bn, bk>::SMEM;        \
    out[7 * n + 5] = Bf16Tile<pm, pn, pk>::SMEM;       \
    out[7 * n + 6] = F32Tile<pm, pn, pk>::SMEM;        \
  }                                                    \
  ++n;
  REPRO_MATMUL_TILES(X)
#undef X
  return n;
}

// Writes (bm, bn, bk, ring stages, smem bytes, threads) per tile of the persistent kernel.
int repro_matmul_persistent_tiles(int* out, int cap) {
  int n = 0;
#define X(bm, bn, bk)                                 \
  if (n < cap) {                                      \
    out[6 * n + 0] = bm;                              \
    out[6 * n + 1] = bn;                              \
    out[6 * n + 2] = bk;                              \
    out[6 * n + 3] = PersistTile<bm, bn, bk>::STAGES; \
    out[6 * n + 4] = PersistTile<bm, bn, bk>::SMEM;   \
    out[6 * n + 5] = PersistTile<bm, bn, bk>::THREADS; \
  }                                                   \
  ++n;
  REPRO_MATMUL_PERSISTENT_TILES(X)
#undef X
  return n;
}

// Writes (registers a thread at launch, local-memory bytes a thread, clusters launched at
// most) of the persistent kernel at tile (bm, bn, bk), bf16 out, row-major operands.
int repro_matmul_persistent_residency(int bm, int bn, int bk, int* out) {
#define X(bm_, bn_, bk_)                                                                  \
  if (bm == bm_ && bn == bn_ && bk == bk_) {                                              \
    using P = PersistTile<bm_, bn_, bk_>;                                                 \
    auto kernel = &gemm_persistent_kernel<bm_, bn_, bk_, 0, 0, bf16>;                     \
    static std::atomic<unsigned long long> done{0};                                       \
    cudaError_t err = opt_in(kernel, P::SMEM, done);                                      \
    cudaFuncAttributes attr;                                                              \
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);                   \
    if (err != cudaSuccess) return (int)err;                                              \
    out[0] = attr.numRegs;                                                                \
    out[1] = (int)attr.localSizeBytes;                                                    \
    out[2] = resident_clusters(kernel, P::THREADS, P::SMEM);                              \
    return 0;                                                                             \
  }
  REPRO_MATMUL_PERSISTENT_TILES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// bf16 inputs; out_f32 selects an f32 (else bf16) output. order 0 = "mnk" (n tiles run
// fastest, in bands of kBand), 1 = "nmk" (m tiles fastest). kernel: 0 the cp.async one, 1
// the TMA ring, 2 the persistent TMA kernel (one split; a tile it compiles). The TMA
// kernels take (K and N multiples of 8, 16-byte aligned bases) a transposed operand:
// trans_a = 1 reads a as Aᵀ (K, M) row-major (M a multiple of 8), trans_b = 1 reads b as
// Bᵀ (N, K) row-major; not both. splits > 1 splits k across blockIdx.z: ws then holds
// splits * (output tiles) * bm * bn floats and counters one zeroed int per output tile,
// both private to the stream. The cp.async kernel runs at the tile it is given (the
// wrapper passes each config's cp.async tile).
int repro_matmul_bf16(int bm, int bn, int bk, int order, int out_f32, int kernel, int trans_a, int trans_b,
                      const void* a, const void* b, void* c, int M, int N, int K, int splits, void* ws,
                      void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* ctr = static_cast<int*>(counters);
  if (splits < 1 || (splits > 1 && (w == nullptr || ctr == nullptr))) return (int)cudaErrorInvalidValue;
  if (kernel == 0) {
    if (trans_a || trans_b) return (int)cudaErrorInvalidValue;
#define X(bm_, bn_, bk_, pm, pn, pk)                                                                     \
  if (bm == bm_ && bn == bn_ && bk == bk_ && bm == pm && bn == pn && bk == pk)                           \
    return out_f32 ? (int)run_cp_async_at<bm_, bn_, bk_, pm, pn, pk, float>(a, b, c, M, N, K, order, splits, w, \
                                                                          ctr, s)                         \
                   : (int)run_cp_async_at<bm_, bn_, bk_, pm, pn, pk, bf16>(a, b, c, M, N, K, order, splits, w,  \
                                                                         ctr, s);
    REPRO_MATMUL_TILES(X)
#undef X
    return (int)cudaErrorInvalidValue;
  }
  if (kernel == 2) {
#define X(bm_, bn_, bk_)                                                                                   \
  if (bm == bm_ && bn == bn_ && bk == bk_)                                                                 \
    return out_f32 ? (int)run_tma_path<bm_, bn_, bk_, true, float>(trans_a, trans_b, a, b, c, M, N, K, order, \
                                                                   splits, w, ctr, s)                      \
                   : (int)run_tma_path<bm_, bn_, bk_, true, bf16>(trans_a, trans_b, a, b, c, M, N, K, order,  \
                                                                  splits, w, ctr, s);
    REPRO_MATMUL_PERSISTENT_TILES(X)
#undef X
    return (int)cudaErrorInvalidValue;
  }
#define X(bm_, bn_, bk_, pm, pn, pk)                                                                      \
  if (bm == bm_ && bn == bn_ && bk == bk_)                                                                \
    return out_f32 ? (int)run_tma_path<bm_, bn_, bk_, false, float>(trans_a, trans_b, a, b, c, M, N, K, order, \
                                                                    splits, w, ctr, s)                    \
                   : (int)run_tma_path<bm_, bn_, bk_, false, bf16>(trans_a, trans_b, a, b, c, M, N, K, order,  \
                                                                   splits, w, ctr, s);
  REPRO_MATMUL_TILES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// f32 inputs and output; splits, ws and counters as for repro_matmul_bf16. Runs at the tile
// it is given (the wrapper passes each config's f32 tile).
int repro_matmul_f32(int bm, int bn, int bk, int order, const void* a, const void* b, void* c, int M, int N,
                     int K, int splits, void* ws, void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* ctr = static_cast<int*>(counters);
  if (splits < 1 || (splits > 1 && (w == nullptr || ctr == nullptr))) return (int)cudaErrorInvalidValue;
#define X(bm_, bn_, bk_, pm, pn, pk)                                        \
  if (bm == bm_ && bn == bn_ && bk == bk_ && bm == pm && bn == pn && bk == pk) \
    return (int)run_f32_at<bm_, bn_, bk_, pm, pn, pk>(a, b, c, M, N, K, order, splits, w, ctr, s);
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
