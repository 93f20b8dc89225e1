// Flash attention for Hopper (sm_90a): online-softmax attention over the leading
// (batch x head) dims, q (BH, sq, d), k/v (BH, skv, d) -> o (BH, sq, d) in q's type.
//
// Replaces: src/repro/kernels/attention.py:98 flash_attention_pallas (body _flash_kernel),
// the TPU kernel behind ops.attention and the attention kernel family. It computes the same
// function: per (batch, head) and query row i,
//   o_i = sum_j softmax_j(scale * q_i . k_j) v_j
// over the columns j that are not masked. Columns j >= skv do not exist (the TPU kernel
// padded them and filled their logits with -1e30); under the causal mask the diagonal is
// aligned to the end of KV, so row i sees j <= i + (skv - sq). The running max, the running
// sum and the accumulator are f32. One choice differs from the TPU kernel, and is the port's
// definition: a row with no visible column at all (causal with sq > skv) is zeros.
//
// Bound on this card: a causal prefill (sq = skv = S) does 2 * 2 * S * (S + 1) / 2 * d FLOP
// per head on (3 + 1) * S * d * 2 bytes of q, k, v and o: S / 4 FLOP per byte, past the
// H100's ~295 bf16 FLOP per byte once S > ~1200, so a prefill at S >= 2048 is bound by the
// tensor cores. A decode step (sq = 1) does 4 d skv FLOP on 4 d skv bytes of k and v and is
// bound by the bytes: 32 heads of 32768 cached tokens at d = 128 are 537 MB, 0.16 ms.
//
// What the design does (bf16; every shape the wrapper takes has 16-byte aligned bases and
// 128- or 256-byte rows, so every bf16 call goes through tensor maps):
//   * Split-KV (flash-decoding) wherever the grid is under the card. The grid is one CTA
//     per (block of BQ query rows, batch x head), the heaviest causal query blocks first
//     (blockIdx.x walks the query blocks in reverse, all heads of a block together), times
//     blockIdx.z splits of the KV blocks the query block needs (kv_blocks). The wrapper
//     (kernels/attention.py::kv_splits) splits only while the (query block, head) grid falls
//     short of the card's target, into whole block_kv blocks, as evenly as they go
//     (kv_ranges). Each split writes its f32 partial (m, l, acc) to a workspace; the last
//     CTA of a (query block, head) (a counter, atomicAdd after __threadfence) combines the
//     partials in split order, weighing each by exp2(m_z - max m) (0 for a split in which a
//     row saw nothing), divides by l, stores, and resets the counter. One launch per call,
//     no memset, and two calls are bitwise equal. At sq = 1 this turns 32 CTAs on 132 SMs
//     into one full wave (as many CTAs as the kernel's occupancy and ~64 KB of K/V ring an
//     SM call for), each CTA with two or three K/V stages in flight.
//   * A TMA ring fed by a producer. Q (one box per 64 columns of d) is loaded once; K and V
//     tiles of BKV rows come through 2-3 stages (3 wherever they fit in 227 KB; they do for
//     all nine configs at d <= 128), each guarded by a full and an empty mbarrier. The maps
//     are 3-D (d, rows, batch x head), so a box never crosses into the next head: rows past
//     sq or skv are zero-filled by the TMA. Boxes land 128-byte swizzled.
//   * block_q 64 and 128: one or two consumer warpgroups of 64 rows and a producer
//     warpgroup (at block_q 128, where 384 threads cap a thread at 168 registers, it gives
//     up its registers to the consumers with setmaxnreg; ptxas still compiles the consumers
//     within 168, PERF.md). S = Q K^T is a wgmma
//     m64nBKVk16 with both operands in shared memory (K is K-major: d contiguous); O += P V
//     is a wgmma m64nHDk16 with P from registers as A (the f32 S accumulator packed to bf16:
//     the accumulator layout of m64nN is, element for element, the A fragment layout of the
//     next product) and V as the MN-major B, read as the GEMM reads its B. P V of block j
//     and S of block j + 1 are issued back to back and retired by one wgmma.wait_group, after
//     which the stage of block j is released. At block_q 128 the two warpgroups ping-pong
//     (two named barriers): one issues its products only after the other has issued its
//     own, so one's softmax runs while the other's products hold the tensor cores (5-10%
//     at prefill, PERF.md). The softmax takes 2^x from the SFU alone (ex2.approx).
//   * block_q 32: two warps of mma.sync m16n8k16 (ldmatrix from the swizzled boxes), fed
//     from the same ring. A warp releases a stage only once it has waited for the next one
//     (as csrc/matmul.cu's mma.sync path does): ptxas issues an arrive placed right after a
//     stage's last ldmatrix ahead of the loads still in flight, and the producer's next TMA
//     then overwrote a V tile that was still being read (4 wrong results in 36,000 calls
//     at (1, 32, 4096, 4096, 64) on an H100, none after; scripts/attn_race.py).
//   * Masks only where they bite: a warp tests (row, column) only in the KV blocks that
//     cross the causal diagonal of its rows or the end of skv; every block wholly inside
//     runs with no per-element test.
//   * The softmax is in log2 units (the scale times log2 e on the f32 logits, exp2), the
//     row max and sum over the quad of lanes that holds a row, one division by l at the end.
//   * f32 inputs take a SIMT FMA path in full f32 (as csrc/matmul.cu does), so the f32
//     checks against the plain version can be tight: lanes split the KV columns for the
//     logits and the head dim for the accumulator, P is broadcast by shuffles. It takes no
//     split: it is the correctness path.
// What bounds each path on this card: the split path at sq = 1 by the bytes of K and V
// (the partials add BQ x (d + 8) floats per CTA, a few percent); the wgmma path at prefill
// by the tensor cores and, at d = 64, nearly as much by the SFU's exponentials, less the
// softmax time that the other warpgroup's products do not cover (PERF.md has the measured
// rates). Left for later: a TMA store of O, persistent tiles, and FA3's overlap of a
// warpgroup's softmax with its own next Q K^T (issuing that Q K^T ahead of P V measured
// 7-15% slower here: ptxas then serialises the wgmmas).
//
// Plain C interface, loaded with ctypes; the launch entry points return a cudaError_t.

#include <math.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kSmemLimit = 232448;  // bytes of shared memory one H100 CTA may use (227 KB)
constexpr int kProducerRegs = 24;   // registers a thread of the producer warpgroup keeps

// Two floats -> one register of two bf16, the first in the low half (the lower k index).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The softmax takes 2^x by ex2 (hopper.cuh): exp2f's range fix-up for results below 2^-126
// is not needed by P, at most 1 and summed into l >= 1.

template <int NF>
__device__ __forceinline__ void fence_regs(unsigned (&r)[NF][4]) {
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[f][e])::"memory");
}

// KV blocks a CTA whose rows are [q0, q0 + BQ) needs: all of them, or under the causal
// mask those up to the last column its last live row sees (0 when that row sees none).
__device__ __forceinline__ int kv_blocks(int q0, int bq, int bkv, int sq, int skv, int causal) {
  int n = (skv + bkv - 1) / bkv;
  if (causal) {
    const int last_col = min(q0 + bq, sq) - 1 + (skv - sq);
    n = last_col < 0 ? 0 : min(n, last_col / bkv + 1);
  }
  return n;
}

// ---------------------------------------------------------------------------
// wgmma: m64nNk16, bf16 in, f32 accumulate
// ---------------------------------------------------------------------------
#define ACC4(d, f) "+f"(d[f][0]), "+f"(d[f][1]), "+f"(d[f][2]), "+f"(d[f][3])

// D(64x32, f32) = (scale_d ? D : 0) + A(64x16, K-major, smem) * B(16x32, K-major, smem).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC4(d, 0), ACC4(d, 1), ACC4(d, 2), ACC4(d, 3)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x64, f32) = (scale_d ? D : 0) + A(64x16, K-major, smem) * B(16x64, K-major, smem).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC4(d, 0), ACC4(d, 1), ACC4(d, 2), ACC4(d, 3),
        ACC4(d, 4), ACC4(d, 5), ACC4(d, 6), ACC4(d, 7)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x128, f32) = (scale_d ? D : 0) + A(64x16, K-major, smem) * B(16x128, K-major, smem).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC4(d, 0), ACC4(d, 1), ACC4(d, 2), ACC4(d, 3),
        ACC4(d, 4), ACC4(d, 5), ACC4(d, 6), ACC4(d, 7),
        ACC4(d, 8), ACC4(d, 9), ACC4(d, 10), ACC4(d, 11),
        ACC4(d, 12), ACC4(d, 13), ACC4(d, 14), ACC4(d, 15)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x64, f32) += A(64x16, bf16 registers) * B(16x64, MN-major, smem).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC4(d, 0), ACC4(d, 1), ACC4(d, 2), ACC4(d, 3),
        ACC4(d, 4), ACC4(d, 5), ACC4(d, 6), ACC4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64x128, f32) += A(64x16, bf16 registers) * B(16x128, MN-major, smem).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC4(d, 0), ACC4(d, 1), ACC4(d, 2), ACC4(d, 3),
        ACC4(d, 4), ACC4(d, 5), ACC4(d, 6), ACC4(d, 7),
        ACC4(d, 8), ACC4(d, 9), ACC4(d, 10), ACC4(d, 11),
        ACC4(d, 12), ACC4(d, 13), ACC4(d, 14), ACC4(d, 15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC4

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const unsigned (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// ---------------------------------------------------------------------------
// Tile geometry shared by the kernels and the host-side launch code.
// ---------------------------------------------------------------------------
// Dynamic shared memory of the TMA kernel: 1 KB of alignment slack (swizzled boxes need
// 1024-byte alignment), Q, the ring, a Q barrier and a full and an empty barrier per stage,
// and the split flag.
constexpr int tma_smem(int q_bytes, int stage_bytes, int stages) {
  return 1024 + q_bytes + stages * stage_bytes + (2 * stages + 1) * 8 + 16;
}

template <int HD, int BQ, int BKV>
struct TmaTile {
  static constexpr bool WGMMA = BQ >= 64;            // else mma.sync (block_q 32)
  static constexpr int Q_BYTES = BQ * HD * 2;         // HD / 64 boxes of BQ rows x 128 bytes
  static constexpr int KV_BYTES = BKV * HD * 2;       // one of K or V: HD / 64 boxes of BKV rows
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int STAGES = tma_smem(Q_BYTES, STAGE, 3) <= kSmemLimit ? 3 : 2;
  static constexpr int SMEM = tma_smem(Q_BYTES, STAGE, STAGES);
  static constexpr int CONSUMERS = 2 * BQ;            // a warp per 16 rows (a warpgroup per 64)
  static constexpr int PRODUCER = WGMMA ? 128 : 32;   // setmaxnreg acts on whole warpgroups
  static constexpr int THREADS = CONSUMERS + PRODUCER;
  // setmaxnreg at block_q 128, where 384 threads cap a thread at 168 registers: the
  // producer warpgroup keeps kProducerRegs and the consumers take the rest. At block_q 64
  // the 256 threads may hold 255 each and nothing needs moving.
  static constexpr bool REBALANCE = BQ == 128;
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int CONSUMER_REGS = (LAUNCH_REGS * THREADS - kProducerRegs * PRODUCER) / CONSUMERS / 8 * 8;
  static_assert(HD % 64 == 0 && BQ % 32 == 0 && BKV % 32 == 0 && BKV <= 128, "bad attention tile");
  static_assert(SMEM <= kSmemLimit, "attention tile does not fit in shared memory");
  static_assert(!REBALANCE || CONSUMER_REGS <= 256, "setmaxnreg takes at most 256");
};

template <int HD, int BQ, int BKV>
struct F32Tile {
  static constexpr int THREADS = BQ / 16 * 32;
  static constexpr int F32_STRIDE = HD + 1;  // lanes read K and V columns: conflict-free
  static constexpr int SMEM_F32 = (BQ * HD + 2 * BKV * F32_STRIDE) * 4;
  static_assert(BQ % 16 == 0 && BKV % 32 == 0 && HD % 32 == 0, "bad attention tile");
};

// ---------------------------------------------------------------------------
// Pieces shared by the wgmma and mma.sync consumers. A consumer thread holds its rows
// row0 and row0 + 8 in the m16n8 accumulator layout: fragment f of S (or O) holds columns
// 8f + 2t, 8f + 2t + 1, elements 0-1 for row0 and 2-3 for row0 + 8 (t = lane % 4).
// ---------------------------------------------------------------------------
// One online-softmax step over a KV block: S (raw logits) becomes P = exp2(scaled S - new
// max) and l is rescaled by corr = exp2(old max - new max); rescale() applies corr to O.
// MASK tests every (row, column).
template <bool MASK, int NS>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4], float (&m)[2], float (&l)[2], float (&corr)[2],
                                             int row0, int col0, int skv, int offset, int causal,
                                             float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * scale_log2;
      if (MASK) {
        const int row = row0 + 8 * (e >> 1), col = col0 + nt * 8 + (e & 1);
        if (col >= skv || (causal && col > row + offset)) x = -INFINITY;
      }
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    base[h] = mx[h] == -INFINITY ? 0.f : mx[h];  // a row with nothing visible yet
    corr[h] = exp2f(m[h] - base[h]);             // 0 when m was -inf
    m[h] = mx[h];
    l[h] *= corr[h];
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(s[nt][e] - base[e >> 1]);
      s[nt][e] = p;
      l[e >> 1] += p;
    }
  }
}

// masked: whether a block [kv0, kv0 + BKV) needs the per-element test for a warp whose
// first row is wrow0 (it crosses the end of skv or the causal diagonal of one of its rows).
template <int NS>
__device__ __forceinline__ void softmax(bool masked, float (&s)[NS][4], float (&m)[2], float (&l)[2],
                                        float (&corr)[2], int row0, int col0, int skv, int offset, int causal,
                                        float scale_log2) {
  if (masked)
    softmax_step<true>(s, m, l, corr, row0, col0, skv, offset, causal, scale_log2);
  else
    softmax_step<false>(s, m, l, corr, row0, col0, skv, offset, causal, scale_log2);
}

template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO][4], const float (&corr)[2]) {
#pragma unroll
  for (int dt = 0; dt < NO; ++dt) {
    o[dt][0] *= corr[0];
    o[dt][1] *= corr[0];
    o[dt][2] *= corr[1];
    o[dt][3] *= corr[1];
  }
}

// The end of every bf16 CTA: l summed over the quad; with one split, O / l is stored
// (zeros where l = 0). With several, the partial (O, m, l) goes to the workspace slot
// (tile, split) in thread order (coalesced 16-byte stores), and the last CTA of the tile
// combines the slots in split order, stores, and resets the tile's counter.
template <int HD, int NC>
__device__ __forceinline__ void finish(float (&o)[HD / 8][4], const float (&m)[2], float (&l)[2],
                                       bool active, bf16* Ob, int row0, int t, int sq, int tile,
                                       float* ws, int* counters, int ctid, volatile int* flag) {
  constexpr int NO = HD / 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const int splits = gridDim.z;
  if (splits > 1) {
    float4* tile_ws = reinterpret_cast<float4*>(ws) + (size_t)tile * splits * (NO + 1) * NC;
    if (active) {
      float4* mine = tile_ws + (size_t)blockIdx.z * (NO + 1) * NC;
#pragma unroll
      for (int f = 0; f < NO; ++f) mine[f * NC + ctid] = make_float4(o[f][0], o[f][1], o[f][2], o[f][3]);
      mine[NO * NC + ctid] = make_float4(m[0], l[0], m[1], l[1]);
    }
    __threadfence();  // this CTA's partial is visible device-wide before it is counted
    named_sync(NC);
    if (ctid == 0) *flag = atomicAdd(counters + tile, 1) == splits - 1;
    named_sync(NC);
    if (!*flag) return;
    __threadfence();  // acquire: every other split's partial is visible
    if (active) {
      float base[2] = {-INFINITY, -INFINITY};
      for (int z = 0; z < splits; ++z) {
        const float4 ml = __ldcg(tile_ws + (size_t)z * (NO + 1) * NC + NO * NC + ctid);
        base[0] = fmaxf(base[0], ml.x);
        base[1] = fmaxf(base[1], ml.z);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        base[h] = base[h] == -INFINITY ? 0.f : base[h];  // a row that saw nothing in any split
        l[h] = 0.f;
      }
#pragma unroll
      for (int f = 0; f < NO; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[f][e] = 0.f;
      for (int z = 0; z < splits; ++z) {  // in split order: the sum does not depend on who is last
        const float4* part = tile_ws + (size_t)z * (NO + 1) * NC;
        const float4 ml = __ldcg(part + NO * NC + ctid);
        const float w0 = exp2f(ml.x - base[0]), w1 = exp2f(ml.z - base[1]);  // 0 where m = -inf
        l[0] += ml.y * w0;
        l[1] += ml.w * w1;
#pragma unroll
        for (int f = 0; f < NO; ++f) {
          const float4 p = __ldcg(part + f * NC + ctid);
          o[f][0] += p.x * w0;
          o[f][1] += p.y * w0;
          o[f][2] += p.z * w1;
          o[f][3] += p.w * w1;
        }
      }
    }
    if (ctid == 0) counters[tile] = 0;  // ready for the next call on this stream
  }
  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;  // a row with no visible column is zeros
#pragma unroll
    for (int dt = 0; dt < NO; ++dt) {
      const int col = dt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(Ob + (size_t)row * HD + col) =
          __floats2bfloat162_rn(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 kernel: TMA ring, producer warp(group), wgmma or mma.sync consumers, split-KV
// ---------------------------------------------------------------------------
template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(TmaTile<HD, BQ, BKV>::THREADS, 1)
    attn_tma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ O, int bh, int sq,
                    int skv, float scale_log2, int causal, float* __restrict__ ws,
                    int* __restrict__ counters) {
  using T = TmaTile<HD, BQ, BKV>;
  extern __shared__ __align__(16) unsigned char tma_smem_raw[];
  const unsigned raw = smem_addr(tma_smem_raw);
  const unsigned q_s = (raw + 1023) & ~1023u;  // Q boxes, then the ring: 1024-byte aligned
  const unsigned ring = q_s + T::Q_BYTES;
  const unsigned full0 = ring + T::STAGES * T::STAGE;
  const unsigned empty0 = full0 + T::STAGES * 8;
  const unsigned q_bar = empty0 + T::STAGES * 8;
  volatile int* flag = reinterpret_cast<volatile int*>(tma_smem_raw + (q_bar + 8 - raw));

  const int nq = (sq + BQ - 1) / BQ;
  const int tile = blockIdx.x;
  const int q0 = (nq - 1 - tile / bh) * BQ;  // the last (heaviest causal) query blocks first
  const int head = tile % bh;
  // This split's KV blocks, [j0, j1) of the n_all the query block needs, split as evenly
  // as they go (kernels/attention.py::kv_ranges).
  const int n_all = kv_blocks(q0, BQ, BKV, sq, skv, causal);
  const int j0 = (int)((long long)n_all * blockIdx.z / gridDim.z);
  const int n = (int)((long long)n_all * (blockIdx.z + 1) / gridDim.z) - j0;
  const int offset = skv - sq;  // causal: row i sees columns j <= i + offset

  // Consumer warps that hold a live row: whole warpgroups for wgmma, warps for mma.sync.
  constexpr int UNIT_ROWS = T::WGMMA ? 64 : 16;
  const int live_units = min(BQ / UNIT_ROWS, (sq - q0 + UNIT_ROWS - 1) / UNIT_ROWS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                                 // the producer's arrive + bytes
      mbar_init(empty0 + 8 * s, live_units * UNIT_ROWS / 16);     // one arrive per live warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= T::CONSUMERS) {  // producer: one thread issues every copy
    if constexpr (T::REBALANCE) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == T::CONSUMERS && n > 0) {
      mbar_arrive_expect_tx(q_bar, T::Q_BYTES);
#pragma unroll
      for (int b = 0; b < HD / 64; ++b) tma_load_3d(q_s + b * BQ * 128, &map_q, b * 64, q0, head, q_bar);
      for (int it = 0; it < n; ++it) {
        const int s = it % T::STAGES;
        if (it >= T::STAGES) mbar_wait(empty0 + 8 * s, ((it / T::STAGES) - 1) & 1);
        const unsigned bar = full0 + 8 * s;
        mbar_arrive_expect_tx(bar, T::STAGE);
        const unsigned st = ring + s * T::STAGE;
        const int kv0 = (j0 + it) * BKV;
#pragma unroll
        for (int b = 0; b < HD / 64; ++b) {
          tma_load_3d(st + b * BKV * 128, &map_k, b * 64, kv0, head, bar);
          tma_load_3d(st + T::KV_BYTES + b * BKV * 128, &map_v, b * 64, kv0, head, bar);
        }
      }
    }
    return;
  }

  if constexpr (T::REBALANCE) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
  const int ctid = threadIdx.x, lane = ctid & 31, warp = ctid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow0 = q0 + warp * 16;  // this warp's first query row (both layouts)
  const bool active = warp * 16 / UNIT_ROWS < live_units;
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  // Rows g and g + 8 of the warp's 16: running max (scaled log2 units) and partial sums.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (active && n > 0) {
    mbar_wait(q_bar, 0);
    if constexpr (T::WGMMA) {
      const int wg = warp >> 2;
      float s[BKV / 8][4];
      unsigned p[BKV / 16][4];
      // S = Q K^T: both K-major (d contiguous), 128-byte swizzled; a k16 slice is 32 bytes
      // into a box row, the next 64 columns of d the next box; 8-row groups 1024 bytes apart.
      auto issue_s = [&](int stage) {
        const unsigned k_st = ring + stage * T::STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const unsigned qa = q_s + (kk / 4) * BQ * 128 + wg * 64 * 128 + (kk % 4) * 32;
          const unsigned kb = k_st + (kk / 4) * BKV * 128 + (kk % 4) * 32;
          wgmma_ss<BKV>(s, wgmma_desc(qa, 16, 1024, 1), wgmma_desc(kb, 16, 1024, 1), kk > 0);
        }
        wgmma_commit();
      };
      // O += P V: V is MN-major (d contiguous), 64 columns of d a box (the next box is the
      // leading offset), 8-row k groups 1024 bytes apart, k16 slices 2048 bytes apart.
      auto issue_pv = [&](int stage) {
        const unsigned v_st = ring + stage * T::STAGE + T::KV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_rs<HD>(o, p[kk], wgmma_desc(v_st + kk * 16 * 128, BKV * 128, 1024, 1));
        wgmma_commit();
      };
      // Ping-pong, where both warpgroups of block_q 128 hold live rows: a warpgroup issues
      // its products only after the other has issued its own (named barrier 2 + wg, which
      // its owner syncs on and the other warpgroup arrives at), so one's softmax runs while
      // the other's products hold the tensor cores. Warpgroup 0 goes first; warpgroup 1
      // skips its last arrive, so both barriers end complete.
      const bool pingpong = BQ == 128 && live_units == 2;
      if (pingpong && wg == 1) bar_arrive(2, 256);
      mbar_wait(full0, 0);
      issue_s(0);
      wgmma_wait<0>();
      fence_acc(s);
      for (int it = 0; it < n; ++it) {
        const int st = it % T::STAGES;
        const int kv0 = (j0 + it) * BKV;
        const bool masked = kv0 + BKV > skv || (causal && kv0 + BKV - 1 > wrow0 + offset);
        float corr[2];
        softmax(masked, s, m, l, corr, wrow0 + g, kv0 + 2 * t, skv, offset, causal, scale_log2);
        rescale(o, corr);
        // P as the A fragments of the next product: k16 slice kk is S's n8 blocks 2kk, 2kk+1.
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
        fence_acc(o);
        fence_regs(p);
        if (pingpong) bar_sync(2 + wg, 256);
        issue_pv(st);
        if (it + 1 < n) {  // block it + 1's Q K^T runs behind this block's P V
          const int st1 = (it + 1) % T::STAGES;
          mbar_wait(full0 + 8 * st1, ((it + 1) / T::STAGES) & 1);
          issue_s(st1);
        }
        if (pingpong && !(wg == 1 && it == n - 1)) bar_arrive(3 - wg, 256);
        wgmma_wait<0>();
        fence_acc(o);
        fence_acc(s);
        fence_regs(p);
        // Every read of stage st (its Q K^T and P V) has retired: release it.
        if (lane == 0) mbar_arrive(empty0 + 8 * st);
      }
    } else {
      unsigned qf[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int row = warp * 16 + (lane & 15), col = kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(qf[kk], q_s + (col >> 6) * BQ * 128 + swz128(row, (col & 63) >> 3));
      }
      for (int it = 0; it < n; ++it) {
        const int st = it % T::STAGES;
        mbar_wait(full0 + 8 * st, (it / T::STAGES) & 1);
        // Release the previous stage, not this one: its ldmatrix results fed the mma.syncs
        // of the previous iteration, all issued before this wait (an acquire, in a loop of
        // its own), so every load of that stage has landed. The last stage is never
        // released: the producer has no block left to load into it.
        if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % T::STAGES));
        const unsigned k_st = ring + st * T::STAGE, v_st = k_st + T::KV_BYTES;
        const int kv0 = (j0 + it) * BKV;
        // S = Q K^T: K is [kv][d], the col-major B; plain ldmatrix gives two n8 tiles' B.
        float s[BKV / 8][4];
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
          for (int nt = 0; nt < BKV / 8; nt += 2) {
            unsigned r[4];
            const int krow = nt * 8 + ((lane >> 4) & 1) * 8 + (lane & 7);
            const int col = kk * 16 + ((lane >> 3) & 1) * 8;
            ldmatrix_x4(r, k_st + (col >> 6) * BKV * 128 + swz128(krow, (col & 63) >> 3));
            mma_bf16_16816(s[nt], qf[kk], r[0], r[1]);
            mma_bf16_16816(s[nt + 1], qf[kk], r[2], r[3]);
          }
        }
        const bool masked = kv0 + BKV > skv || (causal && kv0 + BKV - 1 > wrow0 + offset);
        float corr[2];
        softmax(masked, s, m, l, corr, wrow0 + g, kv0 + 2 * t, skv, offset, causal, scale_log2);
        rescale(o, corr);
        // O += P V: V is [kv][d], the row-major B; ldmatrix .trans gives its fragments.
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                 pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                 pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dt = 0; dt < HD / 8; dt += 2) {
            unsigned r[4];
            const int row = kk * 16 + (lane & 15), col = dt * 8 + (lane >> 4) * 8;
            ldmatrix_x4_trans(r, v_st + (col >> 6) * BKV * 128 + swz128(row, (col & 63) >> 3));
            mma_bf16_16816(o[dt], a, r[0], r[1]);
            mma_bf16_16816(o[dt + 1], a, r[2], r[3]);
          }
        }
      }
    }
  }
  finish<HD, T::CONSUMERS>(o, m, l, active, O + (size_t)head * sq * HD, wrow0 + g, t, sq, tile, ws,
                           counters, ctid, flag);
}

// ---------------------------------------------------------------------------
// f32 SIMT kernel (full-precision FMA, no TF32)
// ---------------------------------------------------------------------------
template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(BQ / 16 * 32)
    attn_f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                    const float* __restrict__ V, float* __restrict__ O, int sq, int skv,
                    float scale, int causal) {
  using T = F32Tile<HD, BQ, BKV>;
  constexpr int NC = BKV / 32;  // KV columns per lane
  constexpr int ND = HD / 32;   // head-dim elements per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [BQ][HD]
  float* sK = sQ + BQ * HD;                        // [BKV][HD + 1]
  float* sV = sK + BKV * T::F32_STRIDE;            // [BKV][HD + 1]

  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const float* Qb = Q + bh * sq * HD;
  const float* Kb = K + bh * skv * HD;
  const float* Vb = V + bh * skv * HD;
  float* Ob = O + bh * sq * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int offset = skv - sq;
  const int n_blocks = kv_blocks(q0, BQ, BKV, sq, skv, causal);
  const int wrow0 = q0 + warp * 16;
  const bool active = wrow0 < sq;

  for (int c = tid; c < BQ * HD; c += T::THREADS) {
    const int r = c / HD;
    sQ[c] = q0 + r < sq ? Qb[(size_t)q0 * HD + c] : 0.f;
  }
  const float* q_s = sQ + warp * 16 * HD;

  float m[16], l[16], acc[16][ND];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[r][i] = 0.f;
  }

  for (int j = 0; j < n_blocks; ++j) {
    const int kv0 = j * BKV;
    __syncthreads();  // the previous block is consumed (and, at j = 0, the Q tile stored)
    for (int c = tid; c < BKV * HD; c += T::THREADS) {
      const int r = c / HD, d = c % HD;
      const bool ok = kv0 + r < skv;
      sK[r * T::F32_STRIDE + d] = ok ? Kb[(size_t)kv0 * HD + c] : 0.f;
      sV[r * T::F32_STRIDE + d] = ok ? Vb[(size_t)kv0 * HD + c] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    // Logits: lane owns columns lane + 32 * ci of the block, for all 16 rows.
    float s[16][NC];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int ci = 0; ci < NC; ++ci) s[r][ci] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float kv[NC];
#pragma unroll
      for (int ci = 0; ci < NC; ++ci) kv[ci] = sK[(lane + 32 * ci) * T::F32_STRIDE + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float qv = q_s[r * HD + d];  // broadcast
#pragma unroll
        for (int ci = 0; ci < NC; ++ci) s[r][ci] = fmaf(qv, kv[ci], s[r][ci]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = wrow0 + r;
      float mx = m[r];
#pragma unroll
      for (int ci = 0; ci < NC; ++ci) {
        const int col = kv0 + lane + 32 * ci;
        const bool ok = col < skv && (!causal || col <= row + offset);
        s[r][ci] = ok ? s[r][ci] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][ci]);
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float base = mx == -INFINITY ? 0.f : mx;
      const float corr = expf(m[r] - base);
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[r][i] *= corr;
#pragma unroll
      for (int ci = 0; ci < NC; ++ci) {
        s[r][ci] = expf(s[r][ci] - base);
        l[r] += s[r][ci];
      }
    }
    // acc += P V: lane owns head-dim elements lane + 32 * i; P comes by shuffle from the
    // lane that owns its column.
#pragma unroll
    for (int ci = 0; ci < NC; ++ci) {
      for (int src = 0; src < 32; ++src) {
        const float* v_row = sV + (ci * 32 + src) * T::F32_STRIDE;
        float vv[ND];
#pragma unroll
        for (int i = 0; i < ND; ++i) vv[i] = v_row[lane + 32 * i];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float p = __shfl_sync(0xffffffffu, s[r][ci], src);
#pragma unroll
          for (int i = 0; i < ND; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float lr = l[r];
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) lr += __shfl_xor_sync(0xffffffffu, lr, w);
    const int row = wrow0 + r;
    if (row >= sq) continue;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;  // a row with no visible column is zeros
#pragma unroll
    for (int i = 0; i < ND; ++i) Ob[(size_t)row * HD + lane + 32 * i] = acc[r][i] * inv;
  }
}


// ---------------------------------------------------------------------------
// host-side launch
// ---------------------------------------------------------------------------
// The TMA kernel of one config, opted in to its shared memory; checked, where it moves
// registers with setmaxnreg, to have been compiled with what the launch bounds give it.
typedef decltype(&attn_tma_kernel<64, 32, 32>) TmaKernel;  // every config's has this type

template <int HD, int BQ, int BKV>
cudaError_t tma_kernel(TmaKernel* out) {
  using T = TmaTile<HD, BQ, BKV>;
  auto kernel = &attn_tma_kernel<HD, BQ, BKV>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = opt_in(kernel, T::SMEM, done);
  if (err != cudaSuccess) return err;
  if constexpr (T::REBALANCE) {
    // setmaxnreg moves registers only within what the CTA was launched with: a kernel
    // compiled with fewer than LAUNCH_REGS a thread would wait forever in setmaxnreg.inc.
    static std::atomic<int> regs{0};
    if (regs.load(std::memory_order_relaxed) == 0) {
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, kernel);
      if (err != cudaSuccess) return err;
      regs.store(attr.numRegs);
    }
    if (regs.load(std::memory_order_relaxed) < T::LAUNCH_REGS) return cudaErrorInvalidConfiguration;
  }
  *out = kernel;
  return cudaSuccess;
}

template <int HD, int BQ, int BKV>
cudaError_t run_tma(const void* q, const void* k, const void* v, void* o, int bh, int sq, int skv,
                    float scale, int causal, int splits, float* ws, int* counters, cudaStream_t stream) {
  using T = TmaTile<HD, BQ, BKV>;
  // q (bh, sq, HD) and k/v (bh, skv, HD) as 3-D maps, innermost first: a box is 64 columns
  // (128 bytes, one swizzle row) by BQ or BKV rows of one head.
  const uint64_t dims_q[3] = {HD, (uint64_t)sq, (uint64_t)bh}, dims_kv[3] = {HD, (uint64_t)skv, (uint64_t)bh};
  const uint32_t box_q[3] = {64, BQ, 1}, box_kv[3] = {64, BKV, 1};
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = tensor_map(&map_q, q, 3, dims_q, box_q, 128);
  if (err == cudaSuccess) err = tensor_map(&map_k, k, 3, dims_kv, box_kv, 128);
  if (err == cudaSuccess) err = tensor_map(&map_v, v, 3, dims_kv, box_kv, 128);
  if (err != cudaSuccess) return err;
  TmaKernel kernel;
  err = tma_kernel<HD, BQ, BKV>(&kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid(((sq + BQ - 1) / BQ) * bh, 1, splits);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(map_q, map_k, map_v, static_cast<bf16*>(o), bh, sq, skv,
                                                scale * 1.4426950408889634f, causal, ws, counters);
  return cudaGetLastError();
}

// CTAs of the TMA kernel one SM holds at once (registers, shared memory, threads).
template <int HD, int BQ, int BKV>
int tma_occupancy() {
  TmaKernel kernel;
  int n = 0;
  if (tma_kernel<HD, BQ, BKV>(&kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, TmaTile<HD, BQ, BKV>::THREADS,
                                                    TmaTile<HD, BQ, BKV>::SMEM) != cudaSuccess)
    return -1;
  return n;
}

template <int HD, int BQ, int BKV>
cudaError_t run_f32(const void* q, const void* k, const void* v, void* o, int bh, int sq, int skv,
                    float scale, int causal, cudaStream_t stream) {
  using T = F32Tile<HD, BQ, BKV>;
  auto kernel = &attn_f32_kernel<HD, BQ, BKV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_F32);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, T::THREADS, T::SMEM_F32, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, skv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// The compiled (block_q, block_kv) configs, each for head dims 64 and 128. The Python side
// (kernels/attention.py::_BLOCK_Q, _BLOCK_KV, _HEAD_DIMS) lists the same set and checks it
// against repro_attention_configs() when the library loads.
#define REPRO_ATTENTION_CONFIGS(X) \
  X(32, 32)                        \
  X(32, 64)                        \
  X(32, 128)                       \
  X(64, 32)                        \
  X(64, 64)                        \
  X(64, 128)                       \
  X(128, 32)                       \
  X(128, 64)                       \
  X(128, 128)
#define REPRO_ATTENTION_HEAD_DIMS(Y, bq, bkv) Y(64, bq, bkv) Y(128, bq, bkv)

extern "C" {

// Writes (block_q, block_kv, head dim, bf16 threads, bf16 stages, bf16 smem bytes, f32
// threads, f32 smem bytes) per instantiation; returns the count.
int repro_attention_configs(int* out, int cap) {
  int n = 0;
#define Y(hd, bq, bkv)                                  \
  if (n < cap) {                                        \
    out[8 * n + 0] = bq;                                \
    out[8 * n + 1] = bkv;                               \
    out[8 * n + 2] = hd;                                \
    out[8 * n + 3] = TmaTile<hd, bq, bkv>::THREADS;     \
    out[8 * n + 4] = TmaTile<hd, bq, bkv>::STAGES;      \
    out[8 * n + 5] = TmaTile<hd, bq, bkv>::SMEM;        \
    out[8 * n + 6] = F32Tile<hd, bq, bkv>::THREADS;     \
    out[8 * n + 7] = F32Tile<hd, bq, bkv>::SMEM_F32;    \
  }                                                     \
  ++n;
#define X(bq, bkv) REPRO_ATTENTION_HEAD_DIMS(Y, bq, bkv)
  REPRO_ATTENTION_CONFIGS(X)
#undef X
#undef Y
  return n;
}

// q (bh, sq, hd), k/v (bh, skv, hd), o (bh, sq, hd), all contiguous, 16-byte aligned bases;
// f32 selects the f32 kernel (else bf16). causal aligns the diagonal to the end of KV.
// splits > 1 (bf16 only) splits each query block's KV blocks across blockIdx.z: ws then
// holds splits * ceil(sq / bq) * bh * bq * (hd + 8) floats and counters one zeroed int per
// (query block, head), both private to the stream.
int repro_attention(int bq, int bkv, int hd, int f32, const void* q, const void* k, const void* v,
                    void* o, int bh, int sq, int skv, float scale, int causal, int splits, void* ws,
                    void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* ctr = static_cast<int*>(counters);
  if (splits < 1 || (splits > 1 && (f32 || w == nullptr || ctr == nullptr))) return (int)cudaErrorInvalidValue;
#define Y(hd_, bq_, bkv_)                                                                            \
  if (bq == bq_ && bkv == bkv_ && hd == hd_)                                                         \
    return f32 ? (int)run_f32<hd_, bq_, bkv_>(q, k, v, o, bh, sq, skv, scale, causal, s)             \
               : (int)run_tma<hd_, bq_, bkv_>(q, k, v, o, bh, sq, skv, scale, causal, splits, w, ctr, s);
#define X(bq_, bkv_) REPRO_ATTENTION_HEAD_DIMS(Y, bq_, bkv_)
  REPRO_ATTENTION_CONFIGS(X)
#undef X
#undef Y
  return (int)cudaErrorInvalidValue;
}

// CTAs of the bf16 kernel of (bq, bkv, hd) one SM of the current device holds at once;
// -1 on an error or an unknown config.
int repro_attention_occupancy(int bq, int bkv, int hd) {
#define Y(hd_, bq_, bkv_) \
  if (bq == bq_ && bkv == bkv_ && hd == hd_) return tma_occupancy<hd_, bq_, bkv_>();
#define X(bq_, bkv_) REPRO_ATTENTION_HEAD_DIMS(Y, bq_, bkv_)
  REPRO_ATTENTION_CONFIGS(X)
#undef X
#undef Y
  return -1;
}

const char* repro_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
