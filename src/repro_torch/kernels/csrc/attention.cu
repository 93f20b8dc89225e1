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
// Bound on this card: at a causal prefill (sq = skv = S) the two products take
// 2 * 2 * S * (S + 1) / 2 * d FLOP per head, against (3 + 1) * S * d * 2 bytes of q, k, v and
// o: S / 4 FLOP per byte, past the H100's ~295 bf16 FLOP per byte once S > ~1200. So a
// prefill at S >= 2048 is bound by the tensor cores (granite-8b, S = 4096, 32 heads:
// 137 GFLOP, 0.14 ms at 989 TFLOP/s), and a short prefill or a decode step (sq = 1: 4 d skv
// FLOP per 4 d skv bytes of k and v) by the bytes.
//
// What the design does:
//   * Grid: one CTA per (block of BQ query rows, batch x head), one warp per 16 rows. Each
//     CTA loops over the KV blocks itself (the TPU's sequential KV grid axis with m, l and
//     acc in VMEM scratch becomes a loop with m, l and acc in registers; nothing carries
//     between CTAs).
//   * The Q tile goes to shared memory once and into registers (ldmatrix) at the first
//     block; K and V tiles of BKV rows come through a 2-stage cp.async ring, so block j + 1
//     loads while block j is computed.
//   * bf16: S = Q K^T and O += P V on the tensor cores (mma.sync m16n8k16, bf16 -> f32). The
//     f32 S accumulator of two n8 tiles is, element for element, the A fragment of the next
//     product, so P goes to bf16 in registers and never touches shared memory. The scale is
//     applied to the f32 logits (times log2 e, so exp2 serves), masks set -inf, the row max
//     and row sum are taken over the quad of lanes that holds a row (two shuffles), and the
//     output is divided by l once, at the end.
//   * Causal: KV blocks wholly above the diagonal for every row of the CTA are never loaded
//     (the same function with less work); a warp whose 16 rows all lie past sq skips the
//     products.
//   * Ragged sq and skv are masked, not padded: cp.async zero-fills rows past the end, the
//     mask removes their columns, and rows past sq are not stored.
//   * f32 inputs take a SIMT FMA path in full f32 (as csrc/matmul.cu does), so the f32
//     checks against the plain version can be tight: lanes split the KV columns for the
//     logits and the head dim for the accumulator, P is broadcast by shuffles.
// Not done yet (later PRs): wgmma and TMA, split-KV for decode (at sq = 1 a CTA serves one
// head and 15 of its warp's 16 rows idle, so a decode step is latency-bound by construction),
// a persistent schedule.
//
// Plain C interface, loaded with ctypes; the launch entry points return a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; pred = false zero-fills the destination without reading.
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

// Two floats -> one register of two bf16, the first in the low half (the lower k index).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
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
// Tile geometry shared by the kernels and the host-side launch code.
// ---------------------------------------------------------------------------
template <int HD, int BQ, int BKV>
struct AttnTile {
  static constexpr int WARPS = BQ / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int STRIDE = HD + 8;  // padded bf16 smem row (elements): ldmatrix conflict-free
  static constexpr int Q_ELEMS = BQ * STRIDE;
  static constexpr int KV_ELEMS = BKV * STRIDE;
  static constexpr int SMEM_BF16 = (Q_ELEMS + 4 * KV_ELEMS) * 2;  // Q + 2 stages x (K, V)
  static constexpr int F32_STRIDE = HD + 1;  // lanes read K and V columns: conflict-free
  static constexpr int SMEM_F32 = (BQ * HD + 2 * BKV * F32_STRIDE) * 4;
  static_assert(BQ % 16 == 0 && BKV % 32 == 0 && HD % 32 == 0, "bad attention tile");
};

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------
template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(BQ / 16 * 32)
    attn_bf16_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                     const bf16* __restrict__ V, bf16* __restrict__ O, int sq, int skv,
                     float scale_log2, int causal) {
  using T = AttnTile<HD, BQ, BKV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + T::Q_ELEMS;       // [2][BKV][STRIDE]
  bf16* sV = sK + 2 * T::KV_ELEMS;  // [2][BKV][STRIDE]

  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const bf16* Qb = Q + bh * sq * HD;
  const bf16* Kb = K + bh * skv * HD;
  const bf16* Vb = V + bh * skv * HD;
  bf16* Ob = O + bh * sq * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int offset = skv - sq;  // causal: row i sees columns j <= i + offset
  const int n_blocks = kv_blocks(q0, BQ, BKV, sq, skv, causal);

  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  auto load_rows = [&](bf16* dst, const bf16* src, int row0, int n_rows, int rows) {
    for (int c = tid; c < rows * CPR; c += T::THREADS) {
      const int r = c / CPR, cc = (c % CPR) * 8;
      const bool ok = row0 + r < n_rows;
      cp_async16(dst + r * T::STRIDE + cc, ok ? src + (size_t)(row0 + r) * HD + cc : src, ok);
    }
  };

  if (n_blocks > 0) {
    load_rows(sQ, Qb, q0, sq, BQ);
    load_rows(sK, Kb, 0, skv, BKV);
    load_rows(sV, Vb, 0, skv, BKV);
  }
  cp_async_commit();

  const int wrow0 = q0 + warp * 16;  // this warp's first query row
  const bool active = wrow0 < sq;
  unsigned qf[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  // Rows g and g + 8 of the warp's 16: running max (scaled log2 units) and partial sums.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_blocks; ++j) {
    const int st = j & 1;
    if (j + 1 < n_blocks) {  // the stage read in iteration j - 1 is free (barrier below)
      load_rows(sK + (st ^ 1) * T::KV_ELEMS, Kb, (j + 1) * BKV, skv, BKV);
      load_rows(sV + (st ^ 1) * T::KV_ELEMS, Vb, (j + 1) * BKV, skv, BKV);
    }
    cp_async_commit();
    cp_async_wait<1>();  // block j (and at j = 0 the Q tile) has landed ...
    __syncthreads();     // ... for every thread's copies
    if (active) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * T::STRIDE + kk * 16 + (lane >> 4) * 8);
      }
      const bf16* k_s = sK + st * T::KV_ELEMS;
      const bf16* v_s = sV + st * T::KV_ELEMS;

      // S = Q K^T: K is stored [kv][d], i.e. column-major B; plain ldmatrix gives the B
      // fragments of two n8 tiles at once.
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
          ldmatrix_x4(r, k_s + krow * T::STRIDE + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[nt], qf[kk], r[0], r[1]);
          mma_bf16_16816(s[nt + 1], qf[kk], r[2], r[3]);
        }
      }

      // Scale, mask, and the new row max. Accumulator element e of tile nt holds
      // row g + 8 * (e >> 1), column nt * 8 + 2t + (e & 1).
      const int kv0 = j * BKV;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wrow0 + g + 8 * (e >> 1);
          const int col = kv0 + nt * 8 + 2 * t + (e & 1);
          const bool ok = col < skv && (!causal || col <= row + offset);
          const float x = ok ? s[nt][e] * scale_log2 : -INFINITY;
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2], base[2];
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
      for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nt][e] - base[e >> 1]);
          s[nt][e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        o[dt][0] *= corr[0];
        o[dt][1] *= corr[0];
        o[dt][2] *= corr[1];
        o[dt][3] *= corr[1];
      }

      // O += P V: V is stored [kv][d], row-major B; ldmatrix .trans gives its fragments.
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dt = 0; dt < HD / 8; dt += 2) {
          unsigned r[4];
          ldmatrix_x4_trans(r, v_s + (kk * 16 + (lane & 15)) * T::STRIDE + dt * 8 + (lane >> 4) * 8);
          mma_bf16_16816(o[dt], a, r[0], r[1]);
          mma_bf16_16816(o[dt + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // everyone is done with stage st before iteration j + 1 refills it
  }
  cp_async_wait<0>();

  if (!active) return;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;  // a row with no visible column is zeros
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow0 + g + 8 * h;
    if (row >= sq) continue;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      __nv_bfloat162 v = __floats2bfloat162_rn(o[dt][2 * h] * inv[h], o[dt][2 * h + 1] * inv[h]);
      *reinterpret_cast<__nv_bfloat162*>(Ob + (size_t)row * HD + col) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// f32 SIMT kernel (full-precision FMA, no TF32)
// ---------------------------------------------------------------------------
template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(BQ / 16 * 32)
    attn_f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                    const float* __restrict__ V, float* __restrict__ O, int sq, int skv,
                    float scale, int causal) {
  using T = AttnTile<HD, BQ, BKV>;
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
template <int HD, int BQ, int BKV>
cudaError_t run_bf16(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                     int skv, float scale, int causal, cudaStream_t stream) {
  using T = AttnTile<HD, BQ, BKV>;
  auto kernel = &attn_bf16_kernel<HD, BQ, BKV>;
  // Above 48 KB a kernel may use dynamic shared memory only after opting in.
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BF16);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, T::THREADS, T::SMEM_BF16, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sq, skv, scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

template <int HD, int BQ, int BKV>
cudaError_t run_f32(const void* q, const void* k, const void* v, void* o, int bh, int sq, int skv,
                    float scale, int causal, cudaStream_t stream) {
  using T = AttnTile<HD, BQ, BKV>;
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

// Writes (block_q, block_kv, head dim, threads, bf16 smem bytes, f32 smem bytes) per
// instantiation; returns the count.
int repro_attention_configs(int* out, int cap) {
  int n = 0;
#define Y(hd, bq, bkv)                                   \
  if (n < cap) {                                         \
    out[6 * n + 0] = bq;                                 \
    out[6 * n + 1] = bkv;                                \
    out[6 * n + 2] = hd;                                 \
    out[6 * n + 3] = AttnTile<hd, bq, bkv>::THREADS;     \
    out[6 * n + 4] = AttnTile<hd, bq, bkv>::SMEM_BF16;   \
    out[6 * n + 5] = AttnTile<hd, bq, bkv>::SMEM_F32;    \
  }                                                      \
  ++n;
#define X(bq, bkv) REPRO_ATTENTION_HEAD_DIMS(Y, bq, bkv)
  REPRO_ATTENTION_CONFIGS(X)
#undef X
#undef Y
  return n;
}

// q (bh, sq, hd), k/v (bh, skv, hd), o (bh, sq, hd), all contiguous; f32 selects the f32
// kernel (else bf16). causal aligns the diagonal to the end of KV.
int repro_attention(int bq, int bkv, int hd, int f32, const void* q, const void* k,
                    const void* v, void* o, int bh, int sq, int skv, float scale, int causal,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Y(hd_, bq_, bkv_)                                                                  \
  if (bq == bq_ && bkv == bkv_ && hd == hd_)                                               \
    return f32 ? (int)run_f32<hd_, bq_, bkv_>(q, k, v, o, bh, sq, skv, scale, causal, s)   \
               : (int)run_bf16<hd_, bq_, bkv_>(q, k, v, o, bh, sq, skv, scale, causal, s);
#define X(bq_, bkv_) REPRO_ATTENTION_HEAD_DIMS(Y, bq_, bkv_)
  REPRO_ATTENTION_CONFIGS(X)
#undef X
#undef Y
  return (int)cudaErrorInvalidValue;
}

const char* repro_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
