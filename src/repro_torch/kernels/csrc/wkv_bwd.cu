// Backward of the chunked RWKV6 WKV for Hopper (sm_90a): the VJP of csrc/wkv.cu's function, as a
// pair of kernels mirroring the forward's split.
//
// Replaces: no TPU kernel. The TPU kernel (src/repro/kernels/wkv.py:114 wkv_pallas) has no
// backward; the JAX package trains RWKV6 through XLA's gradient of its jnp recurrence
// (src/repro/kernels/ops.py:426, the use_pallas=False path through
// src/repro/models/rwkv.py:92 wkv_chunked). This is that gradient on the card, which
// ops.wkv's autograd op (repro_torch::wkv) runs once per layer of every RWKV6 training step.
//
// For one head and one chunk of L positions (cum: the inclusive prefix sum of logw in the
// chunk, cp_t = cum_{t-1}, S0 / S1 the chunk's start / end state, keys x values; dS1 the
// gradient of S1; A[t][tau] = sum_c r_tc k_tau,c e^{cp_tc - cum_tau,c} for tau < t;
// dA[t][tau] = do_t . v_tau for tau < t; D_t = sum_c r_tc u_c k_tc; dD_t = do_t . v_t):
//   dS0   = e^{cum_L} (.)_rows dS1 + (r e^{cp})^T do        (d(state) for the first chunk)
//   dv    = A^T do + D do + (k e^{cum_L - cum}) dS1
//   dr    = (dA (.) e^{cp_t - cum_tau}) k + dD u k + e^{cp} (do S0^T)
//   dk    = (dA (.) e^{cp_t - cum_tau})^T r + dD u r + e^{cum_L - cum} (v dS1^T)
//   du    = sum over every position of dD r k
//   dlogw_s = sum over t >= s of (g_cum_t + g_cp_{t+1}), with g_cp = r (dr - dD u k),
//           g_cum = -k (dk - dD u r), and sum_j S1 dS1 added on the chunk's last row.
// kernels/ref.py::wkv_backward_ref (kernels/wkv.py::wkv_backward_plain) is the same algorithm
// in PyTorch.
//
// The two kernels:
//   * wkv_bwd_state_kernel is the only sequential part: it walks the chunks from the last to
//     the first carrying dS (a tile of KR key rows x hd values a CTA, in registers), writes
//     each chunk's dS1 into the workspace dhs (B, H, n_chunks, hd, hd) f32 before applying the
//     chunk's step, and ends with d(state).
//   * wkv_bwd_chunk_kernel computes every chunk's gradients at once, grid (B*H, n_chunks), from
//     the forward's hs (S0; S1 is the next chunk's hs, or the final state) and dhs: dv from the
//     scores A, dr and dk from dA, each over 16 x 16 blocks of (t, tau) recomputed in shared
//     memory where they are used (dA twice), so no L x L matrix is held; then dlogw by a reverse
//     scan down each channel, and du's per-chunk partial (B, H, n_chunks, hd), which the
//     wrapper sums over B and the chunks in a fixed order.
//
// Bound on this card: at rwkv6-7b's training shape (B 8, S 128, H 64, hd 64, f32) the function
// reads r, k, v, logw, do (5 x 16.8 MB) and hs (67 MB) and writes dr, dk, dv, dlogw (4 x 16.8
// MB): ~218 MB, 65 us at 3.35 TB/s. The design's own cost is dhs (67 MB written and read) and
// the recomputed scores (~10 L hd f32 operations and ~3 L hd exponentials per position).
//
// Numerics: every exponential is of a difference <= 0 (logw is clamped to [-5, -1e-3] by the
// model, so cum decreases): e^{cp_t - cum_tau} for tau < t, e^{cp}, e^{cum_L - cum}, e^{cum_L}.
// All math is f32 FMA in a fixed order, with no atomics, so two calls on the same inputs are
// bitwise equal. No tensor cores (TF32 keeps ~1e-3 relative).
//
// Ragged tails are masked: positions past the sequence end load as zero r/k/v/do and logw 0,
// the forward's padding, and write nothing. Everything is read in the (B, S, H, hd) layout.
//
// Plain C interface, loaded with ctypes; the entry point launches both kernels on the given
// stream and returns the first cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(bf16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// the reverse pass over the chunks
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int key_rows(int HD) { return HD > 16 ? HD / 2 : HD; }

// Shared memory of one state CTA, f32: r then r e^{cp} (L, KR), logw (L, KR), do (L, HD), e^{cum_L} (KR).
template <int L, int HD>
struct BwdStateSmem {
  static constexpr int KR = key_rows(HD);
  static constexpr int FLOATS = 2 * L * KR + L * HD + KR;
  static constexpr int BYTES = FLOATS * 4;
};

template <typename T, int L, int HD>
__global__ void __launch_bounds__(kThreads)
    wkv_bwd_state_kernel(const T* __restrict__ r, const float* __restrict__ logw, const float* __restrict__ dout,
                         const float* __restrict__ ds_out, float* __restrict__ dhs, float* __restrict__ dstate,
                         int S, int H) {
  using SM = BwdStateSmem<L, HD>;
  constexpr int KR = SM::KR;
  constexpr int RGN = kThreads / HD;  // row groups: a thread holds rows rg, rg + RGN, ...
  constexpr int R = KR / RGN;
  static_assert(R * RGN == KR && RGN * HD == kThreads, "the threads hold the tile");
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;           // r, then r~ = r e^{cp}
  float* sw = sr + L * KR;    // logw
  float* so = sw + L * KR;    // do
  float* sdec = so + L * HD;  // e^{cum_L}

  const int bh = blockIdx.x, kr0 = blockIdx.y * KR;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, j = tid % HD, rg = tid / HD;
  const int n_chunks = (S + L - 1) / L;
  const size_t row = (size_t)H * HD;
  const size_t base = (size_t)b * S * row + (size_t)h * HD;

  float ds[R];
#pragma unroll
  for (int a = 0; a < R; ++a)
    ds[a] = ds_out ? ds_out[((size_t)bh * HD + kr0 + rg + RGN * a) * HD + j] : 0.f;

  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    float* dhs_c = dhs + ((size_t)bh * n_chunks + ch) * HD * HD;
#pragma unroll
    for (int a = 0; a < R; ++a) dhs_c[(size_t)(kr0 + rg + RGN * a) * HD + j] = ds[a];
    const int c0 = ch * L, rows = S - c0 < L ? S - c0 : L;
    for (int i = tid; i < L * KR; i += kThreads) {
      const int t = i / KR, c = i % KR;
      const bool in = t < rows;
      const size_t g = base + (size_t)(c0 + t) * row + kr0 + c;
      sr[i] = in ? to_f32(r[g]) : 0.f;
      sw[i] = in ? logw[g] : 0.f;
    }
    for (int i = tid; i < L * HD; i += kThreads) {
      const int t = i / HD, c = i % HD;
      so[i] = t < rows ? dout[base + (size_t)(c0 + t) * row + c] : 0.f;
    }
    __syncthreads();
    if (tid < KR) {  // one key channel a thread: r~ and e^{cum_L}
      float cum = 0.f;
      for (int t = 0; t < L; ++t) {
        sr[t * KR + tid] *= __expf(cum);
        cum += sw[t * KR + tid];
      }
      sdec[tid] = __expf(cum);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int c = rg + RGN * a;
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < L; ++t) acc = fmaf(sr[t * KR + c], so[t * HD + j], acc);
      ds[a] = fmaf(sdec[c], ds[a], acc);
    }
    __syncthreads();  // the next chunk's loads overwrite the tiles
  }
  if (dstate) {
#pragma unroll
    for (int a = 0; a < R; ++a) dstate[((size_t)bh * HD + kr0 + rg + RGN * a) * HD + j] = ds[a];
  }
}

// ---------------------------------------------------------------------------
// the chunk-parallel gradients
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int block_rows(int L) { return L < 16 ? L : 16; }

// Shared memory of one chunk CTA, f32. (L, HD) tiles and the (HD, HD) state with a row
// stride of HD + 1 floats (a column walk over 16 rows hits 16 banks); two (TB, TB) blocks.
template <int L, int HD>
struct BwdChunkSmem {
  static constexpr int P = HD + 1;
  static constexpr int TB = block_rows(L);
  static constexpr int QB = TB + 1;
  static constexpr int TILE = L * P;
  static constexpr int FLOATS = 6 * TILE + HD * P + 2 * TB * QB + 2 * L + 2 * HD;
  static constexpr int BYTES = FLOATS * 4;
};

template <typename T, typename TU, int L, int HD>
__global__ void __launch_bounds__(kThreads)
    wkv_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                         const float* __restrict__ logw, const TU* __restrict__ u, const float* __restrict__ dout,
                         const float* __restrict__ hs, const float* __restrict__ s_fin,
                         const float* __restrict__ dhs, T* __restrict__ dr, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dlogw, float* __restrict__ du_part, int S,
                         int H) {
  using SM = BwdChunkSmem<L, HD>;
  constexpr int P = SM::P, TB = SM::TB, QB = SM::QB, NB = L / TB;
  constexpr int RGN = kThreads / HD;                // row groups of a (TB, HD) block
  constexpr int RPT = (TB + RGN - 1) / RGN;         // rows of a block a thread holds
  static_assert(RGN * HD == kThreads && TB * TB <= kThreads && L % TB == 0, "layout");
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;            // r
  float* sk = sr + SM::TILE;   // k
  float* sv = sk + SM::TILE;   // v
  float* sg = sv + SM::TILE;   // do
  float* scu = sg + SM::TILE;  // logw, then cum
  float* sG = scu + SM::TILE;  // k e^{cum_L - cum} (dv), then g_cum_t + g_cp_{t+1} (dlogw)
  float* sM = sG + SM::TILE;   // dS1 (dv, dk) or S0 (dr), (HD, HD)
  float* bA = sM + HD * P;     // a (TB, TB) block of A or dA
  float* bB = bA + TB * QB;    // a (TB, TB) block of dA
  float* sD = bB + TB * QB;    // D_t
  float* sdD = sD + L;         // dD_t
  float* su = sdD + L;         // u
  float* sX = su + HD;         // sum_j S1 dS1 per key channel

  const int bh = blockIdx.x, ch = blockIdx.y, n_chunks = gridDim.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid % HD, rg = tid / HD;
  const int c0 = ch * L;
  const int rows = S - c0 < L ? S - c0 : L;
  const size_t row = (size_t)H * HD;
  const size_t first = (size_t)b * S * row + (size_t)h * HD + (size_t)c0 * row;
  const float* hs_c = hs + ((size_t)bh * n_chunks + ch) * HD * HD;
  const float* dhs_c = dhs + ((size_t)bh * n_chunks + ch) * HD * HD;
  const float* s1 = ch + 1 < n_chunks ? hs_c + HD * HD : s_fin + (size_t)bh * HD * HD;

  // 1. Loads (rows past the sequence as zeros), dS1 into sM.
  for (int i = tid; i < L * HD; i += kThreads) {
    const int t = i / HD, c = i % HD;
    const bool in = t < rows;
    const size_t g = first + (size_t)t * row + c;
    sr[t * P + c] = in ? to_f32(r[g]) : 0.f;
    sk[t * P + c] = in ? to_f32(k[g]) : 0.f;
    sv[t * P + c] = in ? to_f32(v[g]) : 0.f;
    sg[t * P + c] = in ? dout[g] : 0.f;
    scu[t * P + c] = in ? logw[g] : 0.f;
  }
  for (int i = tid; i < HD * HD; i += kThreads) sM[(i / HD) * P + i % HD] = dhs_c[i];
  for (int i = tid; i < HD; i += kThreads) su[i] = to_f32(u[(size_t)h * HD + i]);
  __syncthreads();

  // 2. cum down each channel; D and dD per position.
  if (tid < HD) {
    float cum = 0.f;
    for (int t = 0; t < L; ++t) {
      cum += scu[t * P + tid];
      scu[t * P + tid] = cum;
    }
  } else if (tid >= 128 && tid < 128 + L) {
    const int t = tid - 128;
    float d = 0.f, dd = 0.f;
    for (int c = 0; c < HD; ++c) {
      d = fmaf(sr[t * P + c] * su[c], sk[t * P + c], d);
      dd = fmaf(sg[t * P + c], sv[t * P + c], dd);
    }
    sD[t] = d;
    sdD[t] = dd;
  }
  // X_c = sum_j S1[c][j] dS1[c][j]: a warp a key row, lanes over j, summed by a fixed shuffle tree.
  for (int c = warp; c < HD; c += kThreads / 32) {
    float x = 0.f;
    for (int jj = lane; jj < HD; jj += 32) x = fmaf(__ldg(s1 + (size_t)c * HD + jj), sM[c * P + jj], x);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
    if (lane == 0) sX[c] = x;
  }
  __syncthreads();
  const float* cum_l = scu + (L - 1) * P;
  auto cp = [&](int t, int c) { return t > 0 ? scu[(t - 1) * P + c] : 0.f; };

  // One (TB, TB) block of (t, tau) = (tb TB + i, ub TB + jj), strictly causal (tau < t), zero
  // elsewhere: A (scores) into bA when `scores`, dA into `dst` when `grads`.
  auto blocks = [&](int tb, int ub, bool scores, bool grads, float* dst) {
    if (tid < TB * TB) {
      const int i = tid / TB, jj = tid % TB;
      const int t = tb * TB + i, tau = ub * TB + jj;
      float a = 0.f, da = 0.f;
      if (tau < t) {
        if (scores) {
          for (int c = 0; c < HD; ++c)
            a = fmaf(sr[t * P + c] * sk[tau * P + c], __expf(cp(t, c) - scu[tau * P + c]), a);
        }
        if (grads) {
          for (int c = 0; c < HD; ++c) da = fmaf(sg[t * P + c], sv[tau * P + c], da);
        }
      }
      if (scores) bA[i * QB + jj] = a;
      if (grads) dst[i * QB + jj] = da;
    }
  };

  // 3. dv = A^T do + D do + (k e^{cum_L - cum}) dS1, one block of tau rows at a time.
  for (int i = tid; i < L * HD; i += kThreads) {
    const int t = i / HD, c = i % HD;
    sG[t * P + c] = sk[t * P + c] * __expf(cum_l[c] - scu[t * P + c]);
  }
  for (int ub = 0; ub < NB; ++ub) {
    float acc[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
    for (int tb = ub; tb < NB; ++tb) {
      __syncthreads();
      blocks(tb, ub, true, false, nullptr);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int im = rg + RGN * m;
        if (im < TB) {
          for (int i = 0; i < TB; ++i) acc[m] = fmaf(bA[i * QB + im], sg[(tb * TB + i) * P + col], acc[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int tau = ub * TB + rg + RGN * m;
      if (rg + RGN * m < TB) {
        float x = fmaf(sD[tau], sg[tau * P + col], acc[m]);
        for (int c = 0; c < HD; ++c) x = fmaf(sG[tau * P + c], sM[c * P + col], x);
        if (tau < rows) from_f32(dv + first + (size_t)tau * row + col, x);
      }
    }
  }
  __syncthreads();

  // 4. dr = (dA (.) decay) k + dD u k + e^{cp} (do S0^T), one block of t rows at a time;
  //    g_cp_t = r_t (dr_t - dD_t u k_t) goes to sG[t - 1] (the chunk's last row starts at 0).
  for (int i = tid; i < HD * HD; i += kThreads) sM[(i / HD) * P + i % HD] = __ldg(hs_c + i);
  for (int tb = 0; tb < NB; ++tb) {
    float acc[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
    for (int ub = 0; ub <= tb; ++ub) {
      __syncthreads();
      blocks(tb, ub, false, true, bB);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int im = rg + RGN * m;
        if (im < TB) {
          const int t = tb * TB + im;
          const float cpt = cp(t, col);
          for (int jj = 0; jj < TB; ++jj) {
            const int tau = ub * TB + jj;
            if (tau < t)
              acc[m] = fmaf(bB[im * QB + jj] * sk[tau * P + col], __expf(cpt - scu[tau * P + col]), acc[m]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int im = rg + RGN * m;
      if (im < TB) {
        const int t = tb * TB + im;
        float st = 0.f;
        for (int j = 0; j < HD; ++j) st = fmaf(sM[col * P + j], sg[t * P + j], st);
        const float in = fmaf(__expf(cp(t, col)), st, acc[m]);
        if (t < rows) from_f32(dr + first + (size_t)t * row + col, fmaf(sdD[t] * su[col], sk[t * P + col], in));
        sG[((t + L - 1) % L) * P + col] = t > 0 ? sr[t * P + col] * in : 0.f;
      }
    }
  }
  __syncthreads();

  // 5. dk = (dA (.) decay)^T r + dD u r + e^{cum_L - cum} (v dS1^T), one block of tau rows at a
  //    time; g_cum_tau = -k_tau (dk_tau - dD_tau u r_tau) added to sG[tau].
  for (int i = tid; i < HD * HD; i += kThreads) sM[(i / HD) * P + i % HD] = dhs_c[i];
  for (int ub = 0; ub < NB; ++ub) {
    float acc[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
    for (int tb = ub; tb < NB; ++tb) {
      __syncthreads();
      blocks(tb, ub, false, true, bB);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int im = rg + RGN * m;
        if (im < TB) {
          const int tau = ub * TB + im;
          const float ct = scu[tau * P + col];
          for (int i = 0; i < TB; ++i) {
            const int t = tb * TB + i;
            if (t > tau) acc[m] = fmaf(bB[i * QB + im] * sr[t * P + col], __expf(cp(t, col) - ct), acc[m]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int im = rg + RGN * m;
      if (im < TB) {
        const int tau = ub * TB + im;
        float so = 0.f;
        for (int j = 0; j < HD; ++j) so = fmaf(sM[col * P + j], sv[tau * P + j], so);
        const float in = fmaf(__expf(cum_l[col] - scu[tau * P + col]), so, acc[m]);
        if (tau < rows)
          from_f32(dk + first + (size_t)tau * row + col, fmaf(sdD[tau] * su[col], sr[tau * P + col], in));
        sG[tau * P + col] -= sk[tau * P + col] * in;
      }
    }
  }
  __syncthreads();

  // 6. dlogw by a reverse scan down each channel from the last row in the sequence (X there:
  //    the rows past it hold zeros); du's partial for this chunk.
  if (tid < HD) {
    float run = sX[tid];
    for (int t = rows - 1; t >= 0; --t) {
      run += sG[t * P + tid];
      dlogw[first + (size_t)t * row + tid] = run;
    }
  } else if (tid >= 128 && tid < 128 + HD) {
    const int c = tid - 128;
    float acc = 0.f;
    for (int t = 0; t < L; ++t) acc = fmaf(sdD[t] * sr[t * P + c], sk[t * P + c], acc);
    du_part[((size_t)bh * n_chunks + ch) * HD + c] = acc;
  }
}

template <typename T, typename TU, int L, int HD>
cudaError_t run(const void* r, const void* k, const void* v, const void* logw, const void* u, const void* dout,
                const void* ds_out, const void* hs, const void* s_fin, void* dhs, void* dr, void* dk, void* dv,
                void* dlogw, void* du_part, void* dstate, int B, int S, int H, cudaStream_t stream) {
  using SS = BwdStateSmem<L, HD>;
  using SC = BwdChunkSmem<L, HD>;
  auto state_kernel = &wkv_bwd_state_kernel<T, L, HD>;
  auto chunk_kernel = &wkv_bwd_chunk_kernel<T, TU, L, HD>;
  // Above 48 KB a kernel may use dynamic shared memory only after opting in.
  cudaError_t err = cudaFuncSetAttribute(state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SS::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SC::BYTES);
  if (err != cudaSuccess) return err;
  const int n_chunks = (S + L - 1) / L;
  state_kernel<<<dim3(B * H, HD / SS::KR), kThreads, SS::BYTES, stream>>>(
      static_cast<const T*>(r), static_cast<const float*>(logw), static_cast<const float*>(dout),
      static_cast<const float*>(ds_out), static_cast<float*>(dhs), static_cast<float*>(dstate), S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_kernel<<<dim3(B * H, n_chunks), kThreads, SC::BYTES, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), static_cast<const TU*>(u), static_cast<const float*>(dout),
      static_cast<const float*>(hs), static_cast<const float*>(s_fin), static_cast<const float*>(dhs),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dlogw),
      static_cast<float*>(du_part), S, H);
  return cudaGetLastError();
}

// r/k/v type x u type: (f32, f32), (bf16, bf16) and (bf16, f32), as the forward.
template <int L, int HD>
cudaError_t run_types(int bf16_in, int u_f32, const void* r, const void* k, const void* v, const void* logw,
                      const void* u, const void* dout, const void* ds_out, const void* hs, const void* s_fin,
                      void* dhs, void* dr, void* dk, void* dv, void* dlogw, void* du_part, void* dstate, int B,
                      int S, int H, cudaStream_t s) {
  if (!bf16_in) {
    if (!u_f32) return cudaErrorInvalidValue;
    return run<float, float, L, HD>(r, k, v, logw, u, dout, ds_out, hs, s_fin, dhs, dr, dk, dv, dlogw, du_part,
                                    dstate, B, S, H, s);
  }
  return u_f32 ? run<bf16, float, L, HD>(r, k, v, logw, u, dout, ds_out, hs, s_fin, dhs, dr, dk, dv, dlogw,
                                         du_part, dstate, B, S, H, s)
               : run<bf16, bf16, L, HD>(r, k, v, logw, u, dout, ds_out, hs, s_fin, dhs, dr, dk, dv, dlogw,
                                        du_part, dstate, B, S, H, s);
}

template <int L, int HD>
constexpr int smem_bytes() {
  return BwdChunkSmem<L, HD>::BYTES > BwdStateSmem<L, HD>::BYTES ? BwdChunkSmem<L, HD>::BYTES
                                                                   : BwdStateSmem<L, HD>::BYTES;
}

}  // namespace

// The compiled chunk lengths and head dims: csrc/wkv.cu's, which kernels/wkv.py checks both
// libraries against at load.
#define REPRO_WKV_CHUNKS(X) X(8) X(16) X(32) X(64) X(128)
#define REPRO_WKV_HEAD_DIMS(X, L) X(L, 16) X(L, 64)

extern "C" {

// Writes (chunk, hd, smem bytes of the larger kernel) per compiled instantiation; returns the count.
int repro_wkv_bwd_configs(int* out, int cap) {
  int n = 0;
#define Y(L, HD)                           \
  if (n < cap) {                           \
    out[3 * n + 0] = L;                    \
    out[3 * n + 1] = HD;                   \
    out[3 * n + 2] = smem_bytes<L, HD>();  \
  }                                        \
  ++n;
#define X(L) REPRO_WKV_HEAD_DIMS(Y, L)
  REPRO_WKV_CHUNKS(X)
#undef X
#undef Y
  return n;
}

// r/k/v/logw/dout and dr/dk/dv/dlogw: (B, S, H, hd) contiguous; u: (H, hd); ds_out (may be
// null = zeros) and s_fin: (B, H, hd, hd) f32; hs (the forward's chunk start states) and dhs
// (the workspace): (B, H, ceil(S / chunk), hd, hd) f32; du_part: (B, H, ceil(S / chunk), hd)
// f32; dstate (may be null: not written): (B, H, hd, hd) f32. bf16_in: r/k/v (and dr/dk/dv)
// are bf16 (else f32); u_f32: u is f32 (else bf16).
int repro_wkv_bwd(int chunk, int hd, int bf16_in, int u_f32, const void* r, const void* k, const void* v,
                  const void* logw, const void* u, const void* dout, const void* ds_out, const void* hs,
                  const void* s_fin, void* dhs, void* dr, void* dk, void* dv, void* dlogw, void* du_part,
                  void* dstate, int B, int S, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Y(L, HD)                                                                                         \
  if (chunk == L && hd == HD)                                                                            \
    return (int)run_types<L, HD>(bf16_in, u_f32, r, k, v, logw, u, dout, ds_out, hs, s_fin, dhs, dr, dk, \
                                 dv, dlogw, du_part, dstate, B, S, H, s);
#define X(L) REPRO_WKV_HEAD_DIMS(Y, L)
  REPRO_WKV_CHUNKS(X)
#undef X
#undef Y
  return (int)cudaErrorInvalidValue;
}

const char* repro_wkv_bwd_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
