// Chunked RWKV6 WKV recurrence for Hopper (sm_90a), one CTA per (batch, head).
//
// Replaces: src/repro/kernels/wkv.py::wkv_pallas (body _wkv_kernel), the TPU kernel behind
// ops.wkv, which RWKV6LM.prefill runs once per layer. It computes the same function as the
// reference's models/rwkv.py::wkv_chunked: for every position t of one head,
//   o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(e^{logw_t}) S_{t-1} + k_t v_t^T,
// with S_{-1} the given (hd, hd) f32 state (keys x values), in f32 throughout, and returns
// every o_t and the final state. The sequence is cut into chunks of L positions: inside a
// chunk the recurrence is a small causal quadratic form, and the state carries across.
//
// Bound on this card: at a batch-1 prefill of rwkv6-7b (64 heads, hd 64, bf16 r/k/v) one
// call moves ~64 x (3*S*64*2 + 2*S*64*4 + 2*64*64*4) bytes (9.45 MB at S = 128: 2.8 us at
// 3.35 TB/s) and does ~5*hd^2 f32 operations per token and head (the recurrent form's
// count: 2.5 us at 67 TFLOP/s f32), so it is bytes-bound at the served lengths. This
// design does not reach that bound: it is latency-bound. Only B*H CTAs exist (64 at a
// batch-1 prefill, on 132 SMs), and each walks its chunks in order.
//
// What the design does:
//   * One CTA per (batch, head) with a loop over chunks in place of the TPU's sequential
//     grid axis. The (hd, hd) f32 state stays in shared memory for the whole sequence:
//     read once at the start, written once at the end.
//   * r/k/v/logw are read in the (B, S, H, hd) layout directly (row stride H*hd), so
//     there is no transpose copy. r/k/v arrive in the model dtype (bf16 or f32), logw
//     and the state in f32, u in the param dtype; all math is f32.
//   * The ragged tail is masked, not padded: rows past the sequence end load as zero
//     r/k/v and logw 0, which is the reference's padding, exact for any length.
//   * Numerics: every decay factor is the exponential of a difference that is <= 0
//     (logw is clamped to [-5, -1e-3] by the model): e^{cum_{t-1} - cum_tau} for the
//     intra-chunk scores (tau < t), e^{cum_{t-1}} for the incoming state, e^{cum_L -
//     cum_tau} for the state update. The reference kernel's single-midpoint factoring
//     (e^{cum - m} * e^{m - cum'}) reaches e^{|logw| L / 2} and overflows f32 at
//     chunk 64-128; this one stays finite at every chunk size. The price is one exp per
//     (t, tau, channel) term of the scores, L^2/2 * hd per chunk, so the cost per token
//     grows with L.
// Not done yet (later PRs): tensor cores (mma/wgmma) for the three chunk products, TMA,
// splitting a head's channels or chunks across CTAs to fill the card.
//
// Plain C interface, loaded with ctypes; the launch entry point returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Shared-memory layout of one CTA. Chunk tiles are (L, HD) f32 with a padded row stride,
// so the threads of a warp that walk one channel down different rows hit distinct banks.
template <int L, int HD>
struct WkvSmem {
  static constexpr int P = HD + 1;     // padded row stride (floats)
  static constexpr int TILE = L * P;   // one (L, HD) chunk tile
  static constexpr int FLOATS = 4 * TILE + L * L + HD * HD + 2 * HD;
  static constexpr int BYTES = FLOATS * 4;
};

template <typename T, typename TU, int L, int HD>
__global__ void __launch_bounds__(kThreads)
    wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ logw, const TU* __restrict__ u,
               const float* __restrict__ s0, float* __restrict__ o, float* __restrict__ s_out,
               int S, int H) {
  using SM = WkvSmem<L, HD>;
  constexpr int P = SM::P;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;              // r_t, then r~_t = r_t e^{cum_{t-1}}
  float* sk = sr + SM::TILE;     // k_t, then k^_t = k_t e^{cum_L - cum_t}
  float* sv = sk + SM::TILE;     // v_t
  float* sc = sv + SM::TILE;     // cum_t = sum_{tau <= t} logw_tau within the chunk
  float* sa = sc + SM::TILE;     // A (L, L): causal scores, u-bonus on the diagonal
  float* ss = sa + L * L;        // the state (HD, HD), keys x values
  float* su = ss + HD * HD;      // u of this head
  float* sl = su + HD;           // cum_L, the chunk's total log-decay per channel

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const size_t row = (size_t)H * HD;                      // elements between positions
  const size_t base = (size_t)b * S * row + (size_t)h * HD;  // element (b, 0, h, 0)

  for (int i = tid; i < HD * HD; i += kThreads) ss[i] = s0 ? s0[(size_t)bh * HD * HD + i] : 0.f;
  for (int i = tid; i < HD; i += kThreads) su[i] = to_f32(u[(size_t)h * HD + i]);

  for (int c0 = 0; c0 < S; c0 += L) {
    // 1. Load the chunk. Rows past the end are the reference's padding: zero r/k/v, logw 0.
    for (int i = tid; i < L * HD; i += kThreads) {
      const int t = i / HD, c = i % HD;
      const int p = c0 + t;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 0.f;
      if (p < S) {
        const size_t g = base + (size_t)p * row + c;
        rv = to_f32(r[g]);
        kv = to_f32(k[g]);
        vv = to_f32(v[g]);
        wv = logw[g];
      }
      sr[t * P + c] = rv;
      sk[t * P + c] = kv;
      sv[t * P + c] = vv;
      sc[t * P + c] = wv;
    }
    __syncthreads();

    // 2. Inclusive prefix sum of logw down each channel.
    if (tid < HD) {
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < L; ++t) {
        acc += sc[t * P + tid];
        sc[t * P + tid] = acc;
      }
      sl[tid] = acc;
    }
    __syncthreads();

    // 3. Scores. A[t][tau] = sum_c r_tc k_tau,c e^{cum_{t-1},c - cum_tau,c} for tau < t
    //    (exponent <= 0), A[t][t] = sum_c r_tc u_c k_tc (the bonus), 0 above the diagonal.
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, j = i % L;
      const float* rt = sr + t * P;
      float acc = 0.f;
      if (j < t) {
        const float* kj = sk + j * P;
        const float* ct = sc + (t - 1) * P;
        const float* cj = sc + j * P;
#pragma unroll 8
        for (int c = 0; c < HD; ++c) acc += rt[c] * kj[c] * expf(ct[c] - cj[c]);
      } else if (j == t) {
        const float* kt = sk + t * P;
#pragma unroll 8
        for (int c = 0; c < HD; ++c) acc += rt[c] * (su[c] * kt[c]);
      }
      sa[i] = acc;
    }
    __syncthreads();

    // 4. In place: r~_t = r_t e^{cum_{t-1}} (incoming-state term), k^_t = k_t e^{cum_L -
    //    cum_t} (state update). Both exponents are <= 0.
    for (int i = tid; i < L * HD; i += kThreads) {
      const int t = i / HD, c = i % HD;
      const float cprev = t > 0 ? sc[(t - 1) * P + c] : 0.f;
      sr[t * P + c] *= expf(cprev);
      sk[t * P + c] *= expf(sl[c] - sc[t * P + c]);
    }
    __syncthreads();

    // 5. o_t = sum_{tau <= t} A[t][tau] v_tau + r~_t . S, for the rows inside the sequence.
    for (int i = tid; i < L * HD; i += kThreads) {
      const int t = i / HD, vc = i % HD;
      const int p = c0 + t;
      if (p >= S) continue;
      float acc = 0.f;
      for (int j = 0; j <= t; ++j) acc += sa[t * L + j] * sv[j * P + vc];
      float acc_s = 0.f;
#pragma unroll 8
      for (int c = 0; c < HD; ++c) acc_s += sr[t * P + c] * ss[c * HD + vc];
      o[base + (size_t)p * row + vc] = acc + acc_s;
    }
    __syncthreads();

    // 6. S' = e^{cum_L} (.)_rows S + sum_tau k^_tau v_tau^T.
    for (int i = tid; i < HD * HD; i += kThreads) {
      const int c = i / HD, vc = i % HD;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < L; ++j) acc += sk[j * P + c] * sv[j * P + vc];
      ss[i] = expf(sl[c]) * ss[i] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < HD * HD; i += kThreads) s_out[(size_t)bh * HD * HD + i] = ss[i];
}

template <typename T, typename TU, int L, int HD>
cudaError_t run(const void* r, const void* k, const void* v, const void* logw, const void* u,
                const void* s0, void* o, void* s_out, int B, int S, int H, cudaStream_t stream) {
  using SM = WkvSmem<L, HD>;
  typedef void (*Kernel)(const T*, const T*, const T*, const float*, const TU*, const float*,
                         float*, float*, int, int);
  Kernel kernel = &wkv_kernel<T, TU, L, HD>;
  // Above 48 KB a kernel may use dynamic shared memory only after opting in.
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SM::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, SM::BYTES, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), static_cast<const TU*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(s_out), S, H);
  return cudaGetLastError();
}

// r/k/v type x u type: (f32, f32), (bf16, bf16) and (bf16, f32).
template <int L, int HD>
cudaError_t run_types(int bf16_in, int u_f32, const void* r, const void* k, const void* v,
                      const void* logw, const void* u, const void* s0, void* o, void* s_out,
                      int B, int S, int H, cudaStream_t s) {
  if (!bf16_in) {
    if (!u_f32) return cudaErrorInvalidValue;
    return run<float, float, L, HD>(r, k, v, logw, u, s0, o, s_out, B, S, H, s);
  }
  return u_f32 ? run<bf16, float, L, HD>(r, k, v, logw, u, s0, o, s_out, B, S, H, s)
               : run<bf16, bf16, L, HD>(r, k, v, logw, u, s0, o, s_out, B, S, H, s);
}

}  // namespace

// The compiled chunk lengths and head dims. The Python side (kernels/wkv.py::_CHUNKS and
// _HEAD_DIMS) lists the same sets and checks them against repro_wkv_configs() at load.
#define REPRO_WKV_CHUNKS(X) X(8) X(16) X(32) X(64) X(128)
#define REPRO_WKV_HEAD_DIMS(X, L) X(L, 16) X(L, 64)

extern "C" {

// Writes (chunk, hd, smem bytes) per compiled instantiation; returns the count.
int repro_wkv_configs(int* out, int cap) {
  int n = 0;
#define Y(L, HD)                             \
  if (n < cap) {                             \
    out[3 * n + 0] = L;                      \
    out[3 * n + 1] = HD;                     \
    out[3 * n + 2] = WkvSmem<L, HD>::BYTES;  \
  }                                          \
  ++n;
#define X(L) REPRO_WKV_HEAD_DIMS(Y, L)
  REPRO_WKV_CHUNKS(X)
#undef X
#undef Y
  return n;
}

// r/k/v/logw/o: (B, S, H, hd) contiguous; u: (H, hd); s0 (may be null = zeros) and s_out:
// (B, H, hd, hd) f32. bf16_in: r/k/v are bf16 (else f32); u_f32: u is f32 (else bf16).
int repro_wkv(int chunk, int hd, int bf16_in, int u_f32, const void* r, const void* k,
              const void* v, const void* logw, const void* u, const void* s0, void* o,
              void* s_out, int B, int S, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Y(L, HD)                                                                            \
  if (chunk == L && hd == HD)                                                               \
    return (int)run_types<L, HD>(bf16_in, u_f32, r, k, v, logw, u, s0, o, s_out, B, S, H, s);
#define X(L) REPRO_WKV_HEAD_DIMS(Y, L)
  REPRO_WKV_CHUNKS(X)
#undef X
#undef Y
  return (int)cudaErrorInvalidValue;
}

const char* repro_wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
