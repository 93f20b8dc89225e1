// Mamba selective scan for Hopper (sm_90a): one thread per (channel, state index).
//
// Replaces: src/repro/kernels/ssm.py:90 ssm_scan_pallas (body _ssm_kernel), the TPU kernel
// behind ops.ssm_scan, which every HymbaLM prefill runs once per layer (models/mamba.py
// mamba_layer). For one batch element b and every channel ch and state index n:
//   h_t[ch, n] = exp(dta_t[ch, n]) * h_{t-1}[ch, n] + dtx_t[ch] * b_t[n]
//   y_t[ch]    = sum_n h_t[ch, n] * c_t[n]
// with h_{-1} the given (d, N) f32 state (zeros when none), in f32 throughout. It returns
// every y_t (B, S, d) and the final state (B, d, N).
//
// Bound on this card: the function must read dta (B, S, d, N) f32, dtx (B, S, d), b and c
// (B, S, N) and the state, and write y (B, S, d) and the final state. At a batch-1 prefill of
// hymba-1.5b (d = 1600, N = 16) and S = 128 that is ~14.8 MB, 13.1 MB of it dta: ~4.4 us at
// 3.35 TB/s (~1.1 us at S = 32). The operations, one exp and ~5 f32 flops per (t, ch, n)
// (3.3 M exp and ~16 Mop at S = 128), take well under that at 67 TFLOP/s f32. So the scan is
// bytes-bound, and what a design has to do is keep enough loads in flight to cover the
// device memory's latency.
//
// What the design does:
//   * Grid: one CTA per (batch element, block of BD channels), BD * N threads, thread
//     (ch, n) at tid = ch_local * N + n. At (1, S, 1600, 16) the default BD = 16 gives 100
//     CTAs of 256 threads on the 132 SMs. A thread holds its h in a register for the whole
//     sequence; a loop over S replaces the TPU's sequential grid axis, so nothing carries
//     between CTAs.
//   * Loads: dta is read in its (B, S, d, N) layout. At one time step the CTA's BD * N
//     values are contiguous, and neighbouring threads read neighbouring addresses. Nothing
//     is copied into another layout first.
//   * Load latency: the sequence goes in chunks of CHUNK steps. A thread first issues the
//     loads of all CHUNK of its dta values (into registers), and the CTA loads the chunk's
//     dtx, b and c into shared memory; only then does the dependent recurrence run over the
//     chunk. So CHUNK loads per thread are in flight together, not one global-load latency
//     per step.
//   * Output: y_t is reduced over the N lanes of a channel by warp shuffles (N divides 32,
//     so a channel's lanes sit in one warp); lane n = 0 writes it.
//   * Ragged edges are masked, not padded: a step past S loads dta = 0 and dtx = 0, so
//     h passes through unchanged and nothing is written; a channel past d loads zeros and
//     writes nothing. The final state is written once, at the end.
//   * expf (accurate), not __expf, so the kernel holds to the plain version at 1e-4.
// Not done yet (later PRs): TMA loads, fusing dt * a into the kernel so that the
// (B, S, d, N) dta never reaches device memory, a chunk-parallel scan for long S.
//
// Plain C interface, loaded with ctypes; the launch entry point returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int N, int BD, int CHUNK>
__global__ void __launch_bounds__(BD * N)
    ssm_kernel(const float* __restrict__ dtx, const float* __restrict__ dta,
               const float* __restrict__ bv, const float* __restrict__ cv,
               const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ s_out,
               int S, int D, int n_dblocks) {
  constexpr int T = BD * N;
  __shared__ float sx[CHUNK][BD];  // dtx of the chunk, this CTA's channels
  __shared__ float sb[CHUNK][N];
  __shared__ float sc[CHUNK][N];

  const int b = blockIdx.x / n_dblocks;
  const int ch0 = (blockIdx.x % n_dblocks) * BD;
  const int tid = threadIdx.x;
  const int lc = tid / N, n = tid % N;
  const int ch = ch0 + lc;
  const bool live = ch < D;
  const size_t row_dn = (size_t)D * N;                         // dta elements per step
  const float* a_p = dta + (size_t)b * S * row_dn + (size_t)ch * N + n;  // (b, 0, ch, n)
  const float* x_p = dtx + (size_t)b * S * D;                  // (b, 0, 0)
  const float* b_p = bv + (size_t)b * S * N;
  const float* c_p = cv + (size_t)b * S * N;
  float* y_p = y + (size_t)b * S * D + ch;                     // (b, 0, ch)
  const size_t state = ((size_t)b * D + ch) * N + n;           // (b, ch, n)

  float h = (live && s0) ? s0[state] : 0.f;

  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    // 1. Issue the chunk's loads: CHUNK dta values per thread into registers, and dtx / b / c
    //    into shared memory. Steps past S are zero (h passes through), as are dead channels.
    float a[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int t = t0 + j;
      a[j] = (live && t < S) ? a_p[(size_t)t * row_dn] : 0.f;
    }
    for (int i = tid; i < CHUNK * BD; i += T) {
      const int j = i / BD, l = i % BD;
      const int t = t0 + j;
      sx[j][l] = (t < S && ch0 + l < D) ? x_p[(size_t)t * D + ch0 + l] : 0.f;
    }
    for (int i = tid; i < CHUNK * N; i += T) {
      const int j = i / N, m = i % N;
      const int t = t0 + j;
      sb[j][m] = t < S ? b_p[(size_t)t * N + m] : 0.f;
      sc[j][m] = t < S ? c_p[(size_t)t * N + m] : 0.f;
    }
    __syncthreads();

    // 2. The dependent recurrence over the chunk; y_t reduced across the channel's N lanes.
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      h = fmaf(expf(a[j]), h, sx[j][lc] * sb[j][n]);
      float acc = h * sc[j][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const int t = t0 + j;
      if (n == 0 && live && t < S) y_p[(size_t)t * D] = acc;
    }
    __syncthreads();  // the next chunk overwrites sx / sb / sc
  }
  if (live) s_out[state] = h;
}

template <int N, int BD, int CHUNK>
cudaError_t run(const void* dtx, const void* dta, const void* b, const void* c, const void* s0,
                void* y, void* s_out, int B, int S, int D, cudaStream_t stream) {
  const int n_dblocks = (D + BD - 1) / BD;
  const long long grid = (long long)n_dblocks * B;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  ssm_kernel<N, BD, CHUNK><<<(unsigned)grid, BD * N, 0, stream>>>(
      static_cast<const float*>(dtx), static_cast<const float*>(dta),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(s0), static_cast<float*>(y), static_cast<float*>(s_out), S, D,
      n_dblocks);
  return cudaGetLastError();
}

}  // namespace

// The compiled configs: block_d x chunk x N. The Python side (kernels/ssm.py::_BLOCK_DS,
// _CHUNKS and _STATES) lists the same sets and checks them against repro_ssm_configs() at load.
#define REPRO_SSM_BLOCK_DS(X) X(8) X(16) X(32)
#define REPRO_SSM_CHUNKS(X, BD) X(BD, 8) X(BD, 16) X(BD, 32)
#define REPRO_SSM_STATES(X, BD, C) X(BD, C, 8) X(BD, C, 16)

extern "C" {

// Writes (block_d, chunk, N, threads) per compiled instantiation; returns the count.
int repro_ssm_configs(int* out, int cap) {
  int n = 0;
#define Z(BD, C, NS)             \
  if (n < cap) {                 \
    out[4 * n + 0] = BD;         \
    out[4 * n + 1] = C;          \
    out[4 * n + 2] = NS;         \
    out[4 * n + 3] = BD * NS;    \
  }                              \
  ++n;
#define Y(BD, C) REPRO_SSM_STATES(Z, BD, C)
#define X(BD) REPRO_SSM_CHUNKS(Y, BD)
  REPRO_SSM_BLOCK_DS(X)
#undef X
#undef Y
#undef Z
  return n;
}

// dtx, y: (B, S, D); dta: (B, S, D, N); b, c: (B, S, N); s0 (may be null = zeros) and s_out:
// (B, D, N). All f32, contiguous.
int repro_ssm(int block_d, int chunk, int n_state, const void* dtx, const void* dta,
              const void* b, const void* c, const void* s0, void* y, void* s_out, int B, int S,
              int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Z(BD, C, NS)                                                                  \
  if (block_d == BD && chunk == C && n_state == NS)                                   \
    return (int)run<NS, BD, C>(dtx, dta, b, c, s0, y, s_out, B, S, D, s);
#define Y(BD, C) REPRO_SSM_STATES(Z, BD, C)
#define X(BD) REPRO_SSM_CHUNKS(Y, BD)
  REPRO_SSM_BLOCK_DS(X)
#undef X
#undef Y
#undef Z
  return (int)cudaErrorInvalidValue;
}

const char* repro_ssm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
