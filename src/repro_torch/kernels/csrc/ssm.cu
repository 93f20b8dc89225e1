// Mamba selective scan for Hopper (sm_90a): each chunk computed by time groups of 8 steps
// at once, a ring of cp.async stages per CTA, dt*a and dt*x formed in registers, long
// sequences split into segments across CTAs.
//
// Replaces: src/repro/kernels/ssm.py:90 ssm_scan_pallas (body _ssm_kernel), the TPU kernel
// behind ops.ssm_scan, which every HymbaLM prefill runs once per layer (models/mamba.py
// mamba_layer). For one batch element and every channel ch and state index n:
//   h_t[ch, n] = exp(dta_t[ch, n]) * h_{t-1}[ch, n] + dtx_t[ch] * b_t[n]
//   y_t[ch]    = sum_n h_t[ch, n] * c_t[n]
// with h_{-1} the given (d, N) f32 state (zeros when none), in f32 throughout. It returns
// every y_t (B, S, d) and the final state (B, d, N). Two entries compute it:
//   * the dta entry (repro_ssm, FUSED = false) reads dtx (B, S, d) and dta (B, S, d, N), as
//     the TPU kernel does;
//   * the fused entry (repro_ssm_fused, FUSED = true) reads x and dt (B, S, d) and a (d, N),
//     and forms dtx = dt * x and dta = dt * a in registers, one f32 multiply each, as
//     models/mamba.py would: the recurrence sees bitwise the values the dta entry is fed.
//
// Bound on this card: the bytes each entry must move. At a batch-1 prefill of hymba-1.5b
// (d = 1600, N = 16) and S = 128 the dta entry moves ~14.9 MB (13.1 MB of it dta): ~4.4 us at
// 3.35 TB/s; the fused entry moves ~2.7 MB: ~0.8 us. The operations, one exp and ~6 f32
// operations per (t, ch, n), take ~0.3 us at 67 TFLOP/s. So the scan is bytes-bound on
// paper; in practice a step-by-step scan is bound by the latency of its S dependent steps,
// with few warps on the card (at d = 1600, 6400 threads at 4 a channel). What the design has
// to do is shorten that chain, keep loads in flight while it runs, and issue few
// instructions a step.
//
// What the design does:
//   * Threads: LANES = 4 threads a channel, each holding K = N / 4 state indices in
//     registers (K = 4 at N = 16). A CTA holds BD channels, once for each of W = CHUNK / 8
//     time groups: 4 * BD * W threads.
//   * Time groups: group w takes steps [8 w, 8 w + 8) of every chunk. Phase 1: it runs them
//     from a zero state, keeping after each step the state hz and the product az of the
//     decays so far, so its dependent chain is 8 steps, not CHUNK. The groups' pairs
//     (P_w, E_w) = (az, hz) after their last step go to shared memory, and after one CTA
//     barrier phase 2 folds the chunk's start state h through them in group order
//     (h = P_v * h + E_v): the fold up to group w is group w's start state hw, a step's state
//     is hz + az * hw, and its y = sum_n (hz + az * hw) * c. Every group folds the same values
//     in the same order, so all hold bitwise the same next start state.
//   * y: 4 steps at a time summed in-thread over K and across the channel's 4 lanes in 3
//     shuffles (reduce4), lane q keeping step q's y in a register until the chunk's end.
//   * Loads: a ring of STAGES stages of CHUNK steps in shared memory, filled by cp.async
//     (16 bytes a copy where d % 4 == 0, else 4). Each stage has a "full" mbarrier that the
//     copies complete on (cp.async.mbarrier.arrive.noinc) and an "empty" one the warps arrive
//     on when they are done with it. At the top of chunk k a thread refills the stage chunk
//     k - 1 used with chunk k - 1 + STAGES, then waits only for chunk k's own data: no
//     barrier sits between a chunk's loads and its steps, and STAGES - 1 chunks of loads are
//     in flight while a chunk's steps run. a and the given state are read before the ring
//     is set up, so their latency overlaps it.
//   * Per step and state: exp by ex2.approx of dta * log2(e) (the SFU alone; accurate expf
//     was slower at every length), one multiply for dtx * b_n, one fma into hz, one multiply
//     into az; then one fma for the state and one for y.
//   * Segments: where a long call's grid (B x ceil(d / BD) CTAs) is under a third of a wave,
//     the wrapper cuts the sequence into G segments of whole chunks (kernels/ssm.py
//     ssm_segments). Then a state pass (ssm_state_kernel, grid x G - 1) runs every segment
//     but the last from a zero state and writes to a workspace its end state E and the
//     product P of its decays, two (d, N) f32 arrays a segment; the output pass
//     (ssm_output_kernel, grid x G) starts segment g from the given state folded through
//     (P_0, E_0) .. (P_{g-1}, E_{g-1}) in that order, runs it, writes its y, and the last
//     segment writes the final state. The fold orders are fixed and nothing is atomic, so
//     two calls are bitwise equal. With G = 1 a call is the output pass alone.
//   * Ragged edges are masked, not padded: a step past S loads zeros (dta = 0, dtx = 0: h
//     passes through) and writes nothing; a channel past d loads zeros and writes nothing.
//
// Plain C interface, loaded with ctypes; the launch entry points return a cudaError_t.

#include "hopper.cuh"

namespace {

constexpr int LANES = 4;  // threads a channel
constexpr float LOG2E = 1.4426950408889634f;

// 4-byte async copy; pred = false zero-fills the destination without reading.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
}

// The mbarrier at ``bar`` counts one arrival when every cp.async this thread issued so far
// has landed.
__device__ __forceinline__ void cp_async_mbar_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// K consecutive floats of shared memory (16- or 8-byte aligned) in one load.
template <int K>
__device__ __forceinline__ void load_k(const float* src, float (&v)[K]) {
  if constexpr (K == 4) {
    const float4 w = *reinterpret_cast<const float4*>(src);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else {
    const float2 w = *reinterpret_cast<const float2*>(src);
    v[0] = w.x, v[1] = w.y;
  }
}

// Four steps' partial y summed across a channel's four lanes (q = 0..3, adjacent in the
// warp) in three shuffles: lane q returns the sum over the lanes of a[q]. Round 1 pairs
// lanes q and q ^ 2: each keeps the two steps whose bit 1 is its own and sends the other
// two; round 2 pairs q and q ^ 1 and keeps one step.
__device__ __forceinline__ float reduce4(const float (&a)[4], int q) {
  const bool hi = q & 2;
  const float k0 = hi ? a[2] : a[0], k1 = hi ? a[3] : a[1];
  const float s0 = hi ? a[0] : a[2], s1 = hi ? a[1] : a[3];
  const float b0 = k0 + __shfl_xor_sync(0xffffffffu, s0, 2);
  const float b1 = k1 + __shfl_xor_sync(0xffffffffu, s1, 2);
  const bool odd = q & 1;
  return (odd ? b1 : b0) + __shfl_xor_sync(0xffffffffu, odd ? b0 : b1, 1);
}

// The geometry and shared-memory layout of one instantiation. A CTA holds BD channels x
// LANES threads for each of W = CHUNK / 8 time groups; group w takes steps [8 w, 8 w + 8) of
// every chunk. Shared memory: STAGES ring stages, each CHUNK steps of
//   xs: x (fused) or dtx, BD floats a step;
//   ds: dt (fused), BD floats a step, or dta, BD * N floats a step;
//   bs, cs: N floats a step (cs in the output pass only);
// then (W > 1) two buffers of the time groups' pairs, [W][P, E][BD][N] floats each.
template <int N, int BD, int CHUNK, bool FUSED, bool OUT>
struct Ring {
  static constexpr int L = 8;  // steps a time group takes of each chunk
  static constexpr int W = CHUNK / L;
  static constexpr int THREADS = BD * LANES * W;
  static constexpr int STAGES = FUSED ? 3 : 2;
  static constexpr int D_STEP = FUSED ? BD : BD * N;
  static constexpr int XS = 0;
  static constexpr int DS = XS + CHUNK * BD;
  static constexpr int BS = DS + CHUNK * D_STEP;
  static constexpr int CS = BS + CHUNK * N;
  static constexpr int STAGE = CS + (OUT ? CHUNK * N : 0);  // floats a stage
  static constexpr int PAIRS = STAGES * STAGE;                // floats before the pairs
  static constexpr int PAIR_BUF = W > 1 ? W * 2 * BD * N : 0;
  static constexpr int BYTES = (PAIRS + 2 * PAIR_BUF) * 4;
  static_assert(CHUNK % L == 0, "a chunk is whole time groups");
};

struct Args {
  const float* x;   // fused: x (B, S, D); else dtx (B, S, D)
  const float* d;   // fused: dt (B, S, D); else dta (B, S, D, N)
  const float* a;   // fused: a (D, N); else unused
  const float* b;   // (B, S, N)
  const float* c;   // (B, S, N)
  const float* s0;  // (B, D, N) or null (zeros)
  float* y;         // (B, S, D)
  float* s_out;     // (B, D, N)
  float* ws;        // E then P, each (B, G - 1, D, N)
  int S, D, n_dblocks, seg_len, n_seg;
};

template <int N, int BD, int CHUNK, bool FUSED, bool OUT>
__device__ __forceinline__ void scan(const Args& p) {
  using R = Ring<N, BD, CHUNK, FUSED, OUT>;
  constexpr int L = R::L, W = R::W, T = R::THREADS;
  constexpr int K = N / LANES;
  constexpr int WARPS = T / 32;
  static_assert((BD * LANES) % 32 == 0 && N % LANES == 0 && (K == 2 || K == 4) && L % LANES == 0, "layout");
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t full[R::STAGES], empty[R::STAGES];

  const int tid = threadIdx.x;
  const int w = tid / (BD * LANES);  // time group: whole warps
  const int tl = tid % (BD * LANES);
  const int lc = tl / LANES, q = tl % LANES, n0 = q * K;
  const int bi = blockIdx.x / p.n_dblocks;
  const int ch0 = (blockIdx.x % p.n_dblocks) * BD;
  const int ch = ch0 + lc;
  const bool live = ch < p.D;
  const int live_ch = min(BD, p.D - ch0);
  const int g = blockIdx.y;
  const int t_begin = g * p.seg_len;
  const int t_end = min(p.S, t_begin + p.seg_len);
  const int n_chunks = (t_end - t_begin + CHUNK - 1) / CHUNK;
  const size_t row0 = (size_t)bi * p.S;  // (bi, 0) in a (B, S, ...) array
  const bool vec = (p.D & 3) == 0;

  // First the loads that are not in the ring, so their latency overlaps the set-up: a
  // (fused entry), this thread's K decay rates, and the given state.
  const size_t state = ((size_t)bi * p.D + ch) * N + n0;
  float av[K], h[K], P[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    av[i] = (FUSED && live) ? p.a[(size_t)ch * N + n0 + i] : 0.f;
    h[i] = (OUT && live && p.s0) ? p.s0[state + i] : 0.f;
    P[i] = 1.f;
  }

  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), T);
      mbar_init(smem_addr(&empty[s]), WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Issue chunk k of the segment into its stage; every thread then arrives on the stage's
  // full barrier once its own copies land.
  auto issue = [&](int k) {
    float* st = ring + (k % R::STAGES) * R::STAGE;
    const int t0 = t_begin + k * CHUNK;
    if (vec) {
      for (int i = tid; i < CHUNK * BD / 4; i += T) {
        const int j = i / (BD / 4), c4 = (i % (BD / 4)) * 4;
        const bool ok = t0 + j < p.S && c4 < live_ch;
        const size_t off = ok ? (row0 + t0 + j) * p.D + ch0 + c4 : 0;
        cp_async16(st + R::XS + j * BD + c4, p.x + off, ok);
        if (FUSED) cp_async16(st + R::DS + j * BD + c4, p.d + off, ok);
      }
    } else {
      for (int i = tid; i < CHUNK * BD; i += T) {
        const int j = i / BD, c1 = i % BD;
        const bool ok = t0 + j < p.S && c1 < live_ch;
        const size_t off = ok ? (row0 + t0 + j) * p.D + ch0 + c1 : 0;
        cp_async4(st + R::XS + i, p.x + off, ok);
        if (FUSED) cp_async4(st + R::DS + i, p.d + off, ok);
      }
    }
    if (!FUSED) {  // dta rows: BD * N contiguous floats a step, 16-byte aligned (N % 4 == 0)
      for (int i = tid; i < CHUNK * BD * N / 4; i += T) {
        const int j = i / (BD * N / 4), c4 = (i % (BD * N / 4)) * 4;
        const bool ok = t0 + j < p.S && c4 < live_ch * N;
        const size_t off = ok ? ((row0 + t0 + j) * p.D + ch0) * N + c4 : 0;
        cp_async16(st + R::DS + j * BD * N + c4, p.d + off, ok);
      }
    }
    for (int i = tid; i < CHUNK * N / 4; i += T) {
      const int j = i / (N / 4), c4 = (i % (N / 4)) * 4;
      const bool ok = t0 + j < p.S;
      const size_t off = ok ? (row0 + t0 + j) * N + c4 : 0;
      cp_async16(st + R::BS + j * N + c4, p.b + off, ok);
      if (OUT) cp_async16(st + R::CS + j * N + c4, p.c + off, ok);
    }
    cp_async_mbar_arrive(smem_addr(&full[k % R::STAGES]));
  };

  for (int k = 0; k < R::STAGES - 1 && k < n_chunks; ++k) issue(k);

  // The state at the segment's start, the same in every time group: the given one (or
  // zeros), folded through the earlier segments' (P, E) pairs in segment order. The state
  // pass starts every segment from zeros and also carries the segment's decay product.
  const size_t ws_seg = (size_t)p.D * N;  // one segment's (d, N) array
  const size_t ws_half = (size_t)(gridDim.x / p.n_dblocks) * (p.n_seg - 1) * ws_seg;
  const size_t ws0 = ((size_t)bi * (p.n_seg - 1)) * ws_seg + (size_t)ch * N + n0;
  if (OUT && live) {
    for (int s = 0; s < g; ++s) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        h[i] = fmaf(p.ws[ws_half + ws0 + s * ws_seg + i], h[i], p.ws[ws0 + s * ws_seg + i]);
    }
  }

  float* yp = p.y + row0 * p.D + ch;
  for (int k = 0; k < n_chunks; ++k) {
    // Refill the stage chunk k - 1 used (a fresh one at k = 0) with chunk k + STAGES - 1,
    // once every warp is done with chunk k - 1: its (kn / STAGES - 1)-th use.
    const int kn = k + R::STAGES - 1;
    if (kn < n_chunks) {
      if (kn >= R::STAGES) mbar_wait(smem_addr(&empty[kn % R::STAGES]), (kn / R::STAGES - 1) & 1);
      issue(kn);
    }
    const int s = k % R::STAGES;
    mbar_wait(smem_addr(&full[s]), (k / R::STAGES) & 1);
    const float* st = ring + s * R::STAGE;
    const int t0 = t_begin + k * CHUNK;

    // Phase 1: this group's L steps from a zero state. hz[jj] is the state after step jj,
    // az[jj] the product of the decays up to it; (az, hz) after the last step is the group's
    // pair (P_w, E_w). Only the h and decay chains are sequential: each step's decays and
    // inputs are independent of them.
    float hz[L][K], az[L][K];
    float hr[K], ar[K];
#pragma unroll
    for (int i = 0; i < K; ++i) hr[i] = 0.f, ar[i] = 1.f;
#pragma unroll
    for (int jj = 0; jj < L; ++jj) {
      const int j = w * L + jj;
      float dtx, dta[K], bv[K];
      if (FUSED) {
        const float dt = st[R::DS + j * BD + lc];
        dtx = __fmul_rn(dt, st[R::XS + j * BD + lc]);
#pragma unroll
        for (int i = 0; i < K; ++i) dta[i] = __fmul_rn(dt, av[i]);
      } else {
        dtx = st[R::XS + j * BD + lc];
        load_k<K>(st + R::DS + j * BD * N + lc * N + n0, dta);
      }
      load_k<K>(st + R::BS + j * N + n0, bv);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float e = ex2(__fmul_rn(dta[i], LOG2E));
        hr[i] = fmaf(e, hr[i], __fmul_rn(dtx, bv[i]));
        ar[i] = __fmul_rn(ar[i], e);
        hz[jj][i] = hr[i];
        az[jj][i] = ar[i];
      }
    }

    // Phase 2: the chunk's start state h folded through the groups' pairs in group order
    // (h = P_v * h + E_v); hw is the fold up to group w, this group's start state, and h
    // after all W groups is the next chunk's start. Every group folds the same values in the
    // same order, so every group holds bitwise the same h.
    float hw[K];
    if constexpr (W > 1) {
      float* pr = ring + R::PAIRS + (k & 1) * R::PAIR_BUF;
      const int mine = (w * 2 * BD + lc) * N + n0;  // P_w; E_w is BD * N further
#pragma unroll
      for (int i = 0; i < K; ++i) pr[mine + i] = ar[i], pr[mine + BD * N + i] = hr[i];
      __syncthreads();
#pragma unroll
      for (int v = 0; v < W; ++v) {
        if (v == w) {
#pragma unroll
          for (int i = 0; i < K; ++i) hw[i] = h[i];
        }
        float pv[K], ev[K];
        load_k<K>(pr + (v * 2 * BD + lc) * N + n0, pv);
        load_k<K>(pr + ((v * 2 + 1) * BD + lc) * N + n0, ev);
#pragma unroll
        for (int i = 0; i < K; ++i) {
          h[i] = fmaf(pv[i], h[i], ev[i]);
          if (!OUT) P[i] = __fmul_rn(P[i], pv[i]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        hw[i] = h[i];
        h[i] = fmaf(ar[i], h[i], hr[i]);
        if (!OUT) P[i] = __fmul_rn(P[i], ar[i]);
      }
    }

    // y of the group's steps: h_t = hz_t + az_t * hw, then y_t = sum_n h_t c_t, in groups of 4
    // steps reduced across the channel's 4 lanes at once (reduce4: lane q ends with step q's).
    // yv[i] holds y of step 4 i + q of the group, stored after the chunk.
    float yv[L / LANES];
    if (OUT) {
#pragma unroll
      for (int jb = 0; jb < L; jb += LANES) {
        float acc[LANES];
#pragma unroll
        for (int jj = 0; jj < LANES; ++jj) {
          float cv[K];
          load_k<K>(st + R::CS + (w * L + jb + jj) * N + n0, cv);
          acc[jj] = 0.f;
#pragma unroll
          for (int i = 0; i < K; ++i) acc[jj] = fmaf(fmaf(az[jb + jj][i], hw[i], hz[jb + jj][i]), cv[i], acc[jj]);
        }
        yv[jb / LANES] = reduce4(acc, q);
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(smem_addr(&empty[s]));
    if (OUT && live) {
#pragma unroll
      for (int i = 0; i < L / LANES; ++i) {
        const int t = t0 + w * L + i * LANES + q;
        if (t < p.S) yp[(size_t)t * p.D] = yv[i];
      }
    }
  }

  if (!live || w != 0) return;
  if (OUT) {
    if (g == p.n_seg - 1) {
#pragma unroll
      for (int i = 0; i < K; ++i) p.s_out[state + i] = h[i];
    }
  } else {
    const size_t o = ws0 + (size_t)g * ws_seg;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      p.ws[o + i] = h[i];
      p.ws[ws_half + o + i] = P[i];
    }
  }
}

template <int N, int BD, int CHUNK, bool FUSED>
__global__ void __launch_bounds__(Ring<N, BD, CHUNK, FUSED, false>::THREADS) ssm_state_kernel(const Args p) {
  scan<N, BD, CHUNK, FUSED, false>(p);
}

template <int N, int BD, int CHUNK, bool FUSED>
__global__ void __launch_bounds__(Ring<N, BD, CHUNK, FUSED, true>::THREADS) ssm_output_kernel(const Args p) {
  scan<N, BD, CHUNK, FUSED, true>(p);
}

template <int N, int BD, int CHUNK, bool FUSED>
int occupancy() {
  using R = Ring<N, BD, CHUNK, FUSED, true>;
  auto kernel = &ssm_output_kernel<N, BD, CHUNK, FUSED>;
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::BYTES) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, R::THREADS, R::BYTES) != cudaSuccess)
    return -1;
  return n;
}

template <int N, int BD, int CHUNK, bool FUSED>
cudaError_t run(Args p, int B, int n_seg, cudaStream_t stream) {
  using RS = Ring<N, BD, CHUNK, FUSED, false>;
  using RO = Ring<N, BD, CHUNK, FUSED, true>;
  auto state_kernel = &ssm_state_kernel<N, BD, CHUNK, FUSED>;
  auto out_kernel = &ssm_output_kernel<N, BD, CHUNK, FUSED>;
  p.n_dblocks = (p.D + BD - 1) / BD;
  const long long grid = (long long)p.n_dblocks * B;
  if (grid > 0x7fffffffLL || n_seg < 1 || n_seg > 65535) return cudaErrorInvalidConfiguration;
  const int n_chunks = (p.S + CHUNK - 1) / CHUNK;
  p.seg_len = ((n_chunks + n_seg - 1) / n_seg) * CHUNK;
  p.n_seg = (p.S + p.seg_len - 1) / p.seg_len;
  if (p.n_seg != n_seg) return cudaErrorInvalidValue;  // the wrapper sizes the workspace by it
  // Above 48 KB a kernel may use dynamic shared memory only after opting in.
  cudaError_t err;
  if (n_seg > 1) {
    err = cudaFuncSetAttribute(state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RS::BYTES);
    if (err != cudaSuccess) return err;
    state_kernel<<<dim3((unsigned)grid, n_seg - 1), RS::THREADS, RS::BYTES, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RO::BYTES);
  if (err != cudaSuccess) return err;
  out_kernel<<<dim3((unsigned)grid, n_seg), RO::THREADS, RO::BYTES, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------
// ssm_bwd_kernel: the VJP of the scan above, both entries (FUSED as the forward). Replaces no
// TPU kernel: the TPU kernel (src/repro/kernels/ssm.py:90 ssm_scan_pallas) has no backward,
// and the JAX package trains Hymba through XLA's gradient of src/repro/kernels/ref.py:24
// ssm_scan_ref (src/repro/kernels/ops.py:461, the use_pallas=False path); ops.ssm_scan_fused's
// autograd op (repro_torch::ssm_scan_fused) runs this once per layer of every training step.
// For one channel ch and state index n, with G_t the gradient of h_t and e_t = exp(dta_t):
//   G_t = dy_t[ch] c_t[n] + e_{t+1} G_{t+1}  (G_{S-1} adds the final state's cotangent),
//   d(dta)_t = G_t e_t h_{t-1};  d(dtx)_t = sum_n G_t b_t[n];  db_t[n] = sum_ch G_t dtx_t;
//   dc_t[n] = sum_ch dy_t h_t;  d(state) = e_0 G_0.
// The fused entry forms dtx = dt x and dta = dt a as the forward and gives dx = d(dtx) dt,
// d(dt) = d(dtx) x + sum_n d(dta) a and da = sum over B and S of d(dta) dt, so no (B, S, d, N)
// tensor is read or written. kernels/ref.py::ssm_scan_vjp_ref computes the same function
// sequentially (the plain version); tests/test_torch_ssm_grad.py::_bwd_mirror follows this
// kernel's order of work.
//
// Bound on this card: at hymba-1.5b's training shape (B 8, S 128, d 1600, N 16) the fused entry
// must move ~33 MB (x, dt, dy in; dx, d(dt) out; a, b, c, da, db, dc): ~10 us at 3.35 TB/s; its
// work, ~20 f32 operations and one exponential a (t, ch, n), ~8 us at 67 TFLOP/s and ~7 us on
// the SFU. The dta entry reads dta and writes d(dta), (B, S, d, N) each: ~230 MB, ~69 us. What
// set the pace of the kernel this one replaces (a thread a (ch, n), each step's inputs loaded
// from device memory inside the dependent chain, 1.06 ms there) was latency: every step waited
// on a round trip to memory.
//
// What the design does:
//   * The forward's layout: LANES = 4 threads a channel, each holding K = N / 4 state indices
//     in registers; BD channels; W = CHUNK / 8 time groups, group w taking steps [8 w, 8 w + 8)
//     of every chunk: 4 BD W threads a CTA, grid B x ceil(d / BD).
//   * Inputs staged: a ring of STAGES stages of CHUNK steps in shared memory, filled by cp.async
//     on "full" / "empty" mbarriers as the forward's (Ring above). The ring runs one sequence of
//     items: chunks 0 .. n - 2 in order (x and dt, or dtx and dta, and b: the chunk starts), then
//     chunks n - 1 .. 0 in reverse (those and dy, c). STAGES - 1 items of loads are in flight
//     while one is computed, and every step reads only shared memory and registers.
//   * The chunk starts: the forward walk runs each chunk in time groups and folds the groups'
//     (decay product, end state) pairs in group order, as the forward's phases 1 and 2; the state
//     at each chunk's start goes to the workspace ck (3.3 MB at the training shape, in L2).
//   * Each chunk in reverse, in four short passes:
//       1. recompute: each group runs its 8 steps from a zero state, keeping each step's state hz
//          in registers and its e_t (the pass's one exponential) in shared memory, and its pair
//          (P_w, E_w);
//       2. states: the chunk's start state folded through the earlier groups' pairs is the
//          group's start state hw, and a step's state is hz + az hw, az the decays so far;
//       3. the adjoint is a first-order linear recurrence too: each group walks its steps back
//          from a zero gradient to its pair (P_w, E'_w); the gradient entering the chunk folded
//          through the later groups' pairs in reverse group order is each group's entering
//          gradient, and the fold over all W groups the gradient leaving the chunk, bitwise the
//          same in every group (W = 1: the walk of pass 4 gives it);
//       4. each group walks its steps back again from its entering gradient, forming the outputs.
//     So every dependent chain is 8 steps and a fold of W pairs, not the sequence.
//   * Sums in fixed trees: over n within a thread, then across the channel's 4 lanes four steps
//     at a time (reduce4, as the forward's y); over channels (db, dc) across a warp's 8 channels
//     by a butterfly that halves the values a lane keeps each round (channel_sum), then the warps'
//     partials in warp order after the chunk; da over the time groups in group order at the end.
//     One partial a CTA for db and dc (B, n_dblocks, S, N), one a batch row for da (B, d, N),
//     which the wrapper sums (torch.sum). No atomics: two calls are bitwise equal.
//   * Outputs staged: a chunk's dx and d(dt) (or d(dtx)) go to shared memory and leave after it as
//     16-byte stores of the CTA's channels, step by step; the dta entry's d(dta) leaves from
//     registers as 16-byte stores, 512 contiguous bytes a warp.
//   * Ragged edges load zeros (e = 1 and no input: the gradient passes through unchanged) and
//     write nothing.
// Two exponentials a (t, ch, n) remain: the forward walk's and the recompute's; a forward kernel
// that wrote the chunk starts under grad would save the walk. The backward is not cut into
// segments: a training call's grid (B 8 at hymba's d 1600: 800 CTAs at BD 16) fills the card, and
// the long single-row calls the forward cuts are prefills, which run no backward.
struct BwdArgs {
  const float* x;   // fused: x (B, S, D); else dtx (B, S, D)
  const float* d;   // fused: dt (B, S, D); else dta (B, S, D, N)
  const float* a;   // fused: a (D, N); else unused
  const float* b;   // (B, S, N)
  const float* c;   // (B, S, N)
  const float* s0;  // (B, D, N) or null (zeros)
  const float* dy;  // (B, S, D)
  const float* ds;  // (B, D, N) or null (zeros)
  float* ck;        // (B, n_chunks, D, N): the state at every chunk's start
  float* gx;        // fused: dx; else d(dtx) (B, S, D)
  float* gd;        // fused: d(dt) (B, S, D); else d(dta) (B, S, D, N)
  float* ga;        // fused: da's partial per batch row (B, D, N); else unused
  float* gb;        // db's partial per channel block (B, n_dblocks, S, N)
  float* gc;        // dc's partial per channel block (B, n_dblocks, S, N)
  float* gs;        // d(state) (B, D, N) or null (not written)
  int S, D, n_dblocks;
};

// The geometry and shared-memory layout (floats) of one backward instantiation. STAGES ring
// stages, each CHUNK steps of
//   xs: x (fused) or dtx, BD a step;  ds: dt (fused), BD a step, or dta, BD * N;
//   ys: dy, BD a step;  bs, cs: N a step (ys and cs filled by the reverse items only);
// then the time groups' pairs (W > 1): the forward walk's two buffers of [W][P, E][BD][N], the
// reverse pass's [W][P, E, E'][BD][N], da's [W][BD][N] at the end, all in one region; the warps'
// partials of db and dc, [CHUNK][WG][2][N]; the chunk's d(dtx) or dx, and d(dt), [CHUNK][BD] each;
// and (fused) the chunk's e_t, [CHUNK][BD][N]. The dta entry keeps e_t in its stage, in place of
// the dta it came from, which nothing reads after the recompute.
template <int N, int BD, int CHUNK, bool FUSED>
struct BwdRing {
  static constexpr int L = 8;  // steps a time group takes of each chunk
  static constexpr int W = CHUNK / L;
  static constexpr int GT = BD * LANES;  // threads of a time group
  static constexpr int THREADS = GT * W;
  static constexpr int WG = GT / 32;  // warps of a time group
  static constexpr int STAGES = FUSED ? 3 : 2;
  static constexpr int D_STEP = FUSED ? BD : BD * N;
  static constexpr int XS = 0;
  static constexpr int DS = XS + CHUNK * BD;
  static constexpr int YS = DS + CHUNK * D_STEP;
  static constexpr int BS = YS + CHUNK * BD;
  static constexpr int CS = BS + CHUNK * N;
  static constexpr int STAGE = CS + CHUNK * N;
  static constexpr int PAIRS = STAGES * STAGE;
  static constexpr int PAIR_FLOATS = W > 1 ? 4 * W * BD * N : 0;
  static constexpr int RED = PAIRS + PAIR_FLOATS;
  static constexpr int OUT = RED + CHUNK * WG * 2 * N;
  static constexpr int OUTS = FUSED ? 2 : 1;
  static constexpr int ES = OUT + OUTS * CHUNK * BD;
  static constexpr int BYTES = (ES + (FUSED ? CHUNK * BD * N : 0)) * 4;
  // At most 128 registers a thread, so that 512 threads share an SM at the smallest CTA count.
  static constexpr int MIN_CTAS = THREADS >= 512 ? 1 : 512 / THREADS;
  static_assert(CHUNK % L == 0 && GT % 32 == 0, "a chunk is whole time groups of whole warps");
  static_assert(BYTES <= 227 * 1024, "shared memory of one CTA");
};

template <int K>
__device__ __forceinline__ void store_k(float* dst, const float (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  }
}

// Sums v (V = 8 or 4 values a lane) over the 8 lanes of a warp that share lane % 4 (the warp's 8
// channels, one lane q each) by a butterfly over the lane masks 16, 8 and 4: each round a lane
// keeps half of what it holds and adds its partner's copy of that half, while it holds more than
// one value. Lane returns value (lane >> 2) & 7 (V = 8) or (lane >> 3) & 3 (V = 4) of the sum;
// the order is ((c0 + c4) + (c2 + c6)) + ((c1 + c5) + (c3 + c7)) over the channels c.
template <int V>
__device__ __forceinline__ float channel_sum(const float (&v)[V], int lane) {
  static_assert(V == 8 || V == 4, "2 K values a lane");
  constexpr int C1 = V / 2, C2 = V / 4;
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float r1[C1], r2[C2];
#pragma unroll
  for (int i = 0; i < C1; ++i) {
    const float keep = h16 ? v[i + C1] : v[i], send = h16 ? v[i] : v[i + C1];
    r1[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < C2; ++i) {
    const float keep = h8 ? r1[i + C2] : r1[i], send = h8 ? r1[i] : r1[i + C2];
    r2[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  if constexpr (C2 == 2) {
    const float keep = h4 ? r2[1] : r2[0], send = h4 ? r2[0] : r2[1];
    return keep + __shfl_xor_sync(0xffffffffu, send, 4);
  } else {
    return r2[0] + __shfl_xor_sync(0xffffffffu, r2[0], 4);
  }
}

template <int N, int BD, int CHUNK, bool FUSED>
__global__ void __launch_bounds__(BwdRing<N, BD, CHUNK, FUSED>::THREADS, BwdRing<N, BD, CHUNK, FUSED>::MIN_CTAS)
ssm_bwd_kernel(const BwdArgs p) {
  using R = BwdRing<N, BD, CHUNK, FUSED>;
  constexpr int L = R::L, W = R::W, T = R::THREADS, WARPS = T / 32, WG = R::WG;
  constexpr int K = N / LANES;
  static_assert(N % LANES == 0 && (K == 2 || K == 4) && L % LANES == 0, "layout");
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t full[R::STAGES], empty[R::STAGES];

  const float* __restrict__ x_in = p.x;
  const float* __restrict__ d_in = p.d;
  const float* __restrict__ b_in = p.b;
  const float* __restrict__ c_in = p.c;
  const float* __restrict__ dy_in = p.dy;
  float* __restrict__ gx = p.gx;
  float* __restrict__ gd = p.gd;
  float* __restrict__ gb = p.gb;
  float* __restrict__ gc = p.gc;

  const int tid = threadIdx.x, lane = tid & 31;
  const int w = tid / R::GT;  // time group: whole warps
  const int tl = tid % R::GT;
  const int lc = tl / LANES, q = tl % LANES, n0 = q * K;
  const int wg = tl / 32;  // warp within the group
  const int bi = blockIdx.x / p.n_dblocks, dblk = blockIdx.x % p.n_dblocks;
  const int S = p.S, D = p.D;
  const int ch0 = dblk * BD, ch = ch0 + lc;
  const bool live = ch < D;
  const int live_ch = min(BD, D - ch0);
  const int n_chunks = (S + CHUNK - 1) / CHUNK;
  const int n_fwd = n_chunks - 1, n_items = n_fwd + n_chunks;
  const size_t row0 = (size_t)bi * S;  // (bi, 0) in a (B, S, ...) array
  const bool vec = (D & 3) == 0;
  const size_t st = ((size_t)bi * D + ch) * N + n0;  // this thread's K values of a (B, D, N) array
  float* const ck = p.ck + ((size_t)bi * n_chunks * D + ch) * N + n0;  // + k D N: chunk k's start
  float* const pr = ring + R::PAIRS;
  float* const __restrict__ red = ring + R::RED;
  float* const __restrict__ outs = ring + R::OUT;

  // Loads outside the ring first, so their latency overlaps the set-up: a (fused entry), the
  // given state and the final state's cotangent.
  float av[K], h[K], dh[K], da[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    av[i] = (FUSED && live) ? p.a[(size_t)ch * N + n0 + i] : 0.f;
    h[i] = (live && p.s0) ? p.s0[st + i] : 0.f;
    dh[i] = (live && p.ds) ? p.ds[st + i] : 0.f;
    da[i] = 0.f;
  }

  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), T);
      mbar_init(smem_addr(&empty[s]), WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Item i of the ring's sequence: chunk i of the forward walk (i < n_fwd), else chunk
  // n_items - 1 - i of the reverse pass. Every thread issues its share of the copies, then arrives
  // on the stage's full barrier once they land.
  auto issue = [&](int i) {
    const bool rev = i >= n_fwd;
    const int t0 = (rev ? n_items - 1 - i : i) * CHUNK;
    float* sg = ring + (i % R::STAGES) * R::STAGE;
    if (vec) {
      for (int e = tid; e < CHUNK * BD / 4; e += T) {
        const int j = e / (BD / 4), c4 = (e % (BD / 4)) * 4;
        const bool ok = t0 + j < S && c4 < live_ch;
        const size_t off = ok ? (row0 + t0 + j) * D + ch0 + c4 : 0;
        cp_async16(sg + R::XS + j * BD + c4, x_in + off, ok);
        if (FUSED) cp_async16(sg + R::DS + j * BD + c4, d_in + off, ok);
        if (rev) cp_async16(sg + R::YS + j * BD + c4, dy_in + off, ok);
      }
    } else {
      for (int e = tid; e < CHUNK * BD; e += T) {
        const int j = e / BD, c1 = e % BD;
        const bool ok = t0 + j < S && c1 < live_ch;
        const size_t off = ok ? (row0 + t0 + j) * D + ch0 + c1 : 0;
        cp_async4(sg + R::XS + e, x_in + off, ok);
        if (FUSED) cp_async4(sg + R::DS + e, d_in + off, ok);
        if (rev) cp_async4(sg + R::YS + e, dy_in + off, ok);
      }
    }
    if (!FUSED) {  // dta rows: BD * N contiguous floats a step, 16-byte aligned (N % 4 == 0)
      for (int e = tid; e < CHUNK * BD * N / 4; e += T) {
        const int j = e / (BD * N / 4), c4 = (e % (BD * N / 4)) * 4;
        const bool ok = t0 + j < S && c4 < live_ch * N;
        const size_t off = ok ? ((row0 + t0 + j) * D + ch0) * N + c4 : 0;
        cp_async16(sg + R::DS + j * BD * N + c4, d_in + off, ok);
      }
    }
    for (int e = tid; e < CHUNK * N / 4; e += T) {
      const int j = e / (N / 4), c4 = (e % (N / 4)) * 4;
      const bool ok = t0 + j < S;
      const size_t off = ok ? (row0 + t0 + j) * N + c4 : 0;
      cp_async16(sg + R::BS + j * N + c4, b_in + off, ok);
      if (rev) cp_async16(sg + R::CS + j * N + c4, c_in + off, ok);
    }
    cp_async_mbar_arrive(smem_addr(&full[i % R::STAGES]));
  };

  for (int i = 0; i < R::STAGES - 1 && i < n_items; ++i) issue(i);
  if (w == 0 && live) store_k<K>(ck, h);  // chunk 0 starts at the given state

  // Step j's dtx and K dta values from stage sg (fused: formed from dt, x and a as the forward).
  auto inputs = [&](const float* sg, int j, float& dtx, float (&dta)[K]) {
    if (FUSED) {
      const float dt = sg[R::DS + j * BD + lc];
      dtx = __fmul_rn(dt, sg[R::XS + j * BD + lc]);
#pragma unroll
      for (int i = 0; i < K; ++i) dta[i] = __fmul_rn(dt, av[i]);
    } else {
      dtx = sg[R::XS + j * BD + lc];
      load_k<K>(sg + R::DS + j * BD * N + lc * N + n0, dta);
    }
  };

  for (int i = 0; i < n_items; ++i) {
    // Refill the stage item i - 1 used (a fresh one at i = 0) with item i + STAGES - 1, once every
    // warp is done with item i - 1: its (in / STAGES - 1)-th use.
    const int in = i + R::STAGES - 1;
    if (in < n_items) {
      if (in >= R::STAGES) mbar_wait(smem_addr(&empty[in % R::STAGES]), (in / R::STAGES - 1) & 1);
      issue(in);
    }
    const int s = i % R::STAGES;
    float* const sg = ring + s * R::STAGE;

    if (i < n_fwd) {
      // The forward walk over chunk i: each group from a zero state to its pair, then the fold in
      // group order from the chunk's start state to the next chunk's.
      mbar_wait(smem_addr(&full[s]), (i / R::STAGES) & 1);
      float hr[K], ar[K];
#pragma unroll
      for (int k = 0; k < K; ++k) hr[k] = 0.f, ar[k] = 1.f;
#pragma unroll
      for (int jj = 0; jj < L; ++jj) {
        const int j = w * L + jj;
        float dtx, dta[K], bv[K];
        inputs(sg, j, dtx, dta);
        load_k<K>(sg + R::BS + j * N + n0, bv);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float e = ex2(__fmul_rn(dta[k], LOG2E));
          hr[k] = fmaf(e, hr[k], __fmul_rn(dtx, bv[k]));
          ar[k] = __fmul_rn(ar[k], e);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
      if constexpr (W > 1) {
        float* pb = pr + (i & 1) * (2 * W * BD * N);  // [W][P, E][BD][N], two buffers
        store_k<K>(pb + (w * 2 * BD + lc) * N + n0, ar);
        store_k<K>(pb + ((w * 2 + 1) * BD + lc) * N + n0, hr);
        __syncthreads();
#pragma unroll
        for (int v = 0; v < W; ++v) {
          float pv[K], ev[K];
          load_k<K>(pb + (v * 2 * BD + lc) * N + n0, pv);
          load_k<K>(pb + ((v * 2 + 1) * BD + lc) * N + n0, ev);
#pragma unroll
          for (int k = 0; k < K; ++k) h[k] = fmaf(pv[k], h[k], ev[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) h[k] = fmaf(ar[k], h[k], hr[k]);
      }
      if (w == 0 && live) store_k<K>(ck + (size_t)(i + 1) * D * N, h);
      continue;
    }

    // The reverse pass over chunk k.
    const int k = n_items - 1 - i;
    const int t0 = k * CHUNK;
    if (i == n_fwd) __syncthreads();  // the forward walk's pairs read, its chunk starts written
    float h0[K];
    {
      const float* src = ck + (size_t)k * D * N;  // written in this kernel: through L2
#pragma unroll
      for (int kk = 0; kk < K; ++kk) h0[kk] = live ? __ldcg(src + kk) : 0.f;
    }
    mbar_wait(smem_addr(&full[s]), (i / R::STAGES) & 1);

    // 1. Recompute: the group's steps from a zero state; hz[jj] the state after step jj, its
    // decays to shared memory (step j's K at e_at + j BD N); (ar, hz[L - 1]) the group's pair.
    float* const e_at = (FUSED ? ring + R::ES : sg + R::DS) + lc * N + n0;
    float hz[L][K], ar[K];
    {
      float hr[K];
#pragma unroll
      for (int kk = 0; kk < K; ++kk) hr[kk] = 0.f, ar[kk] = 1.f;
#pragma unroll
      for (int jj = 0; jj < L; ++jj) {
        const int j = w * L + jj;
        float dtx, dta[K], bv[K];
        inputs(sg, j, dtx, dta);
        load_k<K>(sg + R::BS + j * N + n0, bv);
        float e[K];
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          e[kk] = ex2(__fmul_rn(dta[kk], LOG2E));
          hr[kk] = fmaf(e[kk], hr[kk], __fmul_rn(dtx, bv[kk]));
          ar[kk] = __fmul_rn(ar[kk], e[kk]);
          hz[jj][kk] = hr[kk];
        }
        store_k<K>(e_at + j * BD * N, e);
      }
    }
    // [W][P, E, E'][BD][N]
    auto pair = [&](int v, int which) { return pr + ((v * 3 + which) * BD + lc) * N + n0; };
    if constexpr (W > 1) {
      store_k<K>(pair(w, 0), ar);
      store_k<K>(pair(w, 1), hz[L - 1]);
    }
    __syncthreads();  // the pairs; and the last chunk's partials and outputs have left

    // 2. States: hw, the chunk's start folded through the earlier groups' pairs; then each step's
    // state hz + az hw in place.
    float hw[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) hw[kk] = h0[kk];
    if constexpr (W > 1) {
      for (int v = 0; v < w; ++v) {
        float pv[K], ev[K];
        load_k<K>(pair(v, 0), pv);
        load_k<K>(pair(v, 1), ev);
#pragma unroll
        for (int kk = 0; kk < K; ++kk) hw[kk] = fmaf(pv[kk], hw[kk], ev[kk]);
      }
    }
    {
      float az[K];
#pragma unroll
      for (int kk = 0; kk < K; ++kk) az[kk] = 1.f;
#pragma unroll
      for (int jj = 0; jj < L; ++jj) {
        float e[K];
        load_k<K>(e_at + (w * L + jj) * BD * N, e);
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          az[kk] = __fmul_rn(az[kk], e[kk]);
          hz[jj][kk] = fmaf(az[kk], hw[kk], hz[jj][kk]);
        }
      }
    }

    // 3. The adjoint's pairs and fold: gin, the gradient entering this group; dh, leaving the chunk.
    float gin[K];
    if constexpr (W > 1) {
      {
        float gz[K];
#pragma unroll
        for (int kk = 0; kk < K; ++kk) gz[kk] = 0.f;
#pragma unroll
        for (int jj = L - 1; jj >= 0; --jj) {
          const int j = w * L + jj;
          const float dyv = sg[R::YS + j * BD + lc];
          float cv[K], e[K];
          load_k<K>(sg + R::CS + j * N + n0, cv);
          load_k<K>(e_at + j * BD * N, e);
#pragma unroll
          for (int kk = 0; kk < K; ++kk) gz[kk] = __fmul_rn(fmaf(dyv, cv[kk], gz[kk]), e[kk]);
        }
        store_k<K>(pair(w, 2), gz);
      }
      __syncthreads();
#pragma unroll
      for (int v = W - 1; v >= 0; --v) {
        if (v == w) {
#pragma unroll
          for (int kk = 0; kk < K; ++kk) gin[kk] = dh[kk];
        }
        float pv[K], ev[K];
        load_k<K>(pair(v, 0), pv);
        load_k<K>(pair(v, 2), ev);
#pragma unroll
        for (int kk = 0; kk < K; ++kk) dh[kk] = fmaf(pv[kk], dh[kk], ev[kk]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < K; ++kk) gin[kk] = dh[kk];
    }

    // 4. The walk back from gin with the outputs, four steps at a time: the sums over n reduced
    // across the channel's lanes (reduce4: lane q ends with step jb + q's), the sums over the
    // warp's channels by channel_sum, kept until the walk's end, then stored as the warps' partials.
    float csum[L];
#pragma unroll
    for (int jb = L - LANES; jb >= 0; jb -= LANES) {
      float acc1[LANES], acc2[LANES];
#pragma unroll
      for (int u = LANES - 1; u >= 0; --u) {
        const int jj = jb + u, j = w * L + jj, t = t0 + j;
        float dtx, dtv = 0.f;
        if (FUSED) {
          dtv = sg[R::DS + j * BD + lc];
          dtx = __fmul_rn(dtv, sg[R::XS + j * BD + lc]);
        } else {
          dtx = sg[R::XS + j * BD + lc];
        }
        const float dyv = sg[R::YS + j * BD + lc];
        float bv[K], cv[K], e[K], gdta[K], part[2 * K];
        load_k<K>(sg + R::BS + j * N + n0, bv);
        load_k<K>(sg + R::CS + j * N + n0, cv);
        load_k<K>(e_at + j * BD * N, e);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const float grad_h = fmaf(dyv, cv[kk], gin[kk]);
          const float ge = __fmul_rn(grad_h, e[kk]);
          gdta[kk] = __fmul_rn(ge, jj ? hz[jj - 1][kk] : hw[kk]);
          gin[kk] = ge;
          s1 = fmaf(grad_h, bv[kk], s1);
          if (FUSED) {
            s2 = fmaf(gdta[kk], av[kk], s2);
            da[kk] = fmaf(gdta[kk], dtv, da[kk]);
          }
          part[kk] = __fmul_rn(grad_h, dtx);
          part[K + kk] = __fmul_rn(dyv, hz[jj][kk]);
        }
        if (!FUSED && live && t < S) store_k<K>(gd + ((row0 + t) * D + ch) * N + n0, gdta);
        csum[jj] = channel_sum<2 * K>(part, lane);
        acc1[u] = s1;
        acc2[u] = s2;
      }
      const float y1 = reduce4(acc1, q);
      const int j = w * L + jb + q;
      if (FUSED) {
        const float y2 = reduce4(acc2, q);
        outs[j * BD + lc] = __fmul_rn(y1, sg[R::DS + j * BD + lc]);
        outs[(CHUNK + j) * BD + lc] = fmaf(y1, sg[R::XS + j * BD + lc], y2);
      } else {
        outs[j * BD + lc] = y1;
      }
    }
    {
      const int v = K == 4 ? (lane >> 2) & 7 : (lane >> 3) & 3;  // the value this lane holds
      if (K == 4 || !(lane & 4)) {
#pragma unroll
        for (int jj = 0; jj < L; ++jj) red[(((w * L + jj) * WG + wg) * 2 + v / K) * N + n0 + v % K] = csum[jj];
      }
    }
    if constexpr (W == 1) {
#pragma unroll
      for (int kk = 0; kk < K; ++kk) dh[kk] = gin[kk];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
    __syncthreads();

    // The chunk's db and dc partials (the warps' partials of each step summed in warp order), then
    // its d(dtx) or dx, and d(dt), a step's BD channels at a time.
    for (int e = tid; e < CHUNK * 2 * N / 4; e += T) {
      const int j = e / (2 * N / 4), r = (e % (2 * N / 4)) * 4, which = r / N, nn = r % N;
      const int t = t0 + j;
      if (t < S) {
        float4 acc = *reinterpret_cast<const float4*>(red + ((j * WG) * 2 + which) * N + nn);
#pragma unroll
        for (int g = 1; g < WG; ++g) {
          const float4 o = *reinterpret_cast<const float4*>(red + ((j * WG + g) * 2 + which) * N + nn);
          acc.x += o.x, acc.y += o.y, acc.z += o.z, acc.w += o.w;
        }
        float* dst = (which ? gc : gb) + (((size_t)bi * p.n_dblocks + dblk) * S + t) * N + nn;
        *reinterpret_cast<float4*>(dst) = acc;
      }
    }
    if (vec) {
      for (int e = tid; e < R::OUTS * CHUNK * BD / 4; e += T) {
        const int o = e / (CHUNK * BD / 4), r = e % (CHUNK * BD / 4);
        const int j = r / (BD / 4), c4 = (r % (BD / 4)) * 4, t = t0 + j;
        if (t < S && c4 < live_ch)
          *reinterpret_cast<float4*>((o ? gd : gx) + (row0 + t) * D + ch0 + c4) =
              *reinterpret_cast<const float4*>(outs + (o * CHUNK + j) * BD + c4);
      }
    } else {
      for (int e = tid; e < R::OUTS * CHUNK * BD; e += T) {
        const int o = e / (CHUNK * BD), r = e % (CHUNK * BD), j = r / BD, c1 = r % BD, t = t0 + j;
        if (t < S && c1 < live_ch) (o ? gd : gx)[(row0 + t) * D + ch0 + c1] = outs[(o * CHUNK + j) * BD + c1];
      }
    }
  }

  if (live && w == 0 && p.gs) store_k<K>(p.gs + st, dh);
  if constexpr (FUSED) {
    if constexpr (W > 1) {  // da's groups summed in group order
      store_k<K>(pr + (w * BD + lc) * N + n0, da);
      __syncthreads();
      if (w == 0 && live) {
        for (int v = 1; v < W; ++v) {
          float o[K];
          load_k<K>(pr + (v * BD + lc) * N + n0, o);
#pragma unroll
          for (int kk = 0; kk < K; ++kk) da[kk] += o[kk];
        }
        store_k<K>(p.ga + st, da);
      }
    } else if (live) {
      store_k<K>(p.ga + st, da);
    }
  }
}

template <int N, int BD, int CHUNK, bool FUSED>
cudaError_t run_bwd(BwdArgs p, int B, cudaStream_t stream) {
  using R = BwdRing<N, BD, CHUNK, FUSED>;
  auto kernel = &ssm_bwd_kernel<N, BD, CHUNK, FUSED>;
  p.n_dblocks = (p.D + BD - 1) / BD;
  const long long grid = (long long)p.n_dblocks * B;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, R::THREADS, R::BYTES, stream>>>(p);
  return cudaGetLastError();
}

// CTAs of ssm_bwd_kernel one SM holds at once; out[0] its registers a thread, out[1] its local
// (spilled) bytes a thread. -1 if a query fails.
template <int N, int BD, int CHUNK, bool FUSED>
int bwd_occupancy(int* out) {
  using R = BwdRing<N, BD, CHUNK, FUSED>;
  auto kernel = &ssm_bwd_kernel<N, BD, CHUNK, FUSED>;
  cudaFuncAttributes attr;
  int n = 0;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::BYTES) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, R::THREADS, R::BYTES) != cudaSuccess)
    return -1;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return n;
}

}  // namespace

// The compiled configs: block_d x chunk x N, each with both entries. The Python side
// (kernels/ssm.py::_BLOCK_DS, _CHUNKS and _STATES) lists the same sets and checks them against
// repro_ssm_configs() at load.
#define REPRO_SSM_BLOCK_DS(X) X(8) X(16) X(32)
#define REPRO_SSM_CHUNKS(X, BD) X(BD, 8) X(BD, 16) X(BD, 32)
#define REPRO_SSM_STATES(X, BD, C) X(BD, C, 8) X(BD, C, 16)

extern "C" {

// Writes (block_d, chunk, N, threads, smem bytes of the dta entry's output pass, of the fused
// entry's) per compiled instantiation; returns the count.
int repro_ssm_configs(int* out, int cap) {
  int n = 0;
#define Z(BD, C, NS)                                          \
  if (n < cap) {                                              \
    out[6 * n + 0] = BD;                                      \
    out[6 * n + 1] = C;                                       \
    out[6 * n + 2] = NS;                                      \
    out[6 * n + 3] = Ring<NS, BD, C, true, true>::THREADS;    \
    out[6 * n + 4] = Ring<NS, BD, C, false, true>::BYTES;     \
    out[6 * n + 5] = Ring<NS, BD, C, true, true>::BYTES;      \
  }                                                           \
  ++n;
#define Y(BD, C) REPRO_SSM_STATES(Z, BD, C)
#define X(BD) REPRO_SSM_CHUNKS(Y, BD)
  REPRO_SSM_BLOCK_DS(X)
#undef X
#undef Y
#undef Z
  return n;
}

// CTAs of the output pass one SM holds at once (registers, shared memory, threads), on the
// current device; -1 if the query fails.
int repro_ssm_occupancy(int block_d, int chunk, int n_state, int fused) {
#define Z(BD, C, NS)                                                      \
  if (block_d == BD && chunk == C && n_state == NS)                       \
    return fused ? occupancy<NS, BD, C, true>() : occupancy<NS, BD, C, false>();
#define Y(BD, C) REPRO_SSM_STATES(Z, BD, C)
#define X(BD) REPRO_SSM_CHUNKS(Y, BD)
  REPRO_SSM_BLOCK_DS(X)
#undef X
#undef Y
#undef Z
  return -1;
}

// The dta entry. dtx, y: (B, S, D); dta: (B, S, D, N); b, c: (B, S, N); s0 (may be null =
// zeros) and s_out: (B, D, N); ws: 2 x B x (n_seg - 1) x D x N floats (unused at n_seg = 1).
// All f32, contiguous, 16-byte aligned.
int repro_ssm(int block_d, int chunk, int n_state, const void* dtx, const void* dta,
              const void* b, const void* c, const void* s0, void* y, void* s_out, void* ws, int B,
              int S, int D, int n_seg, void* stream) {
  Args p{static_cast<const float*>(dtx), static_cast<const float*>(dta), nullptr,
         static_cast<const float*>(b),   static_cast<const float*>(c),   static_cast<const float*>(s0),
         static_cast<float*>(y),         static_cast<float*>(s_out),     static_cast<float*>(ws),
         S, D, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Z(BD, C, NS) \
  if (block_d == BD && chunk == C && n_state == NS) return (int)run<NS, BD, C, false>(p, B, n_seg, s);
#define Y(BD, C) REPRO_SSM_STATES(Z, BD, C)
#define X(BD) REPRO_SSM_CHUNKS(Y, BD)
  REPRO_SSM_BLOCK_DS(X)
#undef X
#undef Y
#undef Z
  return (int)cudaErrorInvalidValue;
}

// The fused entry. x, dt, y: (B, S, D); a: (D, N); the rest as repro_ssm.
int repro_ssm_fused(int block_d, int chunk, int n_state, const void* x, const void* dt,
                    const void* a, const void* b, const void* c, const void* s0, void* y,
                    void* s_out, void* ws, int B, int S, int D, int n_seg, void* stream) {
  Args p{static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
         static_cast<const float*>(b), static_cast<const float*>(c),  static_cast<const float*>(s0),
         static_cast<float*>(y),       static_cast<float*>(s_out),    static_cast<float*>(ws),
         S, D, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Z(BD, C, NS) \
  if (block_d == BD && chunk == C && n_state == NS) return (int)run<NS, BD, C, true>(p, B, n_seg, s);
#define Y(BD, C) REPRO_SSM_STATES(Z, BD, C)
#define X(BD) REPRO_SSM_CHUNKS(Y, BD)
  REPRO_SSM_BLOCK_DS(X)
#undef X
#undef Y
#undef Z
  return (int)cudaErrorInvalidValue;
}

// Writes (block_d, chunk, N, threads, smem bytes) of the backward per compiled instantiation
// (the dta entry's bytes, the larger; the fused entry's ring holds dt, not dta); returns the count.
int repro_ssm_bwd_configs(int* out, int cap) {
  int n = 0;
#define Z(BD, C, NS)                                \
  if (n < cap) {                                    \
    out[5 * n + 0] = BD;                            \
    out[5 * n + 1] = C;                             \
    out[5 * n + 2] = NS;                            \
    out[5 * n + 3] = BwdRing<NS, BD, C, false>::THREADS; \
    out[5 * n + 4] = BwdRing<NS, BD, C, false>::BYTES;   \
  }                                                 \
  ++n;
#define Y(BD, C) REPRO_SSM_STATES(Z, BD, C)
#define X(BD) REPRO_SSM_CHUNKS(Y, BD)
  REPRO_SSM_BLOCK_DS(X)
#undef X
#undef Y
#undef Z
  return n;
}

// The backward of either entry (fused = 1: x, dt, a in, dx, d(dt), da out; else dtx, dta in,
// d(dtx), d(dta) out). x, dt / dtx, dy, gx and (fused) gd: (B, S, D); dta and (dta entry) gd:
// (B, S, D, N); a: (D, N); b, c: (B, S, N); s0, ds (either may be null = zeros), gs (may be
// null: not written) and (fused) ga, da's partial per batch row: (B, D, N); ck: (B,
// ceil(S / chunk), D, N), the workspace; gb, gc: (B, ceil(D / block_d), S, N), the partials
// per channel block. All f32, contiguous.
int repro_ssm_bwd(int block_d, int chunk, int n_state, int fused, const void* x, const void* d, const void* a,
                  const void* b, const void* c, const void* s0, const void* dy, const void* ds, void* ck,
                  void* gx, void* gd, void* ga, void* gb, void* gc, void* gs, int B, int S, int D, void* stream) {
  BwdArgs p{static_cast<const float*>(x),  static_cast<const float*>(d),  static_cast<const float*>(a),
            static_cast<const float*>(b),  static_cast<const float*>(c),  static_cast<const float*>(s0),
            static_cast<const float*>(dy), static_cast<const float*>(ds), static_cast<float*>(ck),
            static_cast<float*>(gx),       static_cast<float*>(gd),       static_cast<float*>(ga),
            static_cast<float*>(gb),       static_cast<float*>(gc),       static_cast<float*>(gs),
            S, D, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Z(BD, C, NS)                                                                          \
  if (block_d == BD && chunk == C && n_state == NS)                                           \
    return fused ? (int)run_bwd<NS, BD, C, true>(p, B, s) : (int)run_bwd<NS, BD, C, false>(p, B, s);
#define Y(BD, C) REPRO_SSM_STATES(Z, BD, C)
#define X(BD) REPRO_SSM_CHUNKS(Y, BD)
  REPRO_SSM_BLOCK_DS(X)
#undef X
#undef Y
#undef Z
  return (int)cudaErrorInvalidValue;
}

// CTAs of the backward of ``fused``'s entry one SM holds at once, on the current device; regs[0]
// its registers a thread, regs[1] its spilled bytes a thread. -1 if the query fails.
int repro_ssm_bwd_occupancy(int block_d, int chunk, int n_state, int fused, int* regs) {
#define Z(BD, C, NS)                                                                      \
  if (block_d == BD && chunk == C && n_state == NS)                                       \
    return fused ? bwd_occupancy<NS, BD, C, true>(regs) : bwd_occupancy<NS, BD, C, false>(regs);
#define Y(BD, C) REPRO_SSM_STATES(Z, BD, C)
#define X(BD) REPRO_SSM_CHUNKS(Y, BD)
  REPRO_SSM_BLOCK_DS(X)
#undef X
#undef Y
#undef Z
  return -1;
}

const char* repro_ssm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
