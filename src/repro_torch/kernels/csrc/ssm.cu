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
// For one channel ch and state index n, with dh the gradient of h_t, from dh = ds_out at t = S:
//   dh += dy_t[ch] c_t[n];   d(dta)_t = dh e^{dta_t} h_{t-1};   d(dtx)_t = sum_n dh b_t[n];
//   db_t[n] = sum_ch dh dtx_t;   dc_t[n] = sum_ch dy_t h_t;   dh = e^{dta_t} dh,
// and d(state) the last dh. The fused entry forms dtx = dt x and dta = dt a as the forward, and
// gives dx = d(dtx) dt, d(dt) = d(dtx) x + sum_n d(dta) a and da = sum over B and S of
// d(dta) dt, so no (B, S, d, N) tensor is read or written. kernels/ref.py::ssm_scan_vjp_ref is the
// same algorithm in PyTorch.
//
// Design: one thread a (channel, state index), BD channels a CTA (BD x N threads), grid
// B x ceil(d / BD). A CTA first walks its channels forward through the whole sequence, writing
// the state at every chunk's start to a workspace ck (B, n_chunks, d, N); then it takes the
// chunks in reverse: it recomputes a chunk's CHUNK states from its start (in registers: the
// reverse step needs h_{t-1}, and dividing by e^{dta} to step back is unstable) and walks them
// back. The sums over n are shuffle trees within a channel's N lanes; the sums over channels
// (db, dc) a shuffle tree within a warp, then the warps' partials of every step of the chunk,
// summed in warp order after it, one partial a CTA (B, n_dblocks, S, N) that the wrapper sums
// over the channel blocks; da's partial is one per batch row (B, d, N). No atomics: two calls
// are bitwise equal. The backward is not cut into segments: a training call's grid (B 8 at
// hymba's d 1600: 800 CTAs at BD 16) fills the card, and the long single-row calls the forward
// cuts are prefills, which run no backward.
//
// Bound on this card: at hymba-1.5b's training shape (B 8, S 128, d 1600, N 16) the fused entry
// reads x, dt, dy (3 x 6.6 MB), a, b, c and writes dx, d(dt) (2 x 6.6 MB), db, dc and da: ~33 MB,
// 10 us at 3.35 TB/s; the work is ~25 f32 operations and two exponentials a (t, ch, n) (~0.2 us
// at 67 TFLOP/s). A step-by-step scan is bound in practice by its 2 S dependent steps.
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

template <int N, int BD, int CHUNK>
struct BwdShape {
  static constexpr int THREADS = BD * N;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int BYTES = CHUNK * WARPS * 2 * N * 4;  // every step's warp partials of db and dc
};

template <int N, int BD, int CHUNK, bool FUSED>
__global__ void __launch_bounds__(BwdShape<N, BD, CHUNK>::THREADS) ssm_bwd_kernel(const BwdArgs p) {
  using SH = BwdShape<N, BD, CHUNK>;
  constexpr int T = SH::THREADS, WARPS = SH::WARPS;
  static_assert(T % 32 == 0 && 32 % N == 0, "a warp holds whole channels");
  extern __shared__ __align__(16) float red[];  // [CHUNK][WARPS][2][N]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lc = tid / N, n = tid % N;
  const int bi = blockIdx.x / p.n_dblocks, dblk = blockIdx.x % p.n_dblocks;
  const int ch = dblk * BD + lc;
  const bool live = ch < p.D;
  const int S = p.S, D = p.D;
  const int n_chunks = (S + CHUNK - 1) / CHUNK;
  const size_t row0 = (size_t)bi * S;
  const float av = (FUSED && live) ? p.a[(size_t)ch * N + n] : 0.f;
  const size_t st = ((size_t)bi * D + ch) * N + n;
  auto ck = [&](int k) { return p.ck + ((size_t)(bi * n_chunks + k) * D + ch) * N + n; };

  // The inputs of step t: dtx, dta, b_n (zeros for a channel past d).
  auto step = [&](int t, float& dtx, float& dta, float& dt, float& xv) {
    const size_t i = (row0 + t) * D + ch;
    if (FUSED) {
      dt = live ? p.d[i] : 0.f;
      xv = live ? p.x[i] : 0.f;
      dtx = __fmul_rn(dt, xv);
      dta = __fmul_rn(dt, av);
    } else {
      dtx = live ? p.x[i] : 0.f;
      dta = live ? p.d[i * N + n] : 0.f;
    }
  };

  // 1. Forward: the state at every chunk's start.
  float h = (live && p.s0) ? p.s0[st] : 0.f;
  for (int t = 0; t < S; ++t) {
    if (t % CHUNK == 0 && live) *ck(t / CHUNK) = h;
    float dtx, dta, dt = 0.f, xv = 0.f;
    step(t, dtx, dta, dt, xv);
    h = fmaf(expf(dta), h, __fmul_rn(dtx, p.b[(row0 + t) * N + n]));
  }

  // 2. The chunks in reverse.
  float dh = (live && p.ds) ? p.ds[st] : 0.f;
  float da = 0.f;
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * CHUNK;
    const float h0 = live ? *ck(k) : 0.f;
    float hr[CHUNK];
    float hc = h0;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (t0 + j < S) {
        float dtx, dta, dt = 0.f, xv = 0.f;
        step(t0 + j, dtx, dta, dt, xv);
        hc = fmaf(expf(dta), hc, __fmul_rn(dtx, p.b[(row0 + t0 + j) * N + n]));
      }
      hr[j] = hc;
    }
#pragma unroll
    for (int j = CHUNK - 1; j >= 0; --j) {
      const int t = t0 + j;
      if (t >= S) continue;  // uniform over the CTA
      float dtx, dta, dt = 0.f, xv = 0.f;
      step(t, dtx, dta, dt, xv);
      const size_t i = (row0 + t) * D + ch;
      const float dyv = live ? p.dy[i] : 0.f;
      const float bn = p.b[(row0 + t) * N + n], cn = p.c[(row0 + t) * N + n];
      dh = fmaf(dyv, cn, dh);
      const float e = expf(dta);
      const float g_dta = dh * e * (j > 0 ? hr[j - 1] : h0);
      float s1 = dh * bn, s2 = g_dta * av;
      float pb = dh * dtx, pc = dyv * hr[j];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) {  // over the channel's N lanes
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        if (FUSED) s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
#pragma unroll
      for (int off = N; off < 32; off <<= 1) {  // over the warp's channels
        pb += __shfl_xor_sync(0xffffffffu, pb, off);
        pc += __shfl_xor_sync(0xffffffffu, pc, off);
      }
      if (lane < N) {
        red[((j * WARPS + warp) * 2 + 0) * N + n] = pb;
        red[((j * WARPS + warp) * 2 + 1) * N + n] = pc;
      }
      if (live) {
        if (FUSED) {
          da = fmaf(g_dta, dt, da);
          if (n == 0) {
            p.gx[i] = s1 * dt;
            p.gd[i] = fmaf(s1, xv, s2);
          }
        } else {
          p.gd[i * N + n] = g_dta;
          if (n == 0) p.gx[i] = s1;
        }
      }
      dh *= e;
    }
    __syncthreads();
    // The chunk's db and dc: the warps' partials of each step summed in warp order.
    for (int q = tid; q < CHUNK * 2 * N; q += T) {
      const int j = q / (2 * N), which = (q / N) % 2, nn = q % N;
      const int t = t0 + j;
      if (t < S) {
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += red[((j * WARPS + w) * 2 + which) * N + nn];
        (which ? p.gc : p.gb)[(((size_t)bi * p.n_dblocks + dblk) * S + t) * N + nn] = s;
      }
    }
    __syncthreads();
  }
  if (live) {
    if (p.gs) p.gs[st] = dh;
    if (FUSED) p.ga[st] = da;
  }
}

template <int N, int BD, int CHUNK, bool FUSED>
cudaError_t run_bwd(BwdArgs p, int B, cudaStream_t stream) {
  using SH = BwdShape<N, BD, CHUNK>;
  auto kernel = &ssm_bwd_kernel<N, BD, CHUNK, FUSED>;
  p.n_dblocks = (p.D + BD - 1) / BD;
  const long long grid = (long long)p.n_dblocks * B;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SH::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, SH::THREADS, SH::BYTES, stream>>>(p);
  return cudaGetLastError();
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

// Writes (block_d, chunk, N, threads, smem bytes) of the backward per compiled instantiation;
// returns the count.
int repro_ssm_bwd_configs(int* out, int cap) {
  int n = 0;
#define Z(BD, C, NS)                                \
  if (n < cap) {                                    \
    out[5 * n + 0] = BD;                            \
    out[5 * n + 1] = C;                             \
    out[5 * n + 2] = NS;                            \
    out[5 * n + 3] = BwdShape<NS, BD, C>::THREADS;  \
    out[5 * n + 4] = BwdShape<NS, BD, C>::BYTES;    \
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

const char* repro_ssm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
