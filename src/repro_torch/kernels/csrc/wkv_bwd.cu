// Backward of the chunked RWKV6 WKV for Hopper (sm_90a): the VJP of csrc/wkv.cu's function, as one
// reverse walk a head that carries the state's gradient in registers.
//
// Replaces: no TPU kernel. The TPU kernel (src/repro/kernels/wkv.py:114 wkv_pallas) has no
// backward; the JAX package trains RWKV6 through XLA's gradient of its jnp recurrence
// (src/repro/kernels/ops.py:426, the use_pallas=False path through
// src/repro/models/rwkv.py:92 wkv_chunked). This is that gradient on the card, which
// ops.wkv's autograd op (repro_torch::wkv) runs once per layer of every RWKV6 training step.
//
// For one head and one block of M positions (cum: the inclusive prefix sum of logw in the block,
// cp_t = cum_{t-1}, S0 / S1 the block's start / end state, keys x values; dS1 the gradient of S1;
// A[t][tau] = sum_c r_tc k_tau,c e^{cp_tc - cum_tau,c} for tau < t; dA[t][tau] = do_t . v_tau for
// tau < t; D_t = sum_c r_tc u_c k_tc; dD_t = do_t . v_t):
//   dS0   = e^{cum_M} (.)_rows dS1 + (r e^{cp})^T do        (d(state) for the first block)
//   dv    = A^T do + D do + (k e^{cum_M - cum}) dS1
//   dr    = (dA (.) e^{cp_t - cum_tau}) k + dD u k + e^{cp} (do S0^T)
//   dk    = (dA (.) e^{cp_t - cum_tau})^T r + dD u r + e^{cum_M - cum} (v dS1^T)
//   du    = sum over every position of dD r k
//   dlogw_s = sum over t >= s of (g_cum_t + g_cp_{t+1}), with g_cp = r (dr - dD u k),
//           g_cum = -k (dk - dD u r), and sum_j S1 dS1 added on the block's last row.
// kernels/ref.py::wkv_backward_ref states the same function chunk by chunk in PyTorch.
//
// The walk (wkv_bwd_walk_kernel): one CTA of 256 threads a (b, h) (or a (b, h, segment), below)
// walks the head's positions from the last to the first in blocks of M = min(chunk, 16) rows,
// carrying dS (hd x hd f32, a 4 x 4 tile a thread at hd 64) in registers: dS1 of a block is the
// carried dS, so no state-gradient workspace exists. At hd 64 each thread owns one channel col and
// the rows q, q + 4, q + 8, q + 12 (the column map: warp w holds channels 8w .. 8w + 7 and every
// row, so a channel's rows trade values by shuffles). Per block, in four phases between barriers:
//   1. dS1 into shared memory; cum down each channel by shuffles (a two-step scan in each set of
//      4 rows, then the sets' totals in order), cp, k^ = k e^{cum_M - cum}, e^{cum_M}; dA (dD on
//      its diagonal) and D once a block; do S0^T;
//   2. one pass over the pairs tau < t in blocks of 4 taus x a row, straight-line, that forms each
//      decay e^{cp_t - cum_tau} once a channel and feeds it to dr (in the row's own register), to
//      dk (a partial a row group, summed over the 4 row groups by shuffles) and to A (summed over
//      the warp's 8 channels by shuffles, a partial a warp); v dS1^T; dr and dk stored; g and
//      dlogw by shuffles (g_cp of the next row from its lane; the reverse scan as cum's);
//   3. A = the warps' partials in order;
//   4. k^ dS1, A^T do, D do: dv stored; dS <- e^{cum_M} (.) dS + (r e^{cp})^T do (4 x 4 register
//      tiles) and sum_j S0 dS, the next block's dlogw term, by a shuffle butterfly.
// The (M, hd) x (hd, hd) products run as float4 shared-memory reads, a row's 4 sums a thread. At
// hd 16 (the reduced config) a thread owns one channel of one row group (16 of them) and the same
// steps go through shared memory: runs of rows for the scans, dk's partials a row group, eleven
// barriers a block.
// A chunk longer than 16 rows (the forward's chunk 32, 64, 128) is walked as its blocks of 16: a
// short forward walk from the chunk's start state hs first forms the start state of each block
// (the same recurrence the forward runs), into the next ring stage for the last and into a
// per-CTA workspace ws for the others. Every input (r, k, v, logw, do, the start state) comes
// through a ring of 2 stages filled by 16-byte cp.async that completes on an mbarrier, so the next
// block's loads are in flight while this one computes.
//
// Segments: where B*H CTAs would leave the card's CTA slots empty, the wrapper
// (kernels/wkv.py::bwd_segment_len) cuts each head's chunks into segments of seg_len chunks, and
// the walk runs over (b*h, segment). wkv_bwd_state_kernel, a reverse pass over the chunks, then
// writes dS only at the segments' ends into dsw, (B*H, n_seg - 1, hd, hd) f32. With one segment
// (rwkv6-7b's training shape) it is not launched: one kernel a call.
//
// Bound on this card: at rwkv6-7b's training shape (B 8, S 128, H 64, hd 64, f32) the function
// reads r, k, v, logw, do (5 x 16.8 MB) and writes dr, dk, dv, dlogw (4 x 16.8 MB): 151 MB, 45 us
// at 3.35 TB/s; the walk also reads the forward's hs (67 MB), ~218 MB, 65 us. Its arithmetic is
// ~11 hd^2 f32 FMA a position and head (~3 Gop there, 45 us at 67 TFLOP/s) plus one exponential
// a (t, tau, channel).
//
// Numerics: every exponential is of a difference <= 0 (logw is clamped to [-5, -1e-3] by the
// model, so cum decreases): e^{cp_t - cum_tau} for tau < t, e^{cp}, e^{cum_M - cum}, e^{cum_M}.
// All math is f32 FMA in a fixed order (FFMA, no TF32, no tensor cores), with no atomics: du's
// partials go per (b, h, segment) and the wrapper sums them, so two calls on the same inputs are
// bitwise equal.
//
// Ragged tails are masked: positions past the sequence end load as zero r/k/v/do and logw 0,
// the forward's padding, and write nothing. Everything is read in the (B, S, H, hd) layout.
//
// Plain C interface, loaded with ctypes; the entry point launches the kernels on the given
// stream and returns the first cudaError_t.

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(bf16* p, float x) { *p = __float2bfloat16(x); }

// Arrives on the mbarrier once every cp.async this thread issued before has landed.
__device__ __forceinline__ void cp_async_mbar_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The sum over the W lanes of a warp that share lane / W, by a butterfly over the lane masks
// W / 2, ..., 1: every lane of the group gets (((x0 + x_{W/2}) + ...) ...), the same value.
template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// the reverse pass over the chunks, for segments
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int key_rows(int HD) { return HD > 16 ? HD / 2 : HD; }

// Shared memory of one state CTA, f32: r then r e^{cp} (L, KR), logw (L, KR), do (L, HD), e^{cum_L} (KR).
template <int L, int HD>
struct BwdStateSmem {
  static constexpr int KR = key_rows(HD);
  static constexpr int FLOATS = 2 * L * KR + L * HD + KR;
  static constexpr int BYTES = FLOATS * 4;
};

// Walks the chunks from the last to the first carrying dS (a tile of KR key rows x hd values a
// CTA, in registers), and writes dS1 of the last chunk of every segment but the last into dsw;
// it stops at the first segment's end.
template <typename T, int L, int HD>
__global__ void __launch_bounds__(kThreads)
    wkv_bwd_state_kernel(const T* __restrict__ r, const float* __restrict__ logw, const float* __restrict__ dout,
                         const float* __restrict__ ds_out, float* __restrict__ dsw, int S, int H, int seg_len,
                         int n_seg) {
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
    if ((ch + 1) % seg_len == 0 && ch + 1 < n_chunks) {  // the end of segment (ch + 1) / seg_len - 1
      float* dst = dsw + ((size_t)bh * (n_seg - 1) + (ch + 1) / seg_len - 1) * HD * HD;
#pragma unroll
      for (int a = 0; a < R; ++a) dst[(size_t)(kr0 + rg + RGN * a) * HD + j] = ds[a];
    }
    if (ch < seg_len) break;  // the first segment's chunks need no step
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
}

// ---------------------------------------------------------------------------
// the walk
// ---------------------------------------------------------------------------
// Shared memory of one walk CTA, in floats. Thread maps: "rows" (the (M, hd) outputs) channel col,
// row group q, rows q, q + NQ, ... (at hd 64 the column map: col = 8 warp + lane % 8, q = lane / 8;
// at hd 16 col = tid % 16, q = tid / 16); "tile" (the (hd, hd) state) a TS x TS tile at rows
// TS (tid / 16), columns TS (tid % 16); "runs" (the forward walk's prefix sums, and hd 16's) rows
// q RUN .. q RUN + RUN - 1.
template <int L, int HD>
struct WalkSmem {
  static constexpr int M = L < 16 ? L : 16;        // rows a block
  static constexpr int NSUB = L / M;               // blocks a chunk
  static constexpr int NQ = kThreads / HD;         // row groups of the rows map
  static constexpr int RPQ = (M + NQ - 1) / NQ;    // rows a thread of the rows map
  static constexpr int RUN = M >= NQ ? M / NQ : 1;  // rows a run
  static constexpr int NR = M / RUN;               // runs
  static constexpr int TS = HD / 16;               // side of a thread's state tile
  static constexpr int GW = HD >= 32 ? 32 : HD;    // lanes of a channel group (one warp's channels)
  static constexpr int NCG = HD / GW;              // channel groups
  static constexpr int PS = HD + 4;                // row stride of every tile (16-byte rows, banks spread)
  // One ring stage: r, k, v, logw (then cum), do as (M, PS), the start state as (HD, PS).
  static constexpr int R = 0, K = M * PS, V = 2 * M * PS, LW = 3 * M * PS, DO = 4 * M * PS, S0 = 5 * M * PS;
  static constexpr int STAGE = 5 * M * PS + HD * PS;
  static constexpr int UNI = 2 * STAGE;  // dS as (HD, PS) (hd 16: then dS^T), or hd 16's dk partials
  static constexpr int UNI_FLOATS = HD * PS > NQ * M * HD ? HD * PS : NQ * M * HD;
  // hd 64 walks in the column map: a warp is 8 channels x all M rows (row group q = lane / 8).
  static constexpr bool COLS = HD == 64;
  static constexpr int NAP = COLS ? kThreads / 32 : NCG;  // A's partial sums: a warp's, or a group's
  static constexpr int AP = UNI + UNI_FLOATS;  // A's partial sums (NAP, M, M); then A
  static constexpr int KH = AP + NAP * M * M;  // k^ = k e^{cum_M - cum} (M, PS), the column map's
  static constexpr int DA = KH + M * PS;       // dA (M, M), dD on its diagonal
  static constexpr int DD = DA + M * M;        // D (M)
  static constexpr int U = DD + M;             // u (HD)
  static constexpr int X = U + HD;             // sum_j S1 dS1 of the block being walked (HD)
  static constexpr int ECL = X + HD;           // e^{cum_M} (HD)
  static constexpr int TOT = ECL + HD;         // the runs' totals, then du's partials (NQ, HD)
  static constexpr int FLOATS = TOT + kThreads;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(HD % 16 == 0 && M % 8 == 0 && L % M == 0 && NR * RUN == M, "layout");
  static_assert(BYTES <= 227 * 1024 / 2, "two CTAs an SM");
};

struct WalkArgs {
  const void *r, *k, *v, *u;
  const float *logw, *dout, *ds_out, *hs, *s_fin, *dsw;
  float* ws;
  void *dr, *dk, *dv;
  float *dlogw, *du_part, *dstate;
  int S, H, seg_len, n_seg;
};

template <int TS>
__device__ __forceinline__ void load_ts(const float* p, float (&v)[TS]) {
  if constexpr (TS == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < TS; ++i) v[i] = p[i];
  }
}

template <int TS>
__device__ __forceinline__ void store_ts(float* p, const float (&v)[TS]) {
  if constexpr (TS == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < TS; ++i) p[i] = v[i];
  }
}

// acc = fma(a[0], b[0], acc), then a[1] b[1], ..., over 4 consecutive floats.
__device__ __forceinline__ float dot4(const float* a, const float* b, float acc) {
  const float4 x = *reinterpret_cast<const float4*>(a), y = *reinterpret_cast<const float4*>(b);
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

__device__ __forceinline__ float dot4(const float* a, const float4 y, float acc) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

template <typename T, typename TU, int L, int HD>
__global__ void __launch_bounds__(kThreads, 2) wkv_bwd_walk_kernel(const WalkArgs p) {
  using W = WalkSmem<L, HD>;
  constexpr int M = W::M, NSUB = W::NSUB, NQ = W::NQ, RPQ = W::RPQ, RUN = W::RUN, NR = W::NR, TS = W::TS;
  constexpr int GW = W::GW, PS = W::PS;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[2];
  float* const uni = smem + W::UNI;
  float* const sAp = smem + W::AP;
  float* const sdA = smem + W::DA;
  float* const sD = smem + W::DD;
  float* const su = smem + W::U;
  float* const sX = smem + W::X;
  float* const secl = smem + W::ECL;
  float* const stot = smem + W::TOT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The rows map and the runs: channel col, row group q (rows q, q + NQ, ...). In the column map
  // (hd 64) warp w holds channels 8w .. 8w + 7 and every row, so a channel's rows trade by shuffles.
  const int col = W::COLS ? 8 * warp + (lane & 7) : tid % HD;
  const int q = W::COLS ? lane >> 3 : tid / HD;
  const int cg = tid / 16, jg = tid % 16;  // the tile map
  const int S = p.S, H = p.H;
  const int n_chunks = (S + L - 1) / L;
  const int bh = blockIdx.x / p.n_seg, seg = blockIdx.x % p.n_seg;
  const int b = bh / H, h = bh % H;
  const int ch_lo = seg * p.seg_len, ch_hi = min(ch_lo + p.seg_len, n_chunks);
  const size_t row = (size_t)H * HD;
  const size_t base = (size_t)b * S * row + (size_t)h * HD;
  const float* const hs_bh = p.hs + (size_t)bh * n_chunks * HD * HD;
  float* const ws = NSUB > 2 ? p.ws + (size_t)blockIdx.x * (NSUB - 2) * HD * HD : nullptr;

  // The ring's items, in walk order: each chunk from the segment's last, as F_0 .. F_{n-2} (the
  // forward walk to its blocks' start states) then R_{n-1} .. R_0 (its blocks in reverse), with n
  // the chunk's blocks that hold a position (only the sequence's last chunk has fewer than NSUB).
  const int first_nsub = (min(L, S - (ch_hi - 1) * L) + M - 1) / M;
  constexpr int kPerChunk = 2 * NSUB - 1;
  const int first_items = 2 * first_nsub - 1;
  const int n_items = first_items + (ch_hi - 1 - ch_lo) * kPerChunk;
  struct Item {
    int ch, nsub, sub;
    bool rev;
  };
  auto item_at = [&](int i) {
    Item it;
    int local;
    if (i < first_items) {
      it.ch = ch_hi - 1, it.nsub = first_nsub, local = i;
    } else {
      const int j = i - first_items;
      it.ch = ch_hi - 2 - j / kPerChunk, it.nsub = NSUB, local = j % kPerChunk;
    }
    it.rev = local >= it.nsub - 1;
    it.sub = it.rev ? 2 * it.nsub - 2 - local : local;
    return it;
  };

  // Where r / k / v of row t, columns cc.. land in a stage's tile: in place for f32; bf16 lands
  // packed at the tile's end and is widened in place before use.
  auto raw = [&](float* tile, int t, int cc) -> T* {
    if constexpr (sizeof(T) == 4) {
      return reinterpret_cast<T*>(tile + t * PS + cc);
    } else {
      return reinterpret_cast<T*>(tile + M * PS) - M * HD + t * HD + cc;
    }
  };

  // Every thread issues its share of item i's copies into stage i % 2, then arrives on its mbarrier.
  auto issue = [&](int i) {
    const Item it = item_at(i);
    float* const sg = smem + (i & 1) * W::STAGE;
    const int r0 = it.ch * L + it.sub * M;
    const int valid = max(0, min(M, S - r0));
    const size_t g0 = base + (size_t)r0 * row;
    constexpr int P4 = HD / 4;
    for (int e = tid; e < M * P4; e += kThreads) {
      const int t = e / P4, c4 = (e % P4) * 4;
      const bool ok = t < valid;
      const size_t g = ok ? g0 + (size_t)t * row + c4 : 0;
      cp_async16(sg + W::LW + t * PS + c4, p.logw + g, ok);
      if (it.rev) cp_async16(sg + W::DO + t * PS + c4, p.dout + g, ok);
    }
    constexpr int PT = 16 / sizeof(T), NPT = HD / PT;  // elements a 16-byte piece, pieces a row
    const T* const rp = static_cast<const T*>(p.r);
    const T* const kp = static_cast<const T*>(p.k);
    const T* const vp = static_cast<const T*>(p.v);
    for (int e = tid; e < M * NPT; e += kThreads) {
      const int t = e / NPT, cc = (e % NPT) * PT;
      const bool ok = t < valid;
      const size_t g = ok ? g0 + (size_t)t * row + cc : 0;
      if (it.rev) cp_async16(raw(sg + W::R, t, cc), rp + g, ok);
      cp_async16(raw(sg + W::K, t, cc), kp + g, ok);
      cp_async16(raw(sg + W::V, t, cc), vp + g, ok);
    }
    // The start state: the forward's hs for a chunk's first block, the forward walk's for the
    // others (ws; the last one the walk writes into the stage itself).
    const float* s0 = nullptr;
    if (it.sub == 0) {
      s0 = hs_bh + (size_t)it.ch * HD * HD;
    } else if (it.rev && it.sub < it.nsub - 1) {
      s0 = ws + (size_t)(it.sub - 1) * HD * HD;
    }
    if (s0) {
      for (int e = tid; e < HD * P4; e += kThreads) {
        const int c = e / P4, j4 = (e % P4) * 4;
        cp_async16(sg + W::S0 + c * PS + j4, s0 + (size_t)c * HD + j4, true);
      }
    }
    cp_async_mbar_arrive(smem_addr(&full[i & 1]));
  };

  // bf16 r / k / v of a stage to f32 in place: every thread reads its pieces, then writes them.
  auto widen = [&](float* sg, bool with_r) {
    if constexpr (sizeof(T) == 2) {
      constexpr int NP = M * HD / 4, PER = (NP + kThreads - 1) / kThreads;
      float vals[3][PER][4];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        if (m == 0 && !with_r) continue;
        float* tile = sg + (m == 0 ? W::R : m == 1 ? W::K : W::V);
#pragma unroll
        for (int a = 0; a < PER; ++a) {
          const int e = tid + a * kThreads;
          if (e < NP) {
            const int t = e / (HD / 4), c4 = (e % (HD / 4)) * 4;
            const T* src = raw(tile, t, c4);
#pragma unroll
            for (int z = 0; z < 4; ++z) vals[m][a][z] = to_f32(src[z]);
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        if (m == 0 && !with_r) continue;
        float* tile = sg + (m == 0 ? W::R : m == 1 ? W::K : W::V);
#pragma unroll
        for (int a = 0; a < PER; ++a) {
          const int e = tid + a * kThreads;
          if (e < NP) {
            const int t = e / (HD / 4), c4 = (e % (HD / 4)) * 4;
            store_ts<4>(tile + t * PS + c4, vals[m][a]);
          }
        }
      }
      __syncthreads();
    }
  };

  // The inclusive prefix sum down each channel of an (M, HD) tile, in place: run q's rows by one
  // thread in order, then the earlier runs' totals in order (two barriers).
  auto prefix = [&](float* tile) {
    float loc[RUN];
    if (q < NR) {
      float run = 0.f;
#pragma unroll
      for (int a = 0; a < RUN; ++a) loc[a] = run += tile[(q * RUN + a) * PS + col];
      stot[q * HD + col] = run;
    }
    __syncthreads();
    if (q < NR) {
      float off = 0.f;
      for (int p2 = 0; p2 < q; ++p2) off += stot[p2 * HD + col];
#pragma unroll
      for (int a = 0; a < RUN; ++a) tile[(q * RUN + a) * PS + col] = off + loc[a];
    }
    __syncthreads();
  };

  // dA (dD on its diagonal: a thread a (t, tau), j in order) and D (a warp a row, a lane butterfly)
  // of the block in a stage, into shared memory.
  auto block_dots = [&](const float* sR, const float* sK, const float* sV, const float* sG) {
    if (tid < M * M) {
      const int t = tid / M, tau = tid % M;
      float acc = 0.f;
      if (tau <= t) {
#pragma unroll 4
        for (int j = 0; j < HD; j += 4) acc = dot4(sG + t * PS + j, sV + tau * PS + j, acc);
      }
      sdA[tid] = acc;
    }
    for (int t = warp; t < M; t += kThreads / 32) {
      float d = 0.f;
      for (int c = lane; c < HD; c += 32) d = fmaf(sR[t * PS + c] * su[c], sK[t * PS + c], d);
      d = group_sum<32>(d);
      if (lane == 0) sD[t] = d;
    }
  };

  float ds[TS][TS];  // the carried state gradient, the tile map's
  // dS0 = e^{cum_M} (.) dS1 + (r e^{cp})^T do (r~ = r e^{cp} and do in shared memory, t in order),
  // then sum_j S0 dS0 a key row (the tile's columns in order, then a butterfly): the next
  // block's dlogw term, into sX.
  auto state_step = [&](const float* sRt, const float* sG, const float* sS0) {
    float pa[TS][TS] = {};
    for (int t = 0; t < M; ++t) {
      float rr[TS], gg[TS];
      load_ts<TS>(sRt + t * PS + TS * cg, rr);
      load_ts<TS>(sG + t * PS + TS * jg, gg);
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int z = 0; z < TS; ++z) pa[a][z] = fmaf(rr[a], gg[z], pa[a][z]);
    }
#pragma unroll
    for (int a = 0; a < TS; ++a) {
      const int c = TS * cg + a;
      float s0[TS];
      load_ts<TS>(sS0 + c * PS + TS * jg, s0);
      float x = 0.f;
#pragma unroll
      for (int z = 0; z < TS; ++z) {
        ds[a][z] = fmaf(secl[c], ds[a][z], pa[a][z]);
        x = fmaf(s0[z], ds[a][z], x);
      }
      x = group_sum<16>(x);
      if (jg == 0) sX[c] = x;
    }
  };

  // Set-up: u, dS1 of the segment's last block (the cotangent, or the reverse pass's), and
  // sum_j S1 dS1 there (S1 the final state, or the next segment's first start state).
  for (int c = tid; c < HD; c += kThreads) su[c] = to_f32(static_cast<const TU*>(p.u)[(size_t)h * HD + c]);
  {
    const float* ds0 = seg + 1 < p.n_seg ? p.dsw + ((size_t)bh * (p.n_seg - 1) + seg) * HD * HD
                                         : (p.ds_out ? p.ds_out + (size_t)bh * HD * HD : nullptr);
    const float* s1 = ch_hi == n_chunks ? p.s_fin + (size_t)bh * HD * HD : hs_bh + (size_t)ch_hi * HD * HD;
#pragma unroll
    for (int a = 0; a < TS; ++a) {
      const int c = TS * cg + a;
      float x = 0.f;
#pragma unroll
      for (int z = 0; z < TS; ++z) {
        const int j = TS * jg + z;
        ds[a][z] = ds0 ? ds0[(size_t)c * HD + j] : 0.f;
        x = fmaf(s1[(size_t)c * HD + j], ds[a][z], x);
      }
      x = group_sum<16>(x);
      if (jg == 0) sX[c] = x;
    }
  }
  float st[TS][TS];  // the forward walk's state (chunks longer than 16 rows)
  float du_acc = 0.f;

  if (tid == 0) {
    mbar_init(smem_addr(&full[0]), kThreads);
    mbar_init(smem_addr(&full[1]), kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  issue(0);

  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) issue(i + 1);  // into the stage item i - 1 used: every thread is past it
    const Item it = item_at(i);
    float* const sg = smem + (i & 1) * W::STAGE;
    float* const sR = sg + W::R;
    float* const sK = sg + W::K;
    float* const sV = sg + W::V;
    float* const sW = sg + W::LW;
    float* const sG = sg + W::DO;
    float* const sS0 = sg + W::S0;
    mbar_wait(smem_addr(&full[i & 1]), (i >> 1) & 1);
    widen(sg, it.rev);

    if (!it.rev) {
      if constexpr (NSUB > 1) {
        // F: the state at the next block's start, st <- e^{cum_M} (.) st + (k e^{cum_M - cum})^T v.
        if (it.sub == 0) {
#pragma unroll
          for (int a = 0; a < TS; ++a) load_ts<TS>(sS0 + (TS * cg + a) * PS + TS * jg, st[a]);
        }
        prefix(sW);
        for (int e = tid; e < M * HD; e += kThreads) {
          const int t = e / HD, c = e % HD;
          sK[t * PS + c] *= __expf(sW[(M - 1) * PS + c] - sW[t * PS + c]);
        }
        if (tid < HD) secl[tid] = __expf(sW[(M - 1) * PS + tid]);
        __syncthreads();
        float acc[TS][TS] = {};
        for (int t = 0; t < M; ++t) {
          float kk[TS], vv[TS];
          load_ts<TS>(sK + t * PS + TS * cg, kk);
          load_ts<TS>(sV + t * PS + TS * jg, vv);
#pragma unroll
          for (int a = 0; a < TS; ++a)
#pragma unroll
            for (int z = 0; z < TS; ++z) acc[a][z] = fmaf(kk[a], vv[z], acc[a][z]);
        }
#pragma unroll
        for (int a = 0; a < TS; ++a)
#pragma unroll
          for (int z = 0; z < TS; ++z) st[a][z] = fmaf(secl[TS * cg + a], st[a][z], acc[a][z]);
        if (it.sub + 2 < it.nsub) {  // a later block's start: ws, read back by cp.async two items on
          float* const dst = ws + (size_t)it.sub * HD * HD;
#pragma unroll
          for (int a = 0; a < TS; ++a) store_ts<TS>(dst + (size_t)(TS * cg + a) * HD + TS * jg, st[a]);
          __threadfence();
        } else {  // the next item's start state, in its stage (st.shared: the stage is a copy target)
          const unsigned nxt = smem_addr(smem + ((i + 1) & 1) * W::STAGE + W::S0);
#pragma unroll
          for (int a = 0; a < TS; ++a)
#pragma unroll
            for (int z = 0; z < TS; ++z)
              asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(nxt + 4u * ((TS * cg + a) * PS + TS * jg + z)),
                           "f"(st[a][z])
                           : "memory");
        }
        __syncthreads();
      }
      continue;
    }

    // R: block it.sub of chunk it.ch, rows r0 .. r0 + M - 1 (valid of them in the sequence).
    const int r0 = it.ch * L + it.sub * M;
    const int valid = max(0, min(M, S - r0));
    const size_t g0 = base + (size_t)r0 * row;

    if constexpr (W::COLS) {
      static_assert(NQ == 4 && RPQ * 4 == M, "the column map");
      float* const sKh = smem + W::KH;
      const int up = (lane + 24) & 31, down = (lane + 8) & 31;  // row t - 1's lane, row t + 1's lane
      // 1. dS1 into uni; cum down each channel by shuffles (a prefix over the 4 row groups of each
      //    set of 4 rows, then the sets' totals in order); cp, k^, e^{cum_M}; dA, D; do S0^T.
#pragma unroll
      for (int a = 0; a < TS; ++a) store_ts<TS>(uni + (TS * cg + a) * PS + TS * jg, ds[a]);
      float ri[RPQ], ki[RPQ], cum[RPQ], cpi[RPQ], dec[RPQ], tot[RPQ];
#pragma unroll
      for (int a = 0; a < RPQ; ++a) {
        const int t = q + NQ * a;
        ri[a] = sR[t * PS + col];
        ki[a] = sK[t * PS + col];
        float x = sW[t * PS + col];
        float y = __shfl_sync(kFull, x, up);
        if (q >= 1) x = y + x;
        y = __shfl_sync(kFull, x, (lane + 16) & 31);
        if (q >= 2) x = y + x;
        cum[a] = x;
        tot[a] = __shfl_sync(kFull, x, (lane & 7) | 24);
      }
      float off = 0.f;
#pragma unroll
      for (int a = 0; a < RPQ; ++a) {
        if (a > 0) {
          off = a > 1 ? off + tot[a - 1] : tot[0];
          cum[a] = off + cum[a];
        }
      }
      const float cl = off + tot[RPQ - 1];  // cum at the block's last row
#pragma unroll
      for (int a = 0; a < RPQ; ++a) {
        const int t = q + NQ * a;
        sW[t * PS + col] = cum[a];
        dec[a] = __expf(cl - cum[a]);
        sKh[t * PS + col] = ki[a] * dec[a];
      }
      float prevc[RPQ];
#pragma unroll
      for (int a = 0; a < RPQ; ++a) prevc[a] = __shfl_sync(kFull, cum[a], up);
#pragma unroll
      for (int a = 0; a < RPQ; ++a) cpi[a] = q > 0 ? prevc[a] : (a > 0 ? prevc[a - 1] : 0.f);
      if (q == 0) secl[col] = __expf(cl);
      block_dots(sR, sK, sV, sG);
      float pr[RPQ];  // do S0^T, for dr
#pragma unroll
      for (int a = 0; a < RPQ; ++a) pr[a] = 0.f;
#pragma unroll 4
      for (int j = 0; j < HD; j += 4) {
        const float4 s0 = *reinterpret_cast<const float4*>(sS0 + col * PS + j);
#pragma unroll
        for (int a = 0; a < RPQ; ++a) pr[a] = dot4(sG + (q + NQ * a) * PS + j, s0, pr[a]);
      }
      __syncthreads();

      // 2. The pairs tau < t (blocks of a tau group g and a row a >= g; the block g = a masks
      //    tau >= t): each decay formed once for dr (in this thread), dk (the group's partials
      //    summed over the 4 row groups by shuffles) and A (over the warp's 8 channels by
      //    shuffles, then the warps in order). Then v dS1^T, and dr, dk, g, dlogw.
      float dra[RPQ], dka[RPQ];
#pragma unroll
      for (int a = 0; a < RPQ; ++a) dra[a] = 0.f;
#pragma unroll
      for (int g = 0; g < RPQ; ++g) {
        float dk4[4] = {0.f, 0.f, 0.f, 0.f};
        float ct[4], kt[4];
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          ct[z] = sW[(4 * g + z) * PS + col];
          kt[z] = sK[(4 * g + z) * PS + col];
        }
#pragma unroll
        for (int a = g; a < RPQ; ++a) {
          const int t = q + NQ * a;
          float av[4], dab[4];
          load_ts<4>(sdA + t * M + 4 * g, dab);
#pragma unroll
          for (int z = 0; z < 4; ++z) {
            const int tau = 4 * g + z;
            if (a == g && z == 3) {  // tau = 4g + 3 >= t on the diagonal block, for every lane
              av[z] = 0.f;
              continue;
            }
            const bool live = a > g || tau < t;
            const float e = live ? __expf(cpi[a] - ct[z]) : 0.f;
            const float da = live ? dab[z] : 0.f;
            const float x = kt[z] * e;
            dra[a] = fmaf(da, x, dra[a]);
            dk4[z] = fmaf(da * ri[a], e, dk4[z]);
            av[z] = ri[a] * x;
          }
          // av[z] summed over the warp's 8 channels, lane bits 2 and 1 picking z: a butterfly.
          const bool h4 = lane & 4, h2 = lane & 2;
          float b0 = h4 ? av[2] : av[0], b1 = h4 ? av[3] : av[1];
          b0 += __shfl_xor_sync(kFull, h4 ? av[0] : av[2], 4);
          b1 += __shfl_xor_sync(kFull, h4 ? av[1] : av[3], 4);
          float b = h2 ? b1 : b0;
          b += __shfl_xor_sync(kFull, h2 ? b0 : b1, 2);
          b += __shfl_xor_sync(kFull, b, 1);
          const int tau = 4 * g + 2 * (h4 ? 1 : 0) + (h2 ? 1 : 0);
          if (!(lane & 1) && tau < t) sAp[(warp * M + t) * M + tau] = b;
        }
        // dk's partials of taus 4g .. 4g + 3 summed over the row groups: lane gets tau 4g + q,
        // its row t_g's, as (q0 + q2) + (q1 + q3).
        const bool h16 = lane & 16, h8 = lane & 8;
        float c0 = h16 ? dk4[2] : dk4[0], c1 = h16 ? dk4[3] : dk4[1];
        c0 += __shfl_xor_sync(kFull, h16 ? dk4[0] : dk4[2], 16);
        c1 += __shfl_xor_sync(kFull, h16 ? dk4[1] : dk4[3], 16);
        float c = h8 ? c1 : c0;
        dka[g] = c + __shfl_xor_sync(kFull, h8 ? c0 : c1, 8);
      }
      float pk[RPQ];  // v dS1^T, for dk
#pragma unroll
      for (int a = 0; a < RPQ; ++a) pk[a] = 0.f;
#pragma unroll 4
      for (int j = 0; j < HD; j += 4) {
        const float4 d1 = *reinterpret_cast<const float4*>(uni + col * PS + j);
#pragma unroll
        for (int a = 0; a < RPQ; ++a) pk[a] = dot4(sV + (q + NQ * a) * PS + j, d1, pk[a]);
      }
      float gcp[RPQ], gcum[RPQ];
#pragma unroll
      for (int a = 0; a < RPQ; ++a) {
        const int t = q + NQ * a;
        const float dd = sdA[t * M + t];
        const float in_r = fmaf(__expf(cpi[a]), pr[a], dra[a]);
        const float in_k = fmaf(dec[a], pk[a], dka[a]);
        if (t < valid) {
          from_f32(static_cast<T*>(p.dr) + g0 + (size_t)t * row + col, fmaf(dd * su[col], ki[a], in_r));
          from_f32(static_cast<T*>(p.dk) + g0 + (size_t)t * row + col, fmaf(dd * su[col], ri[a], in_k));
        }
        gcp[a] = ri[a] * in_r;
        gcum[a] = -ki[a] * in_k;
        du_acc = fmaf(dd * ri[a], ki[a], du_acc);
        sR[t * PS + col] = ri[a] * __expf(cpi[a]);  // r~ = r e^{cp}, for dS0
      }
      // g = g_cum + g_cp of the row after (the next row group's lane; row group 3's next row is
      // row group 0's next row set), or sum_j S1 dS1 on the last row; dlogw its reverse prefix by
      // shuffles (over the 4 row groups of each row set, then the later sets' totals in order).
      float nxt[RPQ];
#pragma unroll
      for (int a = 0; a < RPQ; ++a) nxt[a] = __shfl_sync(kFull, gcp[a], down);
      float gs[RPQ];
#pragma unroll
      for (int a = 0; a < RPQ; ++a) {
        const float after = q < 3 ? nxt[a] : (a + 1 < RPQ ? nxt[a + 1] : sX[col]);
        float x = gcum[a] + after;
        float y = __shfl_sync(kFull, x, down);
        if (q <= 2) x = x + y;
        y = __shfl_sync(kFull, x, (lane + 16) & 31);
        if (q <= 1) x = x + y;
        gs[a] = x;
        tot[a] = __shfl_sync(kFull, x, lane & 7);
      }
      off = 0.f;
#pragma unroll
      for (int a = RPQ - 1; a >= 0; --a) {
        if (a < RPQ - 1) {
          off = a < RPQ - 2 ? off + tot[a + 1] : tot[RPQ - 1];
          gs[a] = off + gs[a];
        }
        const int t = q + NQ * a;
        if (t < valid) p.dlogw[g0 + (size_t)t * row + col] = gs[a];
      }
      __syncthreads();

      // 3. A = the warps' partials in order.
      if (tid < M * M && tid % M < tid / M) {
        float x = sAp[tid];
#pragma unroll
        for (int w = 1; w < W::NAP; ++w) x += sAp[w * M * M + tid];
        sAp[tid] = x;
      }
      __syncthreads();

      // 4. dv = k^ dS1 + A^T do + D do; dS0 = e^{cum_M} (.) dS1 + (r e^{cp})^T do; sum_j S0 dS0.
      float pv[RPQ];
#pragma unroll
      for (int a = 0; a < RPQ; ++a) pv[a] = 0.f;
#pragma unroll 4
      for (int c = 0; c < HD; c += 4) {
        const float4 d1 = make_float4(uni[c * PS + col], uni[(c + 1) * PS + col], uni[(c + 2) * PS + col],
                                      uni[(c + 3) * PS + col]);
#pragma unroll
        for (int a = 0; a < RPQ; ++a) pv[a] = dot4(sKh + (q + NQ * a) * PS + c, d1, pv[a]);
      }
#pragma unroll
      for (int tp = 1; tp < M; ++tp) {
        const float gt = sG[tp * PS + col];
#pragma unroll
        for (int a = 0; a < RPQ; ++a) {
          const int t = q + NQ * a;
          if (tp > t) pv[a] = fmaf(sAp[tp * M + t], gt, pv[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < RPQ; ++a) {
        const int t = q + NQ * a;
        if (t < valid)
          from_f32(static_cast<T*>(p.dv) + g0 + (size_t)t * row + col, fmaf(sD[t], sG[t * PS + col], pv[a]));
      }
      state_step(sR, sG, sS0);
      __syncthreads();  // the stage and uni are free
      continue;
    }

    // 1. The prefix's runs; dA (dD on its diagonal); D.
    float loc[RUN];
    if (q < NR) {
      float run = 0.f;
#pragma unroll
      for (int a = 0; a < RUN; ++a) loc[a] = run += sW[(q * RUN + a) * PS + col];
      stot[q * HD + col] = run;
    }
    block_dots(sR, sK, sV, sG);
    __syncthreads();
    if (q < NR) {
      float off = 0.f;
      for (int p2 = 0; p2 < q; ++p2) off += stot[p2 * HD + col];
#pragma unroll
      for (int a = 0; a < RUN; ++a) sW[(q * RUN + a) * PS + col] = off + loc[a];
      if (q == NR - 1) secl[col] = __expf(off + loc[RUN - 1]);
    }
    __syncthreads();

    // 2. The pairs tau < t, each decay formed once: dr's pair part in the thread of (t, c), dk's
    //    as a partial a row group (uni as (NQ, M, HD)), A's summed over a channel group.
    float ri[RPQ], cpi[RPQ], dra[RPQ];
#pragma unroll
    for (int a = 0; a < RPQ; ++a) {
      const int t = q + NQ * a;
      ri[a] = t < M ? sR[t * PS + col] : 0.f;
      cpi[a] = t < M && t > 0 ? sW[(t - 1) * PS + col] : 0.f;
      dra[a] = 0.f;
    }
    // Two row groups a warp (hd 16): each pair's A-term summed over its group's 16 lanes.
    for (int tau = 0; tau + 1 < M; ++tau) {
      const float ct = sW[tau * PS + col], kt = sK[tau * PS + col];
      float dkt = 0.f;
#pragma unroll
      for (int a = 0; a < RPQ; ++a) {
        const int t = q + NQ * a;
        const bool live = t < M && tau < t;
        const float e = live ? __expf(cpi[a] - ct) : 0.f;
        const float da = live ? sdA[t * M + tau] : 0.f;
        const float x = kt * e;
        dra[a] = fmaf(da, x, dra[a]);
        dkt = fmaf(da * ri[a], e, dkt);
        const float s = group_sum<GW>(ri[a] * x);
        if (live && col % GW == 0) sAp[((col / GW) * M + t) * M + tau] = s;
      }
      uni[(q * M + tau) * HD + col] = dkt;
    }
    __syncthreads();

    // 3. dk's pair part = the row groups' partials in order; dr = dr's pair part + e^{cp} (do S0^T)
    //    + dD u k; du's partial.
    float dka[RPQ], acc[RPQ], gcp[RPQ];
#pragma unroll
    for (int a = 0; a < RPQ; ++a) {
      const int t = q + NQ * a;
      float s = 0.f;
      if (t + 1 < M) {
#pragma unroll
        for (int p2 = 0; p2 < NQ; ++p2) s += uni[(p2 * M + t) * HD + col];
      }
      dka[a] = s;
      acc[a] = 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < HD; j += 4) {
      const float4 m = *reinterpret_cast<const float4*>(sS0 + col * PS + j);
#pragma unroll
      for (int a = 0; a < RPQ; ++a)
        if (q + NQ * a < M) acc[a] = dot4(sG + (q + NQ * a) * PS + j, m, acc[a]);
    }
#pragma unroll
    for (int a = 0; a < RPQ; ++a) {
      const int t = q + NQ * a;
      gcp[a] = 0.f;
      if (t < M) {
        const float dd = sdA[t * M + t], kv = sK[t * PS + col];
        const float in = fmaf(__expf(cpi[a]), acc[a], dra[a]);
        if (t < valid) from_f32(static_cast<T*>(p.dr) + g0 + (size_t)t * row + col, fmaf(dd * su[col], kv, in));
        gcp[a] = ri[a] * in;
        du_acc = fmaf(dd * ri[a], kv, du_acc);
      }
    }
    __syncthreads();  // the dk partials are read: uni takes dS1
#pragma unroll
    for (int a = 0; a < TS; ++a) store_ts<TS>(uni + (TS * cg + a) * PS + TS * jg, ds[a]);
    __syncthreads();

    // 4. dk = dk's pair part + e^{cum_M - cum} (v dS1^T) + dD u r; g_cum; k^ = k e^{cum_M - cum}.
    float gcum[RPQ];
#pragma unroll
    for (int a = 0; a < RPQ; ++a) acc[a] = 0.f;
#pragma unroll 4
    for (int j = 0; j < HD; j += 4) {
      const float4 m = *reinterpret_cast<const float4*>(uni + col * PS + j);
#pragma unroll
      for (int a = 0; a < RPQ; ++a)
        if (q + NQ * a < M) acc[a] = dot4(sV + (q + NQ * a) * PS + j, m, acc[a]);
    }
#pragma unroll
    for (int a = 0; a < RPQ; ++a) {
      const int t = q + NQ * a;
      gcum[a] = 0.f;
      if (t < M) {
        const float dec = __expf(sW[(M - 1) * PS + col] - sW[t * PS + col]);
        const float in = fmaf(dec, acc[a], dka[a]);
        if (t < valid)
          from_f32(static_cast<T*>(p.dk) + g0 + (size_t)t * row + col, fmaf(sdA[t * M + t] * su[col], ri[a], in));
        const float kv = sK[t * PS + col];
        gcum[a] = -kv * in;
        sK[t * PS + col] = kv * dec;
      }
    }
    __syncthreads();  // dS1 and v are read: uni takes dS1^T, v's tile g_cp
#pragma unroll
    for (int z = 0; z < TS; ++z) {
      float colv[TS];
#pragma unroll
      for (int a = 0; a < TS; ++a) colv[a] = ds[a][z];
      store_ts<TS>(uni + (TS * jg + z) * PS + TS * cg, colv);
    }
#pragma unroll
    for (int a = 0; a < RPQ; ++a)
      if (q + NQ * a < M) sV[(q + NQ * a) * PS + col] = gcp[a];
    __syncthreads();

    // 5. dv = k^ dS1 + A^T do + D do (col is a value column here); g = g_cum + g_cp of the row
    //    after, or sum_j S1 dS1 on the block's last row.
#pragma unroll
    for (int a = 0; a < RPQ; ++a) acc[a] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float4 m = *reinterpret_cast<const float4*>(uni + col * PS + c);
#pragma unroll
      for (int a = 0; a < RPQ; ++a)
        if (q + NQ * a < M) acc[a] = dot4(sK + (q + NQ * a) * PS + c, m, acc[a]);
    }
#pragma unroll
    for (int tp = 1; tp < M; ++tp) {  // A^T do: each row's terms in tp's order, the rows side by side
      const float gt = sG[tp * PS + col];
#pragma unroll
      for (int a = 0; a < RPQ; ++a) {
        const int t = q + NQ * a;
        if (tp > t) acc[a] = fmaf(sAp[tp * M + t], gt, acc[a]);
      }
    }
    float g[RPQ];
#pragma unroll
    for (int a = 0; a < RPQ; ++a) {
      const int t = q + NQ * a;
      g[a] = 0.f;
      if (t < M) {
        const float x = fmaf(sD[t], sG[t * PS + col], acc[a]);
        if (t < valid) from_f32(static_cast<T*>(p.dv) + g0 + (size_t)t * row + col, x);
        g[a] = gcum[a] + (t + 1 < M ? sV[(t + 1) * PS + col] : sX[col]);
      }
    }
    __syncthreads();  // g_cp is read: v's tile takes g
#pragma unroll
    for (int a = 0; a < RPQ; ++a)
      if (q + NQ * a < M) sV[(q + NQ * a) * PS + col] = g[a];
    __syncthreads();

    // 6. dlogw: the reverse prefix of g down each channel (runs, then the later runs' totals);
    //    r~ = r e^{cp} in place.
    if (q < NR) {
      float run = 0.f;
#pragma unroll
      for (int a = RUN - 1; a >= 0; --a) loc[a] = run += sV[(q * RUN + a) * PS + col];
      stot[q * HD + col] = run;
    }
#pragma unroll
    for (int a = 0; a < RPQ; ++a)
      if (q + NQ * a < M) sR[(q + NQ * a) * PS + col] = ri[a] * __expf(cpi[a]);
    __syncthreads();
    if (q < NR) {
      float off = 0.f;
      for (int p2 = NR - 1; p2 > q; --p2) off += stot[p2 * HD + col];
#pragma unroll
      for (int a = 0; a < RUN; ++a) {
        const int t = q * RUN + a;
        if (t < valid) p.dlogw[g0 + (size_t)t * row + col] = off + loc[a];
      }
    }

    // 7. dS0 = e^{cum_M} (.) dS1 + (r e^{cp})^T do, then sum_j S0 dS0 for the block before.
    state_step(sR, sG, sS0);
    __syncthreads();  // the stage is free for item i + 2
  }

  // d(state) from the first segment; du's partial: the row groups' in order.
  if (seg == 0 && p.dstate) {
#pragma unroll
    for (int a = 0; a < TS; ++a) {
      const int c = TS * cg + a;
#pragma unroll
      for (int z = 0; z < TS; ++z) p.dstate[((size_t)bh * HD + c) * HD + TS * jg + z] = ds[a][z];
    }
  }
  stot[q * HD + col] = du_acc;
  __syncthreads();
  if (q == 0) {
    float s = 0.f;
#pragma unroll
    for (int p2 = 0; p2 < NQ; ++p2) s += stot[p2 * HD + col];
    p.du_part[(size_t)blockIdx.x * HD + col] = s;
  }
}

template <typename T, typename TU, int L, int HD>
cudaError_t run(const WalkArgs& p, int B, cudaStream_t stream) {
  using SS = BwdStateSmem<L, HD>;
  using WS = WalkSmem<L, HD>;
  const int n_chunks = (p.S + L - 1) / L;
  if (p.seg_len < 1 || p.n_seg != (n_chunks + p.seg_len - 1) / p.seg_len || (p.n_seg > 1 && !p.dsw) ||
      (WS::NSUB > 2 && !p.ws))
    return cudaErrorInvalidValue;
  auto walk = &wkv_bwd_walk_kernel<T, TU, L, HD>;
  // Above 48 KB a kernel may use dynamic shared memory only after opting in.
  cudaError_t err = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize, WS::BYTES);
  if (err != cudaSuccess) return err;
  if (p.n_seg > 1) {
    auto state = &wkv_bwd_state_kernel<T, L, HD>;
    err = cudaFuncSetAttribute(state, cudaFuncAttributeMaxDynamicSharedMemorySize, SS::BYTES);
    if (err != cudaSuccess) return err;
    state<<<dim3(B * p.H, HD / SS::KR), kThreads, SS::BYTES, stream>>>(
        static_cast<const T*>(p.r), p.logw, p.dout, p.ds_out, const_cast<float*>(p.dsw), p.S, p.H, p.seg_len,
        p.n_seg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  walk<<<B * p.H * p.n_seg, kThreads, WS::BYTES, stream>>>(p);
  return cudaGetLastError();
}

// CTAs of the walk one SM holds at once; out[0] its registers a thread, out[1] its local
// (spilled) bytes a thread. -1 if a query fails.
template <typename T, typename TU, int L, int HD>
int occupancy(int* out) {
  using WS = WalkSmem<L, HD>;
  auto walk = &wkv_bwd_walk_kernel<T, TU, L, HD>;
  cudaFuncAttributes attr;
  int n = 0;
  if (cudaFuncGetAttributes(&attr, walk) != cudaSuccess ||
      cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize, WS::BYTES) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, walk, kThreads, WS::BYTES) != cudaSuccess)
    return -1;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return n;
}

// r/k/v type x u type: (f32, f32), (bf16, bf16) and (bf16, f32), as the forward.
template <int L, int HD>
cudaError_t run_types(int bf16_in, int u_f32, const WalkArgs& p, int B, cudaStream_t s) {
  if (!bf16_in) return u_f32 ? run<float, float, L, HD>(p, B, s) : cudaErrorInvalidValue;
  return u_f32 ? run<bf16, float, L, HD>(p, B, s) : run<bf16, bf16, L, HD>(p, B, s);
}

template <int L, int HD>
int occupancy_types(int bf16_in, int u_f32, int* out) {
  if (!bf16_in) return u_f32 ? occupancy<float, float, L, HD>(out) : -1;
  return u_f32 ? occupancy<bf16, float, L, HD>(out) : occupancy<bf16, bf16, L, HD>(out);
}

template <int L, int HD>
constexpr int smem_bytes() {
  return WalkSmem<L, HD>::BYTES > BwdStateSmem<L, HD>::BYTES ? WalkSmem<L, HD>::BYTES : BwdStateSmem<L, HD>::BYTES;
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

// CTAs of the walk at (chunk, hd, types) one SM of the current device holds; out[0] registers a
// thread, out[1] spilled bytes a thread. -1 on a failed query or an uncompiled config.
int repro_wkv_bwd_occupancy(int chunk, int hd, int bf16_in, int u_f32, int* out) {
#define Y(L, HD) \
  if (chunk == L && hd == HD) return occupancy_types<L, HD>(bf16_in, u_f32, out);
#define X(L) REPRO_WKV_HEAD_DIMS(Y, L)
  REPRO_WKV_CHUNKS(X)
#undef X
#undef Y
  return -1;
}

// r/k/v/logw/dout and dr/dk/dv/dlogw: (B, S, H, hd) contiguous, r/k/v/logw/dout 16-byte aligned;
// u: (H, hd); ds_out (may be null = zeros) and s_fin: (B, H, hd, hd) f32; hs (the forward's chunk
// start states, 16-byte aligned): (B, H, ceil(S / chunk), hd, hd) f32; dsw (the segments' ends,
// null with one segment): (B, H, n_seg - 1, hd, hd) f32; ws (the blocks' start states, null unless
// chunk > 32): (B, H, n_seg, chunk / 16 - 2, hd, hd) f32; du_part: (B, H, n_seg, hd) f32; dstate
// (may be null: not written): (B, H, hd, hd) f32. seg_len: chunks a segment, n_seg =
// ceil(ceil(S / chunk) / seg_len). bf16_in: r/k/v (and dr/dk/dv) are bf16 (else f32); u_f32: u is
// f32 (else bf16).
int repro_wkv_bwd(int chunk, int hd, int bf16_in, int u_f32, const void* r, const void* k, const void* v,
                  const void* logw, const void* u, const void* dout, const void* ds_out, const void* hs,
                  const void* s_fin, void* dsw, void* ws, void* dr, void* dk, void* dv, void* dlogw, void* du_part,
                  void* dstate, int B, int S, int H, int seg_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = chunk > 0 ? (S + chunk - 1) / chunk : 0;
  WalkArgs p{r, k, v, u,
             static_cast<const float*>(logw), static_cast<const float*>(dout), static_cast<const float*>(ds_out),
             static_cast<const float*>(hs), static_cast<const float*>(s_fin), static_cast<const float*>(dsw),
             static_cast<float*>(ws), dr, dk, dv,
             static_cast<float*>(dlogw), static_cast<float*>(du_part), static_cast<float*>(dstate),
             S, H, seg_len, seg_len > 0 ? (n_chunks + seg_len - 1) / seg_len : 0};
#define Y(L, HD) \
  if (chunk == L && hd == HD) return (int)run_types<L, HD>(bf16_in, u_f32, p, B, s);
#define X(L) REPRO_WKV_HEAD_DIMS(Y, L)
  REPRO_WKV_CHUNKS(X)
#undef X
#undef Y
  return (int)cudaErrorInvalidValue;
}

const char* repro_wkv_bwd_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
