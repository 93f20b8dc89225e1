// Chunked RWKV6 WKV recurrence for Hopper (sm_90a), as a chunk-parallel pair of kernels.
//
// Replaces: src/repro/kernels/wkv.py:114 wkv_pallas (body _wkv_kernel), the TPU kernel behind
// ops.wkv, which RWKV6LM.prefill runs once per layer. It computes the same function as the
// reference's models/rwkv.py::wkv_chunked: for every position t of one head,
//   o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(e^{logw_t}) S_{t-1} + k_t^T v_t,
// with S_{-1} the given (hd, hd) f32 state (keys x values), in f32 throughout, and returns
// every o_t and the final state. The sequence is cut into chunks of L positions; cum is the
// inclusive prefix sum of logw inside a chunk and S_{c-1} the state at chunk c's start.
//
// Bound on this card: at a batch-1 prefill of rwkv6-7b (64 heads, hd 64, bf16 r/k/v) the
// function moves ~64 x (3*S*64*2 + 2*S*64*4 + 2*64*64*4) bytes (9.45 MB at S = 128: 2.8 us
// at 3.35 TB/s) and does ~5*hd^2 f32 operations per token and head (2.5 us at 67 TFLOP/s
// f32), so it is bytes-bound at the served lengths. The workspace below (written once, read
// once: 2 x 8.4 MB at S = 128, chunk 16, mostly from L2) is the design's own cost.
//
// Why two kernels. Of a chunk's work only S_c = e^{cum_L} (.)_rows S_{c-1} + k^T v, with
// k^_tau = k_tau e^{cum_L - cum_tau}, depends on the chunk before it. The prefix sums, the
// L x L scores with their exponentials, the intra-chunk product A.v and the u-bonus do not,
// and the state-in term r~.S_{c-1} needs only the state at the chunk's start. So:
//   * wkv_state_kernel is the only sequential part. It walks the chunks in order and carries
//     only the state: for each chunk it writes S_{c-1} into the workspace hs (B, H,
//     n_chunks, hd, hd) f32, then applies the update; at the end it writes s_out. Each state
//     element S[key c][value j] needs only key channel c's k^ and decay and value column j,
//     so the grid splits the state into tiles of KR key rows x all hd values (2 CTAs a head
//     at hd 64). A CTA is warp-specialised: 128 producer threads keep the cp.async loads of
//     k, logw (the tile's key columns) and v two chunks ahead in a ring of stages and turn a
//     landed chunk's logw into k^ (a backward scan per key channel, one exponential per
//     (position, key)) and e^{cum_L}; 256 consumer threads hold the tile in registers, 2 x 4
//     elements each, and per chunk run only the update, an L-deep FMA loop reading k^ and v
//     from shared memory. The two sides meet at named barriers, one handshake per chunk,
//     so the chain per chunk is the update alone.
//   * wkv_output_kernel computes every chunk's output at once: grid (B*H, chunk, value
//     block). It loads r, k, logw, its v columns and S_{c-1}'s columns from hs (16-byte
//     loads, all in flight at once), takes the prefix sums (one thread a (channel, segment),
//     segments joined by shuffles), the strictly causal scores A[t][tau] = sum_c r_tc k_tau,c
//     e^{cum_{t-1},c - cum_tau,c} with the u-bonus sum_c r_tc u_c k_tc on the diagonal, and
//     o = A.v + r~.S_{c-1} (r~_t = r_t e^{cum_{t-1}}). The scores are register-tiled: a
//     thread holds a 4 x 4 block of (t, tau) for a strided share of the channels, so each
//     term costs one shared-memory read instead of four, and the shares are summed by
//     halving exchanges. Below the diagonal the decay factors about the key block's last
//     position (two exponentials per channel and row or column instead of one per term).
//     The outputs are tiled 4 values wide with 16-byte shared reads. A value block is the
//     whole head (hd columns) up to chunk 64: every value block would recompute the
//     scores, the kernel's largest cost, so a split multiplies it (measured slower at every
//     served length). At chunk 128 the tiles only fit in shared memory with blocks of 16.
//
// Numerics: every exponential is of a difference <= 0 (logw is clamped to [-5, -1e-3] by the
// model): e^{cum_{t-1} - cum_tau} for tau < t (below the diagonal blocks as e^{cum_{t-1} - R}
// e^{R - cum_tau}, R = cum at the key block's last position, between the two), e^{cum_{t-1}},
// e^{cum_L - cum_tau} and e^{cum_L}, so every chunk length stays finite where the reference
// kernel's midpoint factoring (e^{|logw| L / 2}) overflows f32 at chunk 64-128. The output kernel keeps cum in
// units of log2 and takes 2^x from the SFU alone (ex2.approx, relative error ~2^-22); the
// state pass uses expf. All math is f32 FMA, and there are no atomics, so two calls on the
// same inputs are bitwise equal. No tensor cores: TF32 keeps ~1e-3 relative, above the 1e-4
// limit the kernels are held to, and the products here are small (hd 64, L <= 128).
//
// Ragged tails are masked, not padded: positions past the sequence end load as zero r/k/v
// and logw 0, the reference's padding, exact for any length. r/k/v/logw are read in the
// (B, S, H, hd) layout directly (row stride H*hd) and must be 16-byte aligned.
//
// Plain C interface, loaded with ctypes; the entry point launches both kernels on the given
// stream and returns the first cudaError_t.

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one H100 CTA may use
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// the state pass
// ---------------------------------------------------------------------------
// The state pass's CTA: kThreads consumers own the state (a tile of KR key rows x hd values),
// kProducers producers load the chunks and prepare k^ a chunk ahead of them.
constexpr int kProducers = 128;
__host__ __device__ constexpr int key_rows(int HD) { return HD > 16 ? HD / 2 : HD; }

// Ring of NS stages (4, or 3 where 4 do not fit: f32 at chunk 128), one chunk each: the
// tile's k (L, KR) in T, v (L, hd) in T and logw (L, KR) in f32, as whole 16-byte pieces for
// cp.async. Once a chunk has landed, k^ = k e^{cum_L - cum} replaces its logw (in place, in
// f32), and e^{cum_L} goes to the stage's decays.
template <typename T, int L, int HD>
struct WkvStateSmem {
  static constexpr int KR = key_rows(HD);
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = L * KR * (int)sizeof(T);
  static constexpr int W_OFF = V_OFF + L * HD * (int)sizeof(T);
  static constexpr int STAGE = W_OFF + L * KR * 4;
  static constexpr int NS = 4 * (STAGE + KR * 4) <= kSmemLimit ? 4 : 3;
  static constexpr int DEC_OFF = NS * STAGE;
  static constexpr int BYTES = DEC_OFF + NS * KR * 4;
};

// N neighbouring values from aligned memory (16 bytes for 4 f32, 8 for 2 f32 or 4 bf16), as f32.
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x, x[1] = q.y;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = p[e];
  }
}
template <int N>
__device__ __forceinline__ void load_vals(const bf16* p, float (&x)[N]) {
  if constexpr (N == 4) {  // bf16 -> f32 is exact: the bf16 bits become the top half
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(q.x << 16), x[1] = __uint_as_float(q.x & 0xffff0000u);
    x[2] = __uint_as_float(q.y << 16), x[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = __bfloat162float(p[e]);
  }
}
template <int N>
__device__ __forceinline__ void store_vals(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = x[e];
  }
}

template <typename T, int L, int HD>
__global__ void __launch_bounds__(kThreads + kProducers)
    wkv_state_kernel(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ logw,
                     const float* __restrict__ s0, float* __restrict__ hs, float* __restrict__ s_out, int S,
                     int H) {
  using SM = WkvStateSmem<T, L, HD>;
  constexpr int NS = SM::NS, KR = SM::KR;
  constexpr int R = KR / 16, NV = HD / 16;  // a consumer's rows R rg .. + R - 1, columns NV j .. + NV - 1
  constexpr int D = NS - 2;                 // chunks the loads run ahead of k^
  constexpr int ALL = kThreads + kProducers;
  // Named barriers: FULL + s (k^ of the chunk in stage s is ready), EMPTY + s (the consumers
  // are done with stage s), PROD (the producers' copies have landed).
  constexpr int FULL = 1, EMPTY = FULL + NS, PROD = EMPTY + NS;
  static_assert(PROD < 16, "named barrier ids");
  static_assert(R * NV * kThreads == KR * HD, "the consumers hold the tile, R x NV elements each");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int bh = blockIdx.x;
  const int kr0 = blockIdx.y * KR;
  const int tid = threadIdx.x;
  const int n_chunks = (S + L - 1) / L;
  auto stage = [&](int ch) { return smem_raw + (ch % NS) * SM::STAGE; };
  auto decays = [&](int ch) { return reinterpret_cast<float*>(smem_raw + SM::DEC_OFF) + (ch % NS) * KR; };

  if (tid >= kThreads) {
    // Producers: the loads run D chunks ahead of k^, which runs one chunk ahead of the update.
    constexpr int E = 16 / sizeof(T);  // elements of a 16-byte piece of k or v
    constexpr int GK = KR / E, GV = HD / E, GW = KR / 4, G = GK + GV + GW;
    constexpr int SEG = kProducers / KR < L ? kProducers / KR : L;  // k^: threads a channel
    constexpr int NPS = L / SEG;                                     // positions a thread
    static_assert(KR * SEG == kProducers, "the k^ scan uses every producer");
    const int pt = tid - kThreads;
    const size_t row = (size_t)H * HD;
    const size_t base = (size_t)(bh / H) * S * row + (size_t)(bh % H) * HD;
    auto load = [&](int ch) {
      if (ch < n_chunks) {
        if (ch >= NS) bar_sync(EMPTY + ch % NS, ALL);  // the consumers are done with chunk ch - NS
        unsigned char* st = stage(ch);
        for (int i = pt; i < L * G; i += kProducers) {
          const int t = i / G, q = i % G;
          const int p = ch * L + t;
          const bool in = p < S;
          const size_t g = base + (size_t)(in ? p : 0) * row;
          if (q < GK) {
            cp_async16(st + SM::K_OFF + (t * KR + q * E) * sizeof(T), k + g + kr0 + q * E, in);
          } else if (q < GK + GV) {
            cp_async16(st + SM::V_OFF + (t * HD + (q - GK) * E) * sizeof(T), v + g + (q - GK) * E, in);
          } else {
            cp_async16(st + SM::W_OFF + (t * KR + (q - GK - GV) * 4) * 4, logw + g + kr0 + (q - GK - GV) * 4,
                       in);
          }
        }
      }
      cp_async_commit();  // one group per chunk, empty past the end, so the wait count holds
    };
#pragma unroll
    for (int i = 0; i < D; ++i) load(i);
    const int c = pt / SEG, sg = pt % SEG;
    for (int ch = 0; ch < n_chunks; ++ch) {
      load(ch + D);
      cp_async_wait<D>();
      bar_sync(PROD, kProducers);  // chunk ch has landed for every producer
      // k^_tau,c = k_tau,c e^{sum of logw_c after tau}, over logw: a thread walks its segment
      // of positions backwards, the segments after it summed by a shuffle scan over the
      // channel's SEG neighbouring lanes.
      unsigned char* st = stage(ch);
      const T* sk = reinterpret_cast<const T*>(st + SM::K_OFF);
      float* sw = reinterpret_cast<float*>(st + SM::W_OFF);
      float x[NPS];
#pragma unroll
      for (int i = 0; i < NPS; ++i) x[i] = sw[(sg * NPS + i) * KR + c];
      float tot = 0.f;
#pragma unroll
      for (int i = 0; i < NPS; ++i) tot += x[i];
      float incl = tot;  // this segment and the later ones
#pragma unroll
      for (int off = 1; off < SEG; off <<= 1) {
        const float n = __shfl_down_sync(kFull, incl, off, SEG);
        if (sg + off < SEG) incl += n;
      }
      const float all = __shfl_sync(kFull, incl, 0, SEG);
      const float next = __shfl_down_sync(kFull, incl, 1, SEG);
      float after = sg + 1 < SEG ? next : 0.f;  // the later segments only
#pragma unroll
      for (int i = NPS - 1; i >= 0; --i) {
        const int t = sg * NPS + i;
        sw[t * KR + c] = to_f32(sk[t * KR + c]) * expf(after);
        after += x[i];
      }
      if (sg == 0) decays(ch)[c] = expf(all);
      bar_arrive(FULL + ch % NS, ALL);
    }
    cp_async_wait<0>();
    return;
  }

  // Consumers: the state tile in registers, R x NV elements a thread.
  const int j = tid % 16, rg = tid / 16;
  const size_t elem = (size_t)(kr0 + R * rg) * HD + NV * j;  // this thread's first element of a state
  float s[R][NV];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    if (s0) {
      load_vals(s0 + (size_t)bh * HD * HD + elem + a * HD, s[a]);
    } else {
#pragma unroll
      for (int e = 0; e < NV; ++e) s[a][e] = 0.f;
    }
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    float* hs_c = hs + ((size_t)bh * n_chunks + ch) * HD * HD + elem;
#pragma unroll
    for (int a = 0; a < R; ++a) store_vals(hs_c + a * HD, s[a]);
    bar_sync(FULL + ch % NS, ALL);  // chunk ch's k^, v and decays are ready
    const unsigned char* st = stage(ch);
    const float* kh = reinterpret_cast<const float*>(st + SM::W_OFF) + R * rg;
    const T* sv = reinterpret_cast<const T*>(st + SM::V_OFF) + NV * j;
    float acc[R][NV];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[a][e] = 0.f;
#pragma unroll 8
    for (int t = 0; t < L; ++t) {
      float kk[R], vv[NV];
      load_vals(kh + t * KR, kk);
      load_vals(sv + t * HD, vv);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int e = 0; e < NV; ++e) acc[a][e] += kk[a] * vv[e];
    }
    float dec[R];
    load_vals(decays(ch) + R * rg, dec);
    if (ch + NS < n_chunks) bar_arrive(EMPTY + ch % NS, ALL);  // the producers may refill the stage
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int e = 0; e < NV; ++e) s[a][e] = dec[a] * s[a][e] + acc[a][e];
  }
#pragma unroll
  for (int a = 0; a < R; ++a) store_vals(s_out + (size_t)bh * HD * HD + elem + a * HD, s[a]);
}

// ---------------------------------------------------------------------------
// the output kernel
// ---------------------------------------------------------------------------
// Columns of a value block: the whole head up to chunk 64, 16 at chunk 128 (shared memory).
__host__ __device__ constexpr int value_block(int L, int HD) { return L >= 128 ? 16 : HD; }
// Lanes that share one 4 x 4 block of scores (strided channel shares), so that the lower
// triangle's blocks fill about one pass of the CTA.
__host__ __device__ constexpr int score_lanes_at(int L) { return L <= 8 ? 32 : L == 16 ? 16 : L == 32 ? 8 : L == 64 ? 2 : 1; }
__host__ __device__ constexpr int score_lanes(int L, int HD) { return score_lanes_at(L) < HD ? score_lanes_at(L) : HD; }

// Shared memory of one output CTA, f32. (L, HD) tiles with a row stride of HD + 4 floats,
// so rows start 16-byte aligned for float4 reads.
template <int L, int HD>
struct WkvOutSmem {
  static constexpr int VB = value_block(L, HD);
  static constexpr int P = HD + 4;   // row stride of the (L, HD) tiles
  static constexpr int TILE = L * P;
  static constexpr int SA = L + 4;   // row stride of the scores
  static constexpr int FLOATS = 4 * TILE + L * SA + L * VB + HD * VB + HD;
  static constexpr int BYTES = FLOATS * 4;
};

// 16-byte pieces of a (ROWS, COLS) slab of T at src (row stride `stride` elements): fetch
// all of a thread's pieces into registers first, then convert and store them as f32.
template <typename T, int ROWS, int COLS>
struct Slab {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int PR = COLS / E;  // pieces per row
  static constexpr int NP = ROWS * PR;
  static constexpr int IT = (NP + kThreads - 1) / kThreads;
  uint4 buf[IT];

  __device__ __forceinline__ void fetch(const T* src, size_t stride, int rows_valid, int tid) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int p = tid + it * kThreads, t = p / PR, q = p % PR;
      buf[it] = make_uint4(0, 0, 0, 0);
      if ((NP % kThreads == 0 || p < NP) && t < rows_valid)
        buf[it] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)t * stride + q * E));
    }
  }
  __device__ __forceinline__ void store(float* dst, int dst_stride, int tid) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int p = tid + it * kThreads, t = p / PR, q = p % PR;
      if (NP % kThreads != 0 && p >= NP) continue;
      float4* d = reinterpret_cast<float4*>(dst + t * dst_stride + q * E);
      const uint4 w = buf[it];
      if constexpr (sizeof(T) == 2) {  // bf16 -> f32 is exact: the bf16 bits become the top half
        d[0] = make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                           __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
        d[1] = make_float4(__uint_as_float(w.z << 16), __uint_as_float(w.z & 0xffff0000u),
                           __uint_as_float(w.w << 16), __uint_as_float(w.w & 0xffff0000u));
      } else {
        d[0] = make_float4(__uint_as_float(w.x), __uint_as_float(w.y), __uint_as_float(w.z), __uint_as_float(w.w));
      }
    }
  }
};

// Sum 16 values over the lanes of an aligned group of 2 O lanes by halving exchanges: at each
// step a lane keeps one half of its N values (the upper one if its bit O is set), adds its
// partner's copy of that half and sends the other. Once one value is left, the remaining
// lanes' copies are summed whole. The kept halves follow the lane's bits, high bit first.
template <int O, int N>
__device__ __forceinline__ void reduce_halves(float (&v)[16], int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      reduce_halves<O / 2, N / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      reduce_halves<O / 2, 1>(v, lane);
    }
  }
}

__device__ __forceinline__ float comp(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

template <typename T, typename TU, int L, int HD>
__global__ void __launch_bounds__(kThreads)
    wkv_output_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ logw, const TU* __restrict__ u, const float* __restrict__ hs,
                      float* __restrict__ o, int S, int H) {
  using SM = WkvOutSmem<L, HD>;
  constexpr int P = SM::P, SA = SM::SA, VB = SM::VB;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;            // r_t
  float* sk = sr + SM::TILE;   // k_t
  float* scu = sk + SM::TILE;  // logw_t, then cum_t log2(e), then r~_t = r_t e^{cum_{t-1}}
  float* scp = scu + SM::TILE; // cum_{t-1} log2(e)
  float* sa = scp + SM::TILE;  // A (L, L): causal scores, u-bonus on the diagonal, 0 above
  float* sv = sa + L * SA;     // v_t, the CTA's value columns (L, VB)
  float* ss = sv + L * VB;     // S_{c-1}, the CTA's value columns (HD, VB)
  float* su = ss + HD * VB;    // u of this head

  const int bh = blockIdx.x, ch = blockIdx.y, vb0 = blockIdx.z * VB;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int c0 = ch * L;
  const int rows = S - c0 < L ? S - c0 : L;  // rows inside the sequence; the rest load as zero
  const size_t row = (size_t)H * HD;
  const size_t base = (size_t)b * S * row + (size_t)h * HD;
  const size_t first = base + (size_t)c0 * row;

  // 1. Loads, every thread's pieces in flight at once.
  {
    Slab<T, L, HD> lr, lk;
    Slab<float, L, HD> lw;
    Slab<T, L, VB> lv;
    Slab<float, HD, VB> ls;
    lr.fetch(r + first, row, rows, tid);
    lk.fetch(k + first, row, rows, tid);
    lw.fetch(logw + first, row, rows, tid);
    lv.fetch(v + first + vb0, row, rows, tid);
    ls.fetch(hs + ((size_t)bh * gridDim.y + ch) * HD * HD + vb0, HD, HD, tid);
    for (int i = tid; i < HD; i += kThreads) su[i] = to_f32(u[(size_t)h * HD + i]);
    lr.store(sr, P, tid);
    lk.store(sk, P, tid);
    lw.store(scu, P, tid);
    lv.store(sv, VB, tid);
    ls.store(ss, VB, tid);
  }
  __syncthreads();

  // 2. cum down each channel: a thread scans one segment of NPS positions in registers, and
  //    the SEG segments of a channel (neighbouring lanes) are joined by a shuffle scan.
  {
    constexpr int SEG = kThreads / HD < L ? kThreads / HD : L;
    constexpr int NPS = L / SEG;
    static_assert((HD * SEG) % 32 == 0, "the scan's lanes fill whole warps");
    if (tid < HD * SEG) {
      const int c = tid / SEG, sg = tid % SEG;
      float x[NPS];
#pragma unroll
      for (int i = 0; i < NPS; ++i) x[i] = scu[(sg * NPS + i) * P + c];
#pragma unroll
      for (int i = 1; i < NPS; ++i) x[i] += x[i - 1];
      float tot = x[NPS - 1];
#pragma unroll
      for (int off = 1; off < SEG; off <<= 1) {
        const float n = __shfl_up_sync(kFull, tot, off, SEG);
        if (sg >= off) tot += n;
      }
      const float prev = __shfl_up_sync(kFull, tot, 1, SEG);
      const float before = sg > 0 ? prev : 0.f;  // sum of the earlier segments
#pragma unroll
      for (int i = 0; i < NPS; ++i) {
        const int t = sg * NPS + i;
        scp[t * P + c] = (i == 0 ? before : x[i - 1] + before) * kLog2e;
        scu[t * P + c] = (x[i] + before) * kLog2e;
      }
    }
  }
  __syncthreads();

  // 3. Scores in 4 x 4 blocks of (t, tau), the lower triangle's NL blocks, CS lanes a block:
  //    A[t][tau] = sum_c r_tc k_tau,c 2^{cum_{t-1},c - cum_tau,c} for tau < t (exponent <= 0),
  //    A[t][t] = sum_c r_tc u_c k_tc, 0 above the diagonal.
  {
    constexpr int TB = 4, NBR = L / TB, NL = NBR * (NBR + 1) / 2;
    constexpr int CS = score_lanes(L, HD), CH = HD / CS;
    constexpr int NW = NL * CS;
    for (int w0 = tid - lane; w0 < NW; w0 += kThreads) {  // warp-uniform
      const int w = w0 + lane;
      const bool valid = w < NW;
      const int blk = valid ? w / CS : 0, g = w % CS;
      int bt = (int)((sqrtf(8.f * blk + 1.f) - 1.f) * 0.5f);
      while (bt * (bt + 1) / 2 > blk) --bt;
      while ((bt + 1) * (bt + 2) / 2 <= blk) ++bt;
      const int bu = blk - bt * (bt + 1) / 2;  // tau's block, <= bt
      float acc[TB * TB];  // (t, tau) = (bt TB + a, bu TB + e) at a TB + e
#pragma unroll
      for (int i = 0; i < TB * TB; ++i) acc[i] = 0.f;
      if (valid) {
        const float* rr = sr + bt * TB * P + g;
        const float* cp = scp + bt * TB * P + g;
        const float* kk = sk + bu * TB * P + g;
        const float* cu = scu + bu * TB * P + g;
        if (bt > bu) {
          // Below the diagonal every tau precedes every t, so the decay factors about R = cum
          // at the key block's last position, both exponents <= 0: 2^{cp_t - R} 2^{R - cu_tau}.
          const float* cr = cu + (TB - 1) * P;
#pragma unroll 2
          for (int i = 0; i < CH; ++i) {
            const int c = CS * i;
            const float ref = cr[c];
            float q[TB], kq[TB];
#pragma unroll
            for (int a = 0; a < TB; ++a) {
              q[a] = rr[a * P + c] * ex2(cp[a * P + c] - ref);
              kq[a] = kk[a * P + c] * ex2(ref - cu[a * P + c]);
            }
#pragma unroll
            for (int a = 0; a < TB; ++a)
#pragma unroll
              for (int e = 0; e < TB; ++e) acc[a * TB + e] += q[a] * kq[e];
          }
        } else {
#pragma unroll 2
          for (int i = 0; i < CH; ++i) {
            const int c = CS * i;
            const float uc = su[g + c];
            float ra[TB], ca[TB], ke[TB], ce[TB];
#pragma unroll
            for (int a = 0; a < TB; ++a) {
              ra[a] = rr[a * P + c];
              ca[a] = cp[a * P + c];
              ke[a] = kk[a * P + c];
              ce[a] = cu[a * P + c];
            }
#pragma unroll
            for (int a = 0; a < TB; ++a) {
#pragma unroll
              for (int e = 0; e < a; ++e) acc[a * TB + e] += ra[a] * ke[e] * ex2(ca[a] - ce[e]);
              acc[a * TB + a] += ra[a] * (uc * ke[a]);
            }
          }
        }
      }
      // Sum the CS shares: lane g ends with sums q NH .. q NH + NH - 1 of the block.
      reduce_halves<CS / 2, TB * TB>(acc, lane);
      constexpr int NH = CS >= TB * TB ? 1 : TB * TB / CS;
      const int q = CS > TB * TB ? g >> 1 : g;
      if (valid && (CS <= TB * TB || (g & 1) == 0)) {
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          const int idx = q * NH + i;
          sa[(bt * TB + idx / TB) * SA + bu * TB + idx % TB] = acc[i];
        }
      }
    }
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, tau = i % L;
      if (tau / TB > t / TB) sa[t * SA + tau] = 0.f;
    }
  }
  __syncthreads();

  // 3b. r~_t = r_t 2^{cum_{t-1} log2(e)}, over cum (no longer read).
  for (int i = tid; i < L * HD / 4; i += kThreads) {
    const int t = i / (HD / 4), c = (i % (HD / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(sr + t * P + c);
    const float4 y = *reinterpret_cast<const float4*>(scp + t * P + c);
    *reinterpret_cast<float4*>(scu + t * P + c) =
        make_float4(x.x * ex2(y.x), x.y * ex2(y.y), x.z * ex2(y.z), x.w * ex2(y.w));
  }
  __syncthreads();

  // 4. o_t = r~_t . S_{c-1} + sum_{tau <= t} A[t][tau] v_tau: a thread holds 4 neighbouring
  //    value columns of the rows t = rg + RG m, reading 16 bytes at a time.
  {
    constexpr int QV = VB / 4, RG = kThreads / QV;
    constexpr int RT = L >= RG ? L / RG : 1;
    const float* srt = scu;
    const int jq = tid % QV, rg = tid / QV;
    if (rg < L) {
      float acc[RT][4];
#pragma unroll
      for (int m = 0; m < RT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
#pragma unroll 4
      for (int c = 0; c < HD; c += 4) {
        float4 rv[RT];
#pragma unroll
        for (int m = 0; m < RT; ++m) rv[m] = *reinterpret_cast<const float4*>(srt + (rg + RG * m) * P + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 s4 = *reinterpret_cast<const float4*>(ss + (c + i) * VB + jq * 4);
#pragma unroll
          for (int m = 0; m < RT; ++m) {
            const float x = comp(rv[m], i);
            acc[m][0] += x * s4.x;
            acc[m][1] += x * s4.y;
            acc[m][2] += x * s4.z;
            acc[m][3] += x * s4.w;
          }
        }
      }
      const int tau_end = (rg + RG * (RT - 1)) / 4 * 4 + 4;  // past the last row's diagonal
      for (int tau = 0; tau < tau_end; tau += 4) {
        float4 av[RT];
#pragma unroll
        for (int m = 0; m < RT; ++m) av[m] = *reinterpret_cast<const float4*>(sa + (rg + RG * m) * SA + tau);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v4 = *reinterpret_cast<const float4*>(sv + (tau + i) * VB + jq * 4);
#pragma unroll
          for (int m = 0; m < RT; ++m) {
            const float x = comp(av[m], i);
            acc[m][0] += x * v4.x;
            acc[m][1] += x * v4.y;
            acc[m][2] += x * v4.z;
            acc[m][3] += x * v4.w;
          }
        }
      }
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        const int t = rg + RG * m;
        if (t < rows)
          *reinterpret_cast<float4*>(o + first + (size_t)t * row + vb0 + jq * 4) =
              make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      }
    }
  }
}

template <typename T, typename TU, int L, int HD>
cudaError_t run(const void* r, const void* k, const void* v, const void* logw, const void* u,
                const void* s0, void* o, void* s_out, void* hs, int B, int S, int H, cudaStream_t stream) {
  using SS = WkvStateSmem<T, L, HD>;
  using SO = WkvOutSmem<L, HD>;
  typedef void (*StateKernel)(const T*, const T*, const float*, const float*, float*, float*, int, int);
  typedef void (*OutKernel)(const T*, const T*, const T*, const float*, const TU*, const float*, float*, int,
                            int);
  StateKernel state_kernel = &wkv_state_kernel<T, L, HD>;
  OutKernel out_kernel = &wkv_output_kernel<T, TU, L, HD>;
  // Above 48 KB a kernel may use dynamic shared memory only after opting in.
  cudaError_t err =
      cudaFuncSetAttribute(state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SS::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SO::BYTES);
  if (err != cudaSuccess) return err;
  const int n_chunks = (S + L - 1) / L;
  state_kernel<<<dim3(B * H, HD / SS::KR), kThreads + kProducers, SS::BYTES, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(s0), static_cast<float*>(hs), static_cast<float*>(s_out), S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  out_kernel<<<dim3(B * H, n_chunks, HD / SO::VB), kThreads, SO::BYTES, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), static_cast<const TU*>(u), static_cast<const float*>(hs),
      static_cast<float*>(o), S, H);
  return cudaGetLastError();
}

// r/k/v type x u type: (f32, f32), (bf16, bf16) and (bf16, f32).
template <int L, int HD>
cudaError_t run_types(int bf16_in, int u_f32, const void* r, const void* k, const void* v,
                      const void* logw, const void* u, const void* s0, void* o, void* s_out, void* hs,
                      int B, int S, int H, cudaStream_t s) {
  if (!bf16_in) {
    if (!u_f32) return cudaErrorInvalidValue;
    return run<float, float, L, HD>(r, k, v, logw, u, s0, o, s_out, hs, B, S, H, s);
  }
  return u_f32 ? run<bf16, float, L, HD>(r, k, v, logw, u, s0, o, s_out, hs, B, S, H, s)
               : run<bf16, bf16, L, HD>(r, k, v, logw, u, s0, o, s_out, hs, B, S, H, s);
}

// The largest of the two kernels' dynamic shared memory over the r/k/v types.
constexpr int max3(int a, int b, int c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }
template <int L, int HD>
constexpr int smem_bytes() {
  return max3(WkvOutSmem<L, HD>::BYTES, WkvStateSmem<float, L, HD>::BYTES, WkvStateSmem<bf16, L, HD>::BYTES);
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

// r/k/v/logw/o: (B, S, H, hd) contiguous, r/k/v/logw 16-byte aligned; u: (H, hd); s0 (may be
// null = zeros) and s_out: (B, H, hd, hd) f32; hs: (B, H, ceil(S / chunk), hd, hd) f32, the
// workspace. bf16_in: r/k/v are bf16 (else f32); u_f32: u is f32 (else bf16).
int repro_wkv(int chunk, int hd, int bf16_in, int u_f32, const void* r, const void* k,
              const void* v, const void* logw, const void* u, const void* s0, void* o,
              void* s_out, void* hs, int B, int S, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Y(L, HD)                                                                                \
  if (chunk == L && hd == HD)                                                                   \
    return (int)run_types<L, HD>(bf16_in, u_f32, r, k, v, logw, u, s0, o, s_out, hs, B, S, H, s);
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
