// Attention backward (flash attention): dq, dk and dv from q, k, v, the
// forward's output, its row log-sum-exp and the output's gradient, with
// causal and sliding-window masks and grouped-query heads. Plain C
// interface, loaded with ctypes by
// repro_torch/kernels/flash_attention/kernel.py; built for sm_90a.
//
// It replaces no TPU kernel: the reference trains through a custom VJP in
// jnp, _flash_bwd (src/repro/models/lm/attention.py:107-146), which runs
// outside any Pallas kernel. This is its counterpart on the card, added so
// that the LM train step's attention backward is a kernel of its own:
//     p[i, j]  = exp(s[i, j] - lse[i]),  s = q k^T / sqrt(D), or -1e30
//                where masked (kv_pos > q_pos when causal, q_pos - kv_pos
//                >= window unless the layer is global; q_pos = q_offset +
//                i), exactly the forward's scores
//     delta[i] = sum_d dout[i, d] out[i, d]
//     dv[j]    = sum over the G query heads of the KV head, over i,
//                of p[i, j] dout[i]
//     ds[i, j] = p[i, j] (<dout[i], v[j]> - delta[i]) / sqrt(D)
//     dq[i]    = sum_j ds[i, j] k[j];  dk[j] = sum over heads, i, of
//                ds[i, j] q[i]
// q, dout, out (B, Sq, H, D); k, v (B, Skv, KH, D); lse (B, H, Sq)
// float32; all contiguous, float32 or bf16 alike (the outputs in the
// inputs' dtype); float32 scores, probabilities and sums. Any Sq, Skv and
// D <= 256.
//
// What bounds it on an H100: operations. Per (query, key) pair that the
// mask lets through it does five products of length D (s and dp in both
// passes below, then dv and dk, or dq): 7 D multiply-adds, where each
// input byte is reused by a whole tile of rows. This first kernel runs on
// the SIMT float32 units (67 TFLOP/s peak), not the tensor cores.
//
// Three kernels, one C call, no atomics:
//  1. delta_kernel: one warp per (b, i, h) row, delta in float32.
//  2. dkdv_kernel: one block of 256 threads per (KV tile, b, kh). The K
//     and V tiles (BK keys: 64, or 32 at D > 128, so that the float32
//     tiles fit in shared memory) stay in shared memory; the block walks
//     the G query heads of its KV head and, for each, the 64-row Q tiles
//     the mask lets see its keys, in a fixed order. Per Q tile it stages
//     q, dout, lse and delta in shared memory, computes s and dp for the
//     64 x BK pairs (thread (ty, tx) of the 16 x 16 grid: rows ty + 16 i,
//     columns tx + 16 j, as register-blocked dot products), writes p and
//     ds to shared memory and accumulates dv += p^T dout, dk += ds^T q in
//     registers (rows ty + 16 i of the tile, column pairs 2 tx + 32 j).
//  3. dq_kernel: one block per (64-row Q tile, h, b), q and dout resident;
//     it walks the KV tiles the mask lets its rows see, recomputes s, p,
//     dp and ds, and accumulates dq += ds k in registers.
// Tiles that no row of the block can see are skipped (a local layer's
// block sees about window / Skv of them): there every p is exp(-1e30 -
// lse) = 0 exactly. When some query row sees no key at all (only with a
// window <= 0 or query positions past Skv + window - 1; the last row is
// then such a row), the reference's p of that row is exp(-1e30 - lse) with
// lse = -1e30 + log(Skv), nonzero on every key, so nothing is skipped.
//
// Every sum runs in a fixed order and each output element is written by
// one thread of one block, so a relaunch is bit-identical. The C function
// launches on the caller's stream, allocates nothing (delta's buffer comes
// from the wrapper) and returns the first CUDA error of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per tile
constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr float kNegInf = -1e30f;

// Tile shape for a head dim padded up to DP (32, 64, 128 or 256).
template <int DP>
struct Tile {
  static constexpr int kBK = DP > 128 ? 32 : 64;    // keys per KV tile
  static constexpr int kLD = DP + 2;     // Q / dO / K / V row stride
  static constexpr int kPLD = kBK + 16;  // p / ds row stride: rows ty, ty + 1
                                         // 16 banks apart
  static constexpr int kSC = kBK / 16;   // score columns per thread
  static constexpr int kKR = kBK / 16;   // dk / dv rows per thread
  static constexpr int kOP = DP / 32;    // output column pairs per thread
};

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using V = float2;
  __device__ static float2 f2(float2 v) { return v; }
};
template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  __device__ static float2 f2(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
};

template <typename T>
__device__ __forceinline__ float2 ld2(const T* p) {
  return Pair<T>::f2(*reinterpret_cast<const typename Pair<T>::V*>(p));
}

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);                 // round to nearest even
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// Rows [0, NROWS) of a matrix with row stride `stride` (elements), its
// first D columns, into s (NROWS x kLD); rows >= `valid` and columns in
// [D, DP) are zero-filled. `vec`: 16-byte loads (D a multiple of the
// vector width, base 16-byte aligned), stored as pairs.
template <typename T, int DP, int NROWS>
__device__ __forceinline__ void load_tile(T* s, const T* g, int64_t stride,
                                          int valid, int D, bool vec) {
  constexpr int kLD = Tile<DP>::kLD;
  using PV = typename Pair<T>::V;
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kChunks = DP / kVec;       // per row
    for (int c = threadIdx.x; c < NROWS * kChunks; c += kThreads) {
      const int r = c / kChunks, d = (c % kChunks) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && d < D)
        val = __ldg(reinterpret_cast<const uint4*>(g + r * stride + d));
      const PV* src = reinterpret_cast<const PV*>(&val);
      PV* dst = reinterpret_cast<PV*>(s + r * kLD + d);
#pragma unroll
      for (int i = 0; i < kVec / 2; ++i) dst[i] = src[i];
    }
  } else {
    for (int c = threadIdx.x; c < NROWS * DP; c += kThreads) {
      const int r = c / DP, d = c % DP;
      s[r * kLD + d] = (r < valid && d < D) ? g[r * stride + d] : zero<T>();
    }
  }
}

// Shared problem description.
struct Prob {
  int Sq, Skv, H, KH, D, causal, is_global, keep_all;
  int64_t window, q_offset;
  float scale;
};

// s = q k^T and dp = dout v^T for rows ty + 16 i of the Q tile and columns
// tx + 16 j of the KV tile; then p and ds into shared memory (row stride
// PLD). Rows past `q_rows` and keys past Skv get p = ds = 0.
template <typename T, int DP>
__device__ __forceinline__ void scores(const T* sQ, const T* sO, const T* sK,
                                       const T* sV, const float* sLse,
                                       const float* sDelta, float* sP,
                                       float* sDS, const Prob& P, int q0,
                                       int q_rows, int k0) {
  using C = Tile<DP>;
  constexpr int LD = C::kLD, PLD = C::kPLD, SC = C::kSC;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][SC], dp[4][SC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 2) {
    float2 qv[4], ov[4], kv[SC], vv[SC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = ld2(sQ + (ty + 16 * i) * LD + d);
      ov[i] = ld2(sO + (ty + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      kv[j] = ld2(sK + (tx + 16 * j) * LD + d);
      vv[j] = ld2(sV + (tx + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        dp[i][j] = fmaf(ov[i].x, vv[j].x, dp[i][j]);
        dp[i][j] = fmaf(ov[i].y, vv[j].y, dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int64_t qp = P.q_offset + q0 + r;
    const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int c = k0 + tx + 16 * j;
      bool ok = true;
      if (P.causal) ok = c <= qp;
      if (!P.is_global) ok = ok && (qp - c < P.window);
      const float sv = ok ? s[i][j] * P.scale : kNegInf;
      const float p = (c < P.Skv && r < q_rows) ? expf(sv - lse) : 0.f;
      const float ds = p * (dp[i][j] - delta) * P.scale;
      if (sP != nullptr) sP[r * PLD + tx + 16 * j] = p;
      sDS[r * PLD + tx + 16 * j] = ds;
    }
  }
}

template <typename T, int DP>
constexpr size_t dkdv_smem() {
  using C = Tile<DP>;
  return sizeof(float) * (2 * kBQ * C::kPLD + 2 * kBQ) +
         sizeof(T) * (2 * kBQ + 2 * C::kBK) * C::kLD;
}

template <typename T, int DP>
constexpr size_t dq_smem() {
  using C = Tile<DP>;
  return sizeof(float) * (kBQ * C::kPLD + 2 * kBQ) +
         sizeof(T) * (2 * kBQ + 2 * C::kBK) * C::kLD;
}

// delta[b, h, i] = sum_d dout[b, i, h, d] out[b, i, h, d]: one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int64_t rows, int Sq, int H,
                 int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* og = o + row * D;
  const T* dg = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(f32(dg[d]), f32(og[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // row = (b Sq + i) H + h
    const int64_t h = row % H, bi = row / H;
    const int64_t i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = acc;
  }
}

// stage one Q tile of head h: q, dout, lse, delta
template <typename T, int DP>
__device__ __forceinline__ void load_q_tile(T* sQ, T* sO, float* sLse,
                                            float* sDelta, const T* q,
                                            const T* dout, const float* lse,
                                            const float* delta, const Prob& P,
                                            int b, int h, int q0, int q_rows,
                                            bool vec) {
  const int64_t q_stride = static_cast<int64_t>(P.H) * P.D;
  const int64_t off = (static_cast<int64_t>(b) * P.Sq + q0) * q_stride +
                      static_cast<int64_t>(h) * P.D;
  load_tile<T, DP, kBQ>(sQ, q + off, q_stride, q_rows, P.D, vec);
  load_tile<T, DP, kBQ>(sO, dout + off, q_stride, q_rows, P.D, vec);
  const int64_t row0 = (static_cast<int64_t>(b) * P.H + h) * P.Sq + q0;
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    sLse[r] = r < q_rows ? lse[row0 + r] : 0.f;
    sDelta[r] = r < q_rows ? delta[row0 + r] : 0.f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, Prob P, int vec) {
  using C = Tile<DP>;
  constexpr int BK = C::kBK, LD = C::kLD, PLD = C::kPLD, KR = C::kKR,
                OP = C::kOP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sP = reinterpret_cast<float*>(smem);            // (kBQ, PLD)
  float* sDS = sP + kBQ * PLD;                           // (kBQ, PLD)
  float* sLse = sDS + kBQ * PLD;                         // (kBQ)
  float* sDelta = sLse + kBQ;                            // (kBQ)
  T* sQ = reinterpret_cast<T*>(sDelta + kBQ);            // (kBQ, LD)
  T* sO = sQ + kBQ * LD;                                 // (kBQ, LD)
  T* sK = sO + kBQ * LD;                                 // (BK, LD)
  T* sV = sK + BK * LD;                                  // (BK, LD)

  const int t = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = P.H / P.KH;
  const int k0 = t * BK;
  const int k_rows = min(BK, P.Skv - k0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t kv_stride = static_cast<int64_t>(P.KH) * P.D;
  const int64_t kv_off = (static_cast<int64_t>(b) * P.Skv + k0) * kv_stride +
                         static_cast<int64_t>(kh) * P.D;
  load_tile<T, DP, BK>(sK, k + kv_off, kv_stride, k_rows, P.D, vec);
  load_tile<T, DP, BK>(sV, v + kv_off, kv_stride, k_rows, P.D, vec);

  // the query rows that may see a key of this tile: positions from the
  // tile's first key (causal) to its last key + window - 1 (local)
  int64_t i_lo = 0, i_hi = P.Sq - 1;
  if (!P.keep_all) {
    const int64_t k1 = k0 + k_rows - 1;
    if (P.causal) i_lo = max64(i_lo, k0 - P.q_offset);
    if (!P.is_global) i_hi = min64(i_hi, k1 + P.window - 1 - P.q_offset);
  }

  float acc_k[KR][OP][2], acc_v[KR][OP][2];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < OP; ++j)
      acc_k[i][j][0] = acc_k[i][j][1] = acc_v[i][j][0] = acc_v[i][j][1] = 0.f;

  if (i_lo <= i_hi) {
    const int qt_lo = static_cast<int>(i_lo / kBQ);
    const int qt_hi = static_cast<int>(i_hi / kBQ);
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      for (int qt = qt_lo; qt <= qt_hi; ++qt) {
        const int q0 = qt * kBQ, q_rows = min(kBQ, P.Sq - q0);
        __syncthreads();                  // the last tile's reads are done
        load_q_tile<T, DP>(sQ, sO, sLse, sDelta, q, dout, lse, delta, P, b,
                           h, q0, q_rows, vec);
        __syncthreads();
        scores<T, DP>(sQ, sO, sK, sV, sLse, sDelta, sP, sDS, P, q0, q_rows,
                      k0);
        __syncthreads();
        // dv += p^T dout, dk += ds^T q: key rows ty + 16 i, column pairs
        // 2 tx + 32 j, summed over the tile's query rows in order
        for (int c = 0; c < q_rows; ++c) {
          float pr[KR], dr[KR];
#pragma unroll
          for (int i = 0; i < KR; ++i) {
            pr[i] = sP[c * PLD + ty + 16 * i];
            dr[i] = sDS[c * PLD + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < OP; ++j) {
            const float2 ov = ld2(sO + c * LD + 2 * tx + 32 * j);
            const float2 qv = ld2(sQ + c * LD + 2 * tx + 32 * j);
#pragma unroll
            for (int i = 0; i < KR; ++i) {
              acc_v[i][j][0] = fmaf(pr[i], ov.x, acc_v[i][j][0]);
              acc_v[i][j][1] = fmaf(pr[i], ov.y, acc_v[i][j][1]);
              acc_k[i][j][0] = fmaf(dr[i], qv.x, acc_k[i][j][0]);
              acc_k[i][j][1] = fmaf(dr[i], qv.y, acc_k[i][j][1]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int r = ty + 16 * i;
    if (r >= k_rows) continue;
    const int64_t off = (static_cast<int64_t>(b) * P.Skv + k0 + r) *
                            kv_stride + static_cast<int64_t>(kh) * P.D;
#pragma unroll
    for (int j = 0; j < OP; ++j) {
      const int d = 2 * tx + 32 * j;
      if (d < P.D) {
        st(dk + off + d, acc_k[i][j][0]);
        st(dv + off + d, acc_v[i][j][0]);
      }
      if (d + 1 < P.D) {
        st(dk + off + d + 1, acc_k[i][j][1]);
        st(dv + off + d + 1, acc_v[i][j][1]);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Prob P, int vec) {
  using C = Tile<DP>;
  constexpr int BK = C::kBK, LD = C::kLD, PLD = C::kPLD, OP = C::kOP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sDS = reinterpret_cast<float*>(smem);           // (kBQ, PLD)
  float* sLse = sDS + kBQ * PLD;                         // (kBQ)
  float* sDelta = sLse + kBQ;                            // (kBQ)
  T* sQ = reinterpret_cast<T*>(sDelta + kBQ);            // (kBQ, LD)
  T* sO = sQ + kBQ * LD;                                 // (kBQ, LD)
  T* sK = sO + kBQ * LD;                                 // (BK, LD)
  T* sV = sK + BK * LD;                                  // (BK, LD)

  const int qb = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (P.H / P.KH);
  const int q0 = qb * kBQ;
  const int q_rows = min(kBQ, P.Sq - q0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t kv_stride = static_cast<int64_t>(P.KH) * P.D;
  const T* kg = k + static_cast<int64_t>(b) * P.Skv * kv_stride +
                static_cast<int64_t>(kh) * P.D;
  const T* vg = v + static_cast<int64_t>(b) * P.Skv * kv_stride +
                static_cast<int64_t>(kh) * P.D;

  // the KV tiles some row of this block may see: keys [lo, hi], from the
  // first row's window start to the last row's causal end
  const int n_tiles = (P.Skv + BK - 1) / BK;
  int t_lo = 0, t_hi = n_tiles;
  if (!P.keep_all) {
    const int64_t p_first = P.q_offset + q0, p_last = p_first + q_rows - 1;
    const int64_t hi = P.causal ? min64(P.Skv - 1, p_last) : P.Skv - 1;
    const int64_t lo = P.is_global ? 0 : max64(0, p_first - P.window + 1);
    t_lo = static_cast<int>(lo / BK);
    t_hi = lo <= hi ? static_cast<int>(hi / BK) + 1 : t_lo;
  }

  load_q_tile<T, DP>(sQ, sO, sLse, sDelta, q, dout, lse, delta, P, b, h, q0,
                     q_rows, vec);

  float acc[4][OP][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OP; ++j) acc[i][j][0] = acc[i][j][1] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // the last tile's reads are done
    load_tile<T, DP, BK>(sK, kg + k0 * kv_stride, kv_stride, P.Skv - k0,
                         P.D, vec);
    load_tile<T, DP, BK>(sV, vg + k0 * kv_stride, kv_stride, P.Skv - k0,
                         P.D, vec);
    __syncthreads();
    scores<T, DP>(sQ, sO, sK, sV, sLse, sDelta, nullptr, sDS, P, q0, q_rows,
                  k0);
    __syncthreads();
    // dq += ds k: rows ty + 16 i, column pairs 2 tx + 32 j, keys in order
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = sDS[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < OP; ++j) {
        const float2 kv = ld2(sK + c * LD + 2 * tx + 32 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(dr[i], kv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(dr[i], kv.y, acc[i][j][1]);
        }
      }
    }
  }

  const int64_t q_stride = static_cast<int64_t>(P.H) * P.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    T* g = dq + (static_cast<int64_t>(b) * P.Sq + q0 + r) * q_stride +
           static_cast<int64_t>(h) * P.D;
#pragma unroll
    for (int j = 0; j < OP; ++j) {
      const int d = 2 * tx + 32 * j;
      if (d < P.D) st(g + d, acc[i][j][0]);
      if (d + 1 < P.D) st(g + d + 1, acc[i][j][1]);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, const Prob& P, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* dout_ = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * P.Sq * P.H;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), dout_, delta, rows, P.Sq, P.H, P.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(dout);
  const int vec = addr % 16 == 0 && P.D % (16 / sizeof(T)) == 0;
  constexpr int BK = Tile<DP>::kBK;

  auto kv_kern = dkdv_kernel<T, DP>;
  constexpr size_t kv_smem = dkdv_smem<T, DP>();
  err = cudaFuncSetAttribute(kv_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid((P.Skv + BK - 1) / BK, P.KH, B);
  kv_kern<<<kv_grid, kThreads, kv_smem, stream>>>(
      q_, k_, v_, dout_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      P, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto q_kern = dq_kernel<T, DP>;
  constexpr size_t q_smem = dq_smem<T, DP>();
  err = cudaFuncSetAttribute(q_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((P.Sq + kBQ - 1) / kBQ, P.H, B);
  q_kern<<<q_grid, kThreads, q_smem, stream>>>(
      q_, k_, v_, dout_, lse, delta, static_cast<T*>(dq), P, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, const Prob& P, cudaStream_t stream) {
  if (P.D <= 32)
    return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, P,
                         stream);
  if (P.D <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, P,
                         stream);
  if (P.D <= 128)
    return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, P,
                          stream);
  return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, P,
                        stream);
}

}  // namespace

// delta: a (B, H, Sq) float32 scratch buffer; dq (like q), dk and dv (like
// k) are written whole.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KH,
    int64_t D, int64_t causal, int64_t window, int64_t is_global,
    int64_t q_offset, float scale, int64_t bf16, cudaStream_t stream) {
  if (B == 0 || Sq == 0 || Skv == 0 || H == 0 || D == 0) return 0;
  if (D > 256 || KH < 1 || H % KH != 0 || q_offset < 0 || B > 65535 ||
      H > 65535 || Sq > (1LL << 30) || Skv > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Prob P;
  P.Sq = static_cast<int>(Sq);
  P.Skv = static_cast<int>(Skv);
  P.H = static_cast<int>(H);
  P.KH = static_cast<int>(KH);
  P.D = static_cast<int>(D);
  P.causal = causal != 0;
  P.is_global = is_global != 0;
  P.window = window;
  P.q_offset = q_offset;
  P.scale = scale;
  // does the last query row see a key? If not, some row sees none, and no
  // tile may be skipped (see the note at the top)
  const int64_t p_last = q_offset + Sq - 1;
  const int64_t hi = P.causal ? (Skv - 1 < p_last ? Skv - 1 : p_last)
                              : Skv - 1;
  const int64_t lo = P.is_global ? 0
                     : (p_last - window + 1 > 0 ? p_last - window + 1 : 0);
  P.keep_all = lo > hi;
  const int b = static_cast<int>(B);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   b, P, stream);
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, P,
                         stream);
}
