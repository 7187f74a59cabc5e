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
// inputs' dtype); float32 scores, probabilities and sums. Any Sq and Skv.
//
// What bounds it on an H100: operations. Per (query, key) pair that the
// mask lets through it does five products of length D (s, dp, dv, dk,
// dq; the split below recomputes s and dp for dq, seven in all), where
// each input byte is reused by a whole tile of rows. Two routes, two
// entry points; the wrapper picks one from the dtype, D and alignment, as
// the forward does:
//
//  - flash_attention_bwd_tc: bf16 at D 64, 128 or 256, every pointer
//    16-byte aligned. Tensor cores: wgmma fed by TMA (below).
//  - flash_attention_bwd: float32 (exact float32 sums of float32
//    products), and bf16 at any other D <= 256 or alignment. SIMT fmaf on
//    the float32 units (67 TFLOP/s peak).
//
// Both run three kernels from one C call, with no atomics: a delta pass
// (delta_kernel, one warp per (b, i, h) row, float32), then a dk / dv
// kernel over KV tiles and a dq kernel over Q tiles. Every sum runs in a
// fixed order and each output element is written by one thread of one
// block, so a relaunch is bit-identical. Each C function launches on the
// caller's stream, allocates nothing (delta's buffer comes from the
// wrapper) and returns the first CUDA error of its launches.
//
// The SIMT kernels:
//  - dkdv_kernel: one block of 256 threads per (KV tile, b, kh). The K
//    and V tiles (BK keys: 64, or 32 at D > 128, so that the float32
//    tiles fit in shared memory) stay in shared memory; the block walks
//    the G query heads of its KV head and, for each, the 64-row Q tiles
//    the mask lets see its keys, in a fixed order. Per Q tile it stages
//    q, dout, lse and delta in shared memory, computes s and dp for the
//    64 x BK pairs (thread (ty, tx) of the 16 x 16 grid: rows ty + 16 i,
//    columns tx + 16 j, as register-blocked dot products), writes p and
//    ds to shared memory and accumulates dv += p^T dout, dk += ds^T q in
//    registers (rows ty + 16 i of the tile, column pairs 2 tx + 32 j).
//  - dq_kernel: one block per (64-row Q tile, h, b), q and dout resident;
//    it walks the KV tiles the mask lets its rows see, recomputes s, p,
//    dp and ds, and accumulates dq += ds k in registers.
//
// The tensor-core kernels (namespace tc; the TMA, mbarrier and wgmma
// helpers are hopper.cuh's, shared with the forward). Both have 384 threads:
// warpgroup 0 is the producer (setmaxnreg 24; one thread issues every TMA
// load into mbarrier-guarded buffers in the 128-byte swizzle that wgmma
// reads, rows past Sq or Skv zero-filled), warpgroups 1 and 2 compute
// (setmaxnreg 240). The shared memory allows one block an SM; blocks are
// numbered heaviest first, so the hardware's in-order dispatch to the
// first free SM is a longest-first list schedule.
//  - dkdv_tc_kernel: one block per (64-key tile, b, kh). K and V stay
//    resident; the producer streams the 64-row Q and dO tiles of the G
//    heads through a 2-stage ring. The block computes the transposed
//    products, so that P^T and dS^T come out of wgmma in the accumulator
//    layout, which is the A-operand layout of the next product: warpgroup
//    1 forms S^T = K Q^T, P^T = exp(S^T / sqrt(D) - lse) and accumulates
//    dV += P^T dO; warpgroup 2 forms dP^T = V dO^T, dS^T = P^T (dP^T -
//    delta) / sqrt(D) and accumulates dK += dS^T Q. At D 256 each
//    accumulator is 128 float32 a thread, so the two (64 x 256) sums sit
//    in two warpgroups. P^T passes from warpgroup 1 to 2 in float32
//    through shared memory (16 KB, each thread's 32 values in its own
//    column, so no bank conflicts), under two named barriers (full /
//    empty), so warpgroup 1 runs up to one Q tile ahead. Shared memory at
//    D 256: K + V 64 KB, two stages of Q + dO 128 KB, P 16 KB.
//  - dq_tc_kernel: one block per 128 query rows of one (b, h), longest
//    causal rows first; each consumer warpgroup owns 64 rows. Q and dO
//    stay resident; K and V tiles (BK keys: 64, or 32 at D 256, where
//    the dQ accumulator takes 128 registers a thread) stream through a
//    2-stage ring with their own full and empty mbarriers. Per tile:
//    S = Q K^T and dP = dO V^T (wgmma, both operands in shared memory),
//    V released; dS = P (dP - delta) / sqrt(D) in registers, rounded to
//    bf16 and fed from registers to dQ += dS K (K read through the
//    transpose flag), then K released.
// Numerics of the tensor-core route: Q K^T, dO V^T are exact bf16
// products summed in float32; P and dS are float32 from those unrounded
// sums and are rounded to bf16 only as operands of the dV, dK and dQ
// products (summed in float32), as the TPU's MXU rounds the reference's
// float32 einsums at DEFAULT precision; the outputs round to bf16.
// `ref.flash_attention_bwd_ref(..., pds_bf16=True)` emulates it.
//
// Masks (both routes). Tiles that no row can see are skipped (a local
// layer's block sees about window / Skv of them): there every p is
// exp(-1e30 - lse) = 0 exactly. When some query row sees no key at all
// (only with a window <= 0 or query positions past Skv + window - 1; the
// last row is then such a row), the reference's p of that row is
// exp(-1e30 - lse) with lse = -1e30 + log(Skv), nonzero on every key, so
// nothing is skipped. Only tiles that cross the causal diagonal, the
// window's edge, Sq or Skv are masked element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// the delta pass, both routes
template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B,
                 const Prob& P, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * P.Sq * P.H;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows,
      P.Sq, P.H, P.D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, const Prob& P, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* dout_ = static_cast<const T*>(dout);
  const int rc = launch_delta<T>(o, dout, delta, B, P, stream);
  if (rc != 0) return rc;

  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(dout);
  const int vec = addr % 16 == 0 && P.D % (16 / sizeof(T)) == 0;
  constexpr int BK = Tile<DP>::kBK;

  auto kv_kern = dkdv_kernel<T, DP>;
  constexpr size_t kv_smem = dkdv_smem<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
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

// The problem of a call; false where a size is out of range.
bool make_prob(Prob* P, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
               int64_t KH, int64_t D, int64_t causal, int64_t window,
               int64_t is_global, int64_t q_offset, float scale) {
  if (D > 256 || KH < 1 || H % KH != 0 || q_offset < 0 || B > 65535 ||
      H > 65535 || Sq > (1LL << 30) || Skv > (1LL << 30))
    return false;
  P->Sq = static_cast<int>(Sq);
  P->Skv = static_cast<int>(Skv);
  P->H = static_cast<int>(H);
  P->KH = static_cast<int>(KH);
  P->D = static_cast<int>(D);
  P->causal = causal != 0;
  P->is_global = is_global != 0;
  P->window = window;
  P->q_offset = q_offset;
  P->scale = scale;
  // does the last query row see a key? If not, some row sees none, and no
  // tile may be skipped (see the note at the top)
  const int64_t p_last = q_offset + Sq - 1;
  const int64_t hi = P->causal ? (Skv - 1 < p_last ? Skv - 1 : p_last)
                               : Skv - 1;
  const int64_t lo = P->is_global ? 0
                     : (p_last - window + 1 > 0 ? p_last - window + 1 : 0);
  P->keep_all = lo > hi;
  return true;
}

}  // namespace

// ===========================================================================
// The tensor-core kernels: bf16 q, k, v, out, dout with D 64, 128 or 256
// ===========================================================================
namespace {
namespace tc {

constexpr int kThreads = 384;   // warpgroup 0 loads, 1 and 2 compute
constexpr int kStages = 2;      // depth of the streamed ring
constexpr int kConsumerWarps = 8;
constexpr int kTile = 64;       // dk / dv: keys a block, query rows a stage
constexpr int kBM = 128;        // dq: query rows a block (64 a warpgroup)
constexpr int kBarPFull = 1, kBarPEmpty = 2;   // named barriers (dk / dv)

// dk / dv: K, V resident, Q and dO tiles (64 rows each) in kStages
// stages, P^T in float32 (32 values for each of 128 threads)
template <int D>
struct KvCfg {
  static constexpr int kSlab = kTile * 128;          // a 64-row column slab
  static constexpr int kBytes = kTile * D * 2;       // one 64-row tile
  static constexpr size_t kSmem = 1024 + (2 + 2 * kStages) * kBytes +
                                  32 * 128 * 4 + 8 * (1 + 2 * kStages);
};

// dq: Q, dO resident (128 rows each), K and V tiles of BK keys streamed
template <int D>
struct QCfg {
  static constexpr int kBK = D >= 256 ? 32 : 64;
  static constexpr int kQSlab = kBM * 128;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVSlab = kBK * 128;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr size_t kSmem = 1024 + 2 * kQBytes +
                                  2 * kStages * kKVBytes +
                                  8 * (1 + 4 * kStages);
};

using namespace hopper;

// the D / 64 column slabs (`slab` bytes apart) of one tile of a head,
// rows from `row`
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, int slab,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int head, int row,
                                         int b) {
#pragma unroll
  for (int s = 0; s < D / 64; ++s)
    tma_load(dst + s * slab, map, bar, 64 * s, head, row, b);
}

// K-major operand of a product over D: step kk of 16 columns of a tile of
// 64-column slabs `slab` bytes apart
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile,
                                           int slab, int kk) {
  return sw128_desc(smem_u32(tile) + (kk / 4) * slab + (kk % 4) * 32, 16,
                    1024);
}

// transposed (N-major) operand: step kk of 16 rows of a tile whose
// 64-column slabs are `slab` bytes apart
__device__ __forceinline__ uint64_t nmajor(const unsigned char* tile,
                                           int slab, int kk) {
  return sw128_desc(smem_u32(tile) + kk * 16 * 128, slab, 1024);
}

// named barriers between the two consumer warpgroups (256 threads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// this warp is done reading a buffer: one arrival a warp
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// dk and dv of one 64-key tile of one (b, kh), summed over the G query
// heads and the Q tiles that may see its keys, in a fixed order (head
// major). Warpgroup 1 forms P^T and dV, warpgroup 2 dS^T and dK.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_tc_kernel(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap to,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, Prob P, int B) {
  using C = KvCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sV = sK + C::kBytes;
  unsigned char* sQ = sV + C::kBytes;                 // [stage]
  unsigned char* sO = sQ + kStages * C::kBytes;       // [stage]
  float* sP = reinterpret_cast<float*>(sO + kStages * C::kBytes);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sP + 32 * 128);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + kStages;

  // blocks numbered KV tile first: under a causal mask the first tiles
  // are seen by the most rows
  const int x = blockIdx.x;
  const int kh = x % P.KH, b = (x / P.KH) % B, kt = x / (P.KH * B);
  const int G = P.H / P.KH;
  const int k0 = kt * kTile, k_rows = min(kTile, P.Skv - k0);
  // the query rows that may see a key of this tile (the SIMT kernel's)
  int64_t i_lo = 0, i_hi = P.Sq - 1;
  if (!P.keep_all) {
    const int64_t k1 = k0 + k_rows - 1;
    if (P.causal) i_lo = max64(i_lo, k0 - P.q_offset);
    if (!P.is_global) i_hi = min64(i_hi, k1 + P.window - 1 - P.q_offset);
  }
  const int qt_lo = i_lo <= i_hi ? static_cast<int>(i_lo / kTile) : 0;
  const int nq =
      i_lo <= i_hi ? static_cast<int>(i_hi / kTile) - qt_lo + 1 : 0;
  const int n = nq * G;          // (head, Q tile) visits, head-major

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread loads K and V once, then streams the
    // Q and dO tiles of every visit through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n > 0) {
      mbar_expect_tx(kv_full, 2 * C::kBytes);
      tma_tile<D>(sK, C::kSlab, &tk, kv_full, kh, k0, b);
      tma_tile<D>(sV, C::kSlab, &tv, kv_full, kh, k0, b);
      for (int it = 0; it < n; ++it) {
        const int h = kh * G + it / nq, q0 = (qt_lo + it % nq) * kTile;
        const int st = it % kStages;
        mbar_wait(&q_empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&q_full[st], 2 * C::kBytes);
        tma_tile<D>(sQ + st * C::kBytes, C::kSlab, &tq, &q_full[st], h, q0,
                    b);
        tma_tile<D>(sO + st * C::kBytes, C::kSlab, &to, &q_full[st], h, q0,
                    b);
      }
    }
  } else {
    // warpgroup 1 (cw 0): S^T, P^T, dV; warpgroup 2 (cw 1): dP^T, dS^T,
    // dK. This thread holds key rows rl and rl + 8 of the tile and query
    // columns 8 j + c2 and + 1 of each Q tile (registers 4 j + e: row
    // rl + 8 (e >> 1), column 8 j + c2 + (e & 1))
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    const int rl = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
    const int c2 = 2 * (lane % 4);
    const unsigned char* sA = cw == 0 ? sK : sV;
    float acc[D / 2], s[kTile / 2];
    uint32_t a[kTile / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) s[i] = 0.f;
    if (n > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n; ++it) {
      const int h = kh * G + it / nq, q0 = (qt_lo + it % nq) * kTile;
      const int st = it % kStages;
      const unsigned char* q_t = sQ + st * C::kBytes;
      const unsigned char* o_t = sO + st * C::kBytes;
      // lse (cw 0) or delta (cw 1) of this thread's 16 query columns
      const float* row = (cw == 0 ? lse : delta) +
                         (static_cast<int64_t>(b) * P.H + h) * P.Sq + q0;
      float cv[kTile / 4];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + c2 + e;
          cv[2 * j + e] = q0 + c < P.Sq ? __ldg(row + c) : 0.f;
        }
      mbar_wait(&q_full[st], (it / kStages) & 1);
      // S^T = K Q^T (cw 0) or dP^T = V dO^T (cw 1): D / 16 steps of k16
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kTile>(s, kmajor(sA, C::kSlab, kk),
                        kmajor(cw == 0 ? q_t : o_t, C::kSlab, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (cw == 0) {
        // P^T = exp(S^T / sqrt(D) - lse). Only a tile that crosses the
        // causal diagonal, the window's edge, Sq or Skv is masked element
        // by element: masked scores take -1e30, pairs past Sq or Skv p = 0
        const int64_t p0 = P.q_offset + q0;
        const bool edge = P.keep_all || k0 + kTile > P.Skv ||
                          q0 + kTile > P.Sq ||
                          (P.causal && k0 + kTile - 1 > p0) ||
                          (!P.is_global && p0 + kTile - 1 - k0 >= P.window);
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float lse_c = cv[2 * j + (e & 1)];
            if (edge) {
              const int key = k0 + rl + 8 * (e >> 1);
              const int c = 8 * j + c2 + (e & 1);
              const int64_t qp = p0 + c;
              bool ok = true;
              if (P.causal) ok = key <= qp;
              if (!P.is_global) ok = ok && (qp - key < P.window);
              const float sv = ok ? s[i] * P.scale : kNegInf;
              s[i] = (key < P.Skv && q0 + c < P.Sq) ? expf(sv - lse_c) : 0.f;
            } else {
              s[i] = expf(s[i] * P.scale - lse_c);
            }
          }
        // hand P^T to warpgroup 2 once it has read the last visit's
        if (it > 0) bar_sync(kBarPEmpty);
#pragma unroll
        for (int i = 0; i < kTile / 2; ++i) sP[i * 128 + t] = s[i];
        bar_arrive(kBarPFull);
      } else {
        // dS^T = P^T (dP^T - delta) / sqrt(D), from the unrounded P^T
        bar_sync(kBarPFull);
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            s[i] = sP[i * 128 + t] * (s[i] - cv[2 * j + (e & 1)]) * P.scale;
          }
        if (it + 1 < n) bar_arrive(kBarPEmpty);
      }
      // dV += P^T dO (cw 0) or dK += dS^T Q (cw 1): the A operand in bf16
      // from registers, dO / Q read transposed, 4 steps of k16
#pragma unroll
      for (int j = 0; j < kTile / 4; ++j)
        a[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                                a[4 * kk + 3]};
        wgmma_rs<D>(acc, ak, nmajor(cw == 0 ? o_t : q_t, C::kSlab, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_p(a);
      release(&q_empty[st]);
    }
    // dV (cw 0) or dK (cw 1), rows rl and rl + 8, in bf16; keys past Skv
    // are not written
    __nv_bfloat16* out = cw == 0 ? dv : dk;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + rl + 8 * hh;
      if (key >= P.Skv) continue;
      __nv_bfloat16* g = out + (static_cast<int64_t>(b) * P.Skv + key) *
                                   P.KH * D +
                         static_cast<int64_t>(kh) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(g + 8 * j + c2) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh],
                                  acc[4 * j + 2 * hh + 1]);
    }
  }
}

// dq of 128 query rows of one (b, h): each consumer warpgroup owns 64 rows
// and walks the KV tiles they may see, in order
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap to,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, Prob P, int B) {
  using C = QCfg<D>;
  constexpr int BK = C::kBK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sO = sQ + C::kQBytes;
  unsigned char* sK = sO + C::kQBytes;                // [stage]
  unsigned char* sV = sK + kStages * C::kKVBytes;     // [stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * C::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // blocks numbered longest causal rows first: the last 128 rows of every
  // (b, h), then the 128 before them, ...
  const int n_qb = (P.Sq + kBM - 1) / kBM;
  const int w = blockIdx.x, pair = w % (P.H * B);
  const int h = pair % P.H, b = pair / P.H, kh = h / (P.H / P.KH);
  const int q0 = (n_qb - 1 - w / (P.H * B)) * kBM;
  const int q_rows = min(kBM, P.Sq - q0);
  const int64_t p_first = P.q_offset + q0, p_last = p_first + q_rows - 1;
  // the KV tiles some row may see: keys [lo, hi], from the first row's
  // window start to the last row's causal end
  int t_lo = 0, t_hi = (P.Skv + BK - 1) / BK;
  if (!P.keep_all) {
    const int64_t hi = P.causal ? min64(P.Skv - 1, p_last) : P.Skv - 1;
    const int64_t lo = P.is_global ? 0 : max64(0, p_first - P.window + 1);
    t_lo = static_cast<int>(lo / BK);
    t_hi = lo <= hi ? static_cast<int>(hi / BK) + 1 : t_lo;
  }
  const int nt = t_hi - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumerWarps);
      mbar_init(&v_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: Q and dO once, then the K / V ring; K and V
    // have their own barriers, so V is refilled once dP is done
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * C::kQBytes);
      tma_tile<D>(sQ, C::kQSlab, &tq, q_full, h, q0, b);
      tma_tile<D>(sO, C::kQSlab, &to, q_full, h, q0, b);
      for (int i = 0; i < nt; ++i) {
        const int st = i % kStages, k0 = (t_lo + i) * BK;
        const uint32_t free = ((i / kStages) & 1) ^ 1;
        mbar_wait(&k_empty[st], free);
        mbar_expect_tx(&k_full[st], C::kKVBytes);
        tma_tile<D>(sK + st * C::kKVBytes, C::kKVSlab, &tk, &k_full[st], kh,
                    k0, b);
        mbar_wait(&v_empty[st], free);
        mbar_expect_tx(&v_full[st], C::kKVBytes);
        tma_tile<D>(sV + st * C::kKVBytes, C::kKVSlab, &tv, &v_full[st], kh,
                    k0, b);
      }
    }
  } else {
    // consumer warpgroup cw: rows 64 cw .. 64 cw + 63; this thread holds
    // rows r and r + 8, key columns 8 j + c2 and + 1 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32;
    const int rl = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
    const int r = 64 * cw + rl, c2 = 2 * (lane % 4);
    const int64_t row0 = (static_cast<int64_t>(b) * P.H + h) * P.Sq + q0;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const bool in = q0 + r + 8 * hh < P.Sq;
      lse_r[hh] = in ? __ldg(lse + row0 + r + 8 * hh) : 0.f;
      delta_r[hh] = in ? __ldg(delta + row0 + r + 8 * hh) : 0.f;
    }
    const unsigned char* qa = sQ + 64 * cw * 128;    // our rows of Q, dO
    const unsigned char* oa = sO + 64 * cw * 128;
    float acc[D / 2], s[BK / 2], dp[BK / 2];
    uint32_t a[BK / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(q_full, 0);
    for (int i = 0; i < nt; ++i) {
      const int st = i % kStages, k0 = (t_lo + i) * BK;
      const uint32_t ph = (i / kStages) & 1;
      const unsigned char* k_t = sK + st * C::kKVBytes;
      const unsigned char* v_t = sV + st * C::kKVBytes;
      mbar_wait(&k_full[st], ph);
      mbar_wait(&v_full[st], ph);
      // S = Q K^T and dP = dO V^T: D / 16 steps of k16 each
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(s, kmajor(qa, C::kQSlab, kk),
                     kmajor(k_t, C::kKVSlab, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(dp, kmajor(oa, C::kQSlab, kk),
                     kmajor(v_t, C::kKVSlab, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      release(&v_empty[st]);
      // P = exp(S / sqrt(D) - lse), dS = P (dP - delta) / sqrt(D); only a
      // tile that crosses the causal diagonal, the window's edge or Skv is
      // masked element by element (keys past Skv get p = 0)
      const bool edge = P.keep_all || k0 + BK > P.Skv ||
                        (P.causal && k0 + BK - 1 > p_first) ||
                        (!P.is_global && p_last - k0 >= P.window);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e, hh = e >> 1;
          float p;
          if (edge) {
            const int key = k0 + 8 * j + c2 + (e & 1);
            const int64_t qp = p_first + r + 8 * hh;
            bool ok = true;
            if (P.causal) ok = key <= qp;
            if (!P.is_global) ok = ok && (qp - key < P.window);
            const float sv = ok ? s[x] * P.scale : kNegInf;
            p = key < P.Skv ? expf(sv - lse_r[hh]) : 0.f;
          } else {
            p = expf(s[x] * P.scale - lse_r[hh]);
          }
          s[x] = p * (dp[x] - delta_r[hh]) * P.scale;
        }
      // dQ += dS K: dS in bf16 from registers, K read transposed
#pragma unroll
      for (int j = 0; j < BK / 4; ++j)
        a[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                                a[4 * kk + 3]};
        wgmma_rs<D>(acc, ak, nmajor(k_t, C::kKVSlab, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_p(a);
      release(&k_empty[st]);
    }
    // dQ rows r and r + 8 in bf16; rows past Sq are not written
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = q0 + r + 8 * hh;
      if (q >= P.Sq) continue;
      __nv_bfloat16* g =
          dq + (static_cast<int64_t>(b) * P.Sq + q) * P.H * D +
          static_cast<int64_t>(h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(g + 8 * j + c2) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh],
                                  acc[4 * j + 2 * hh + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, const Prob& P, cudaStream_t stream) {
  using KC = KvCfg<D>;
  using QC = QCfg<D>;
  int rc = launch_delta<__nv_bfloat16>(o, dout, delta, B, P, stream);
  CUtensorMap tk, tv, tq, to, tq2, to2, tk2, tv2;
  if (rc == 0) rc = make_map(&tk, k, B, P.Skv, P.KH, D, kTile);
  if (rc == 0) rc = make_map(&tv, v, B, P.Skv, P.KH, D, kTile);
  if (rc == 0) rc = make_map(&tq, q, B, P.Sq, P.H, D, kTile);
  if (rc == 0) rc = make_map(&to, dout, B, P.Sq, P.H, D, kTile);
  if (rc == 0) rc = make_map(&tq2, q, B, P.Sq, P.H, D, kBM);
  if (rc == 0) rc = make_map(&to2, dout, B, P.Sq, P.H, D, kBM);
  if (rc == 0) rc = make_map(&tk2, k, B, P.Skv, P.KH, D, QC::kBK);
  if (rc == 0) rc = make_map(&tv2, v, B, P.Skv, P.KH, D, QC::kBK);
  if (rc != 0) return rc;
  const int64_t kv_blocks =
      static_cast<int64_t>((P.Skv + kTile - 1) / kTile) * P.KH * B;
  const int64_t q_blocks =
      static_cast<int64_t>((P.Sq + kBM - 1) / kBM) * P.H * B;
  if (kv_blocks > 0x7FFFFFFF || q_blocks > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);

  auto kv_kern = dkdv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(KC::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kern<<<static_cast<unsigned>(kv_blocks), kThreads, KC::kSmem, stream>>>(
      tk, tv, tq, to, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), P, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto q_kern = dq_tc_kernel<D>;
  err = cudaFuncSetAttribute(q_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(QC::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kern<<<static_cast<unsigned>(q_blocks), kThreads, QC::kSmem, stream>>>(
      tq2, to2, tk2, tv2, lse, delta, static_cast<__nv_bfloat16*>(dq), P,
      B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// delta: a (B, H, Sq) float32 scratch buffer; dq (like q), dk and dv (like
// k) are written whole. The SIMT route: float32, or bf16 at any D <= 256.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KH,
    int64_t D, int64_t causal, int64_t window, int64_t is_global,
    int64_t q_offset, float scale, int64_t bf16, cudaStream_t stream) {
  if (B == 0 || Sq == 0 || Skv == 0 || H == 0 || D == 0) return 0;
  Prob P;
  if (!make_prob(&P, B, Sq, Skv, H, KH, D, causal, window, is_global,
                 q_offset, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const int b = static_cast<int>(B);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   b, P, stream);
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, P,
                         stream);
}

// The tensor-core route: bf16 q, k, v, o, dout at D 64, 128 or 256, every
// pointer 16-byte aligned; the same arguments otherwise.
extern "C" int flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KH,
    int64_t D, int64_t causal, int64_t window, int64_t is_global,
    int64_t q_offset, float scale, cudaStream_t stream) {
  if (B == 0 || Sq == 0 || Skv == 0 || H == 0) return 0;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv);
  Prob P;
  if ((D != 64 && D != 128 && D != 256) || addr % 16 != 0 ||
      !make_prob(&P, B, Sq, Skv, H, KH, D, causal, window, is_global,
                 q_offset, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const int b = static_cast<int>(B);
  if (D == 64)
    return tc::launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, P,
                          stream);
  if (D == 128)
    return tc::launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, P,
                           stream);
  return tc::launch<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, P,
                         stream);
}
