// Attention forward with an online softmax over KV tiles (flash
// attention), causal and sliding-window masks, grouped-query heads.
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention/kernel.py; built for sm_90a.
//
// flash_attention_fwd replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py:65):
//     o[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h // (H / KH)]
//     s[i, j]    = <q[b, i, h], k[b, j, h // (H / KH)]> / sqrt(D), or -1e30
//                  where masked: j > q_pos when causal, q_pos - j >= window
//                  unless the layer is global; q_pos = q_offset + i.
// q (B, Sq, H, D), k / v (B, Skv, KH, D), contiguous, float32 or bfloat16;
// float32 scores, softmax and sums; the output in q's dtype. Any Sq and
// Skv (the TPU kernel asserts that its tiles divide them), D <= 256.
//
// What bounds it on an H100: operations. At gemma3-1b's prefill (S 2048,
// D 256) each (query, key) pair costs 4 D flops and each input byte is
// reused by a whole tile of rows, far above the card's ~295 flops/byte
// bf16 ridge. This first version is simple and uses no tensor cores (the
// float32 path must stay exact float32 anyway): one block of 256 threads
// per 64 query rows of one (batch, head). The Q tile and each K / V tile
// are staged in shared memory in the input dtype (bf16 halves the bytes;
// rows padded by one pair so that the 16 rows a warp reads sit in
// distinct banks). Thread (ty, tx) of the 16 x 16 grid computes the
// scores of rows ty + 16 i and columns tx + 16 j as register-blocked dot
// products; the row max and row sum are reduced over the 16 lanes that
// hold a row with xor shuffles; the probabilities go through shared
// memory to the P V product, where the same thread owns rows ty + 16 i of
// the output and column pairs 2 tx + 32 j, so the running max, sum and
// rescale factor never leave its registers. wgmma and TMA are a later
// version's tools.
//
// Masks. Masked scores take the reference's finite -1e30, never -inf, so
// no inf - inf appears. A block skips the KV tiles that lie wholly outside
// the mask of all its rows (in a local layer, every tile before the
// window): where a row of the reference sees such a tile before its first
// unmasked key it adds exp(0) terms that the next real tile's rescale
// exp(-1e30 - m) multiplies by exactly 0, and after it, exp(-1e30 - m) =
// 0, so skipping gives the same result. A row that sees no key at all
// (possible only when the window excludes every key) would take the
// reference's uniform average over all keys; if the block's last row is
// such a row, which it is whenever any row is, the block keeps every tile.
// Keys past Skv (the ragged last tile) are zero-filled and get probability
// exactly 0. The l >= 1e-30 floor of the division is kept.
//
// There are no atomics and every sum runs in a fixed order, so a relaunch
// is bit-identical. The function launches on the caller's stream,
// allocates nothing, and returns the first CUDA error of the launch (the
// shared-memory opt-in, then cudaGetLastError()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr float kNegInf = -1e30f;

// Tile shape for a head dim padded up to DP (32, 64, 128 or 256).
template <int DP>
struct Tile {
  static constexpr int kBK = DP >= 256 ? 32 : 64;   // keys per KV tile
  static constexpr int kLD = DP + 2;     // Q / K / V row stride (elements)
  static constexpr int kPLD = kBK + 16;  // P row stride: rows ty, ty + 1
                                         // 16 banks apart
  static constexpr int kSC = kBK / 16;   // score columns per thread
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

template <typename T, int DP>
constexpr size_t smem_bytes() {
  using C = Tile<DP>;
  return sizeof(float) * kBQ * C::kPLD +
         sizeof(T) * (kBQ + 2 * C::kBK) * C::kLD;
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

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Skv, int H, int KH, int D, int causal,
                     int64_t window, int is_global, int64_t q_offset,
                     float scale, int vec) {
  using C = Tile<DP>;
  constexpr int BK = C::kBK, LD = C::kLD, PLD = C::kPLD, SC = C::kSC,
                OP = C::kOP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sP = reinterpret_cast<float*>(smem);            // (kBQ, PLD)
  T* sQ = reinterpret_cast<T*>(sP + kBQ * PLD);          // (kBQ, LD)
  T* sK = sQ + kBQ * LD;                                 // (BK, LD)
  T* sV = sK + BK * LD;                                  // (BK, LD)

  const int qb = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qb * kBQ;
  const int q_rows = min(kBQ, Sq - q0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(KH) * D;
  const T* qg = q + (static_cast<int64_t>(b) * Sq + q0) * q_stride +
                static_cast<int64_t>(h) * D;
  const T* kg = k + static_cast<int64_t>(b) * Skv * kv_stride +
                static_cast<int64_t>(kh) * D;
  const T* vg = v + static_cast<int64_t>(b) * Skv * kv_stride +
                static_cast<int64_t>(kh) * D;

  // The KV tiles some row of this block may see: keys [lo, hi], from the
  // first row's window start to the last row's causal end.
  const int64_t p_first = q_offset + q0, p_last = q_offset + q0 + q_rows - 1;
  const int64_t hi = causal ? min64(Skv - 1, p_last) : Skv - 1;
  const int64_t lo_last = is_global ? 0 : max64(0, p_last - window + 1);
  const int n_tiles = (Skv + BK - 1) / BK;
  int t_lo = 0, t_hi = n_tiles;
  if (lo_last <= hi) {                  // the last row sees a key: skip
    const int64_t lo =
        is_global ? 0 : max64(0, p_first - window + 1);
    t_lo = static_cast<int>(lo / BK);
    t_hi = static_cast<int>(hi / BK) + 1;
  }

  load_tile<T, DP, kBQ>(sQ, qg, q_stride, q_rows, D, vec);

  float m[4], l[4], acc[4][OP][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OP; ++j) acc[i][j][0] = acc[i][j][1] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // the last tile's reads are done
    load_tile<T, DP, BK>(sK, kg + k0 * kv_stride, kv_stride, Skv - k0, D,
                         vec);
    load_tile<T, DP, BK>(sV, vg + k0 * kv_stride, kv_stride, Skv - k0, D,
                         vec);
    __syncthreads();

    // scores of rows ty + 16 i, columns tx + 16 j
    float s[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; d += 2) {
      float2 qv[4], kv[SC];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = ld2(sQ + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < SC; ++j) kv[j] = ld2(sK + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        }
    }

    // mask, online softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qp = q_offset + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = k0 + tx + 16 * j;
        bool ok = true;
        if (causal) ok = c <= qp;
        if (!is_global) ok = ok && (qp - c < window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        if (c < Skv) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p = c < Skv ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * PLD + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OP; ++j) {
        acc[i][j][0] *= alpha;
        acc[i][j][1] *= alpha;
      }
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i, column pairs 2 tx + 32 j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < OP; ++j) {
        const float2 vv = ld2(sV + c * LD + 2 * tx + 32 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(p[i], vv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(p[i], vv.y, acc[i][j][1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* og = o + ((static_cast<int64_t>(b) * Sq + q0 + r) * H + h) *
                    static_cast<int64_t>(D);
#pragma unroll
    for (int j = 0; j < OP; ++j) {
      const int d = 2 * tx + 32 * j;
      if (d < D) st(og + d, acc[i][j][0] / den);
      if (d + 1 < D) st(og + d + 1, acc[i][j][1] / den);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KH, int D, int causal, int64_t window,
           int is_global, int64_t q_offset, float scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DP>;
  constexpr size_t smem = smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = addr % 16 == 0 && D % (16 / sizeof(T)) == 0;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KH, D,
      causal, window, is_global, q_offset, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int H, int KH, int D, int causal,
             int64_t window, int is_global, int64_t q_offset, float scale,
             cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KH, D, causal, window,
                         is_global, q_offset, scale, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KH, D, causal, window,
                         is_global, q_offset, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KH, D, causal, window,
                          is_global, q_offset, scale, stream);
  return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, KH, D, causal, window,
                        is_global, q_offset, scale, stream);
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int64_t B,
                                   int64_t Sq, int64_t Skv, int64_t H,
                                   int64_t KH, int64_t D, int64_t causal,
                                   int64_t window, int64_t is_global,
                                   int64_t q_offset, float scale,
                                   int64_t bf16, cudaStream_t stream) {
  if (B == 0 || Sq == 0 || H == 0 || D == 0) return 0;
  if (D > 256 || Skv < 1 || KH < 1 || H % KH != 0 || q_offset < 0 ||
      B > 65535 || H > 65535 || Sq > (1LL << 30) || Skv > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int args[] = {static_cast<int>(B), static_cast<int>(Sq),
                      static_cast<int>(Skv), static_cast<int>(H),
                      static_cast<int>(KH), static_cast<int>(D)};
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, args[0], args[1], args[2],
                                   args[3], args[4], args[5],
                                   static_cast<int>(causal != 0), window,
                                   static_cast<int>(is_global != 0),
                                   q_offset, scale, stream);
  return dispatch<float>(q, k, v, o, args[0], args[1], args[2], args[3],
                         args[4], args[5], static_cast<int>(causal != 0),
                         window, static_cast<int>(is_global != 0), q_offset,
                         scale, stream);
}
