// Attention forward with an online softmax over KV tiles (flash
// attention), causal and sliding-window masks, grouped-query heads.
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention/kernel.py; built for sm_90a.
//
// flash_attention_fwd and flash_attention_fwd_tc replace the TPU kernel
// flash_attention_pallas (src/repro/kernels/flash_attention/kernel.py:65):
//     o[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h // (H / KH)]
//     s[i, j]    = <q[b, i, h], k[b, j, h // (H / KH)]> / sqrt(D), or -1e30
//                  where masked: j > q_pos when causal, q_pos - j >= window
//                  unless the layer is global; q_pos = q_offset + i.
// q (B, Sq, H, D), k / v (B, Skv, KH, D), contiguous; float32 scores,
// softmax and sums; the output in q's dtype. Any Sq and Skv (the TPU
// kernel asserts that its tiles divide them). Two kernels, two entry
// points; the wrapper picks one from the dtype, D and alignment:
//
//  - flash_attention_fwd_tc: bf16 q, k, v with D 64, 128 or 256, every
//    pointer 16-byte aligned (the row strides H D 2 and KH D 2 bytes are
//    then multiples of 16). Tensor cores, wgmma fed by TMA.
//  - flash_attention_fwd: float32 (exact float32, no tensor cores), and
//    bf16 at any other D <= 256 or alignment. SIMT fmaf.
//
// What bounds it on an H100: operations. At gemma3-1b's prefill (S 2048,
// D 256) each (query, key) pair costs 4 D flops and each input byte is
// reused by a whole tile of rows, far above the card's ~295 flops/byte
// bf16 ridge.
//
// The tensor-core kernel. Work items are 128 query rows of one (batch,
// head), numbered longest causal rows first. One persistent block of 384
// threads per SM walks them in rounds of gridDim.x, in snake order, so the
// longest items of one round meet the shortest of the next (no atomics:
// the schedule is fixed). Warpgroup 0 is the producer; warpgroups 1 and 2
// each compute 64 rows of an item. setmaxnreg gives the producer 24
// registers and each consumer thread 240 (the O accumulator alone is
// D / 2 float32 a thread: 128 at D 256). One producer thread loads each
// item's Q by TMA (two Q buffers at D <= 128, so that the next item's Q
// lands while this one runs; one at D 256, where shared memory is full)
// and streams the K and V tiles (BK keys: 128 at D <= 128, 64 at D 256)
// through a ring of 2 stages that runs on across items, in 64-column
// slabs in the 128-byte swizzle that wgmma reads. K and V have their own
// full and empty mbarriers, so that Q K^T starts before V lands and a K
// stage is refilled as soon as its product is done. The tensor maps are
// encoded on the host per call (cuTensorMapEncodeTiled, taken through
// cudaGetDriverEntryPoint) and passed as __grid_constant__ parameters;
// TMA zero-fills rows past Sq and Skv. Per tile j a consumer warpgroup
// issues S_j = Q K_j^T (wgmma.m64nBKk16, both operands in shared memory,
// K-major, float32 accumulators) and O += P_{j-1} V_{j-1} (wgmma.m64nDk16
// with P, converted to bf16, from registers: the accumulator layout of S
// is the A-operand layout of P V; V read from its (keys, D) tile through
// the transpose flag) together, then masks S_j (only a tile that crosses
// the causal diagonal or the window's edge, or holds keys past Skv, with
// 32-bit column bounds per row) and runs the online softmax in registers
// in the log2 domain (the row max reduced over the 4 lanes of the
// accumulator layout that share a row, the row sum at the end) while the
// P V product runs, and rescales O once it is done. The epilogue divides
// by max(l, 1e-30), rounds to bf16 into the warpgroup's own Q rows in the
// 128-byte swizzle and writes them with TMA stores (rows past Sq are not
// written). Tried and measured slower on an H100 with this code: FA3's
// order (O rescaled under the next Q K^T) and pingpong scheduling of the
// two warpgroups. Not tried: packing the query heads that share a KV head
// into one item.
//
// Its numerics, held against ref.attention_ref(..., p_bf16=True,
// kv_tile=BK) on the card: Q K^T of bf16 operands is exact products
// summed in float32 (only the order of the sums differs from the plain
// version); p = 2^(t - m) from the running row max m of the tiles so far
// is rounded to bf16 for P V (the rounding the TPU's MXU makes at DEFAULT
// precision), a relative error of at most 2^-8 a weight, so the output
// moves by at most 2^-8 max|v| before its own bf16 rounding; l sums the
// unrounded float32 p.
//
// The SIMT kernel is simple: one block of 256 threads per 64 query rows
// of one (batch, head). The Q tile and each K / V tile are staged in
// shared memory in the input dtype (bf16 halves the bytes; rows padded by
// one pair so that the 16 rows a warp reads sit in distinct banks).
// Thread (ty, tx) of the 16 x 16 grid computes the scores of rows
// ty + 16 i and columns tx + 16 j as register-blocked dot products; the
// row max and row sum are reduced over the 16 lanes that hold a row with
// xor shuffles; the probabilities go through shared memory to the P V
// product, where the same thread owns rows ty + 16 i of the output and
// column pairs 2 tx + 32 j, so the running max, sum and rescale factor
// never leave its registers.
//
// Masks (both kernels). Masked scores take the reference's finite -1e30,
// never -inf, so no inf - inf appears. A block skips the KV tiles that
// lie wholly outside the mask of all its rows (in a local layer, every
// tile before the window): where a row of the reference sees such a tile
// before its first unmasked key it adds exp(0) terms that the next real
// tile's rescale exp(-1e30 - m) multiplies by exactly 0, and after it,
// exp(-1e30 - m) = 0, so skipping gives the same result. A row that sees
// no key at all (possible only when the window excludes every key) would
// take the reference's uniform average over all keys; if the block's last
// row is such a row, which it is whenever any row is, the block keeps
// every tile. Keys past Skv (the ragged last tile) are zero-filled and
// get probability exactly 0. The l >= 1e-30 floor of the division is
// kept.
//
// The row log-sum-exp. Given a (B, H, Sq) float32 `lse` pointer (the
// training forward; serving passes null and nothing else changes), both
// kernels also write lse = m + log(max(l, 1e-30)) of each query row, in
// the natural-log units of the reference's _fwd_scan
// (src/repro/models/lm/attention.py:97), from the running max m and row
// sum l they already hold: the tensor-core kernel's m, kept in the log2
// domain, is taken back by ln 2, and a row that saw no key (m = -1e30)
// gets -1e30 + log(l) as the reference's does. flash_attention_bwd.cu
// recomputes the probabilities from it.
//
// There are no atomics and every sum runs in a fixed order, so a relaunch
// is bit-identical. Each function launches on the caller's stream,
// allocates nothing, and returns the first CUDA error of the launch (the
// tensor maps, the shared-memory opt-in, then cudaGetLastError()).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Skv, int H, int KH,
                     int D, int causal, int64_t window, int is_global,
                     int64_t q_offset, float scale, int vec) {
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
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + q0 + r] =
          m[i] + logf(den);
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int KH, int D, int causal,
           int64_t window, int is_global, int64_t q_offset, float scale,
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Skv, H, KH, D,
      causal, window, is_global, q_offset, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int Sq, int Skv, int H, int KH, int D,
             int causal, int64_t window, int is_global, int64_t q_offset,
             float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, lse, B, Sq, Skv, H, KH, D, causal,
                         window, is_global, q_offset, scale, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, Sq, Skv, H, KH, D, causal,
                         window, is_global, q_offset, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, Sq, Skv, H, KH, D, causal,
                          window, is_global, q_offset, scale, stream);
  return launch<T, 256>(q, k, v, o, lse, B, Sq, Skv, H, KH, D, causal,
                        window, is_global, q_offset, scale, stream);
}

}  // namespace


// ===========================================================================
// The tensor-core kernel: bf16 q, k, v with D 64, 128 or 256
// ===========================================================================
namespace {
namespace tc {

constexpr int kBM = 128;        // query rows per block: 2 consumer warpgroups
constexpr int kThreads = 384;   // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int kStages = 2;      // depth of the K / V ring
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;
constexpr float kPastEnd = -3e38f;   // a key past Skv: below every score

template <int D>
struct Cfg {
  static constexpr int kBK = D >= 256 ? 64 : 128;    // keys per KV tile
  static constexpr int kSlabs = D / 64;              // 128-byte column slabs
  static constexpr int kQSlab = kBM * 128;           // bytes of one Q slab
  static constexpr int kKVSlab = kBK * 128;          // ... of one K / V slab
  static constexpr int kQBytes = kBM * D * 2;
  // Q buffers: two where shared memory allows, so that the next item's Q
  // lands while this one runs
  static constexpr int kQBufs = D >= 256 ? 1 : 2;
  static constexpr int kKVBytes = kBK * D * 2;       // one K or one V tile
  // q full, q empty; k, v full; k, v empty
  static constexpr int kBars = 2 * kQBufs + 4 * kStages;
  // 1024 bytes of slack to align the base to the 128-byte swizzle's atom
  static constexpr size_t kSmem =
      1024 + kQBufs * kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
};

using namespace hopper;

// One work item: 128 query rows of one (b, h) and the KV tiles they see.
// Items are numbered longest causal rows first: the last query block of
// every (b, h), then the one before it, ...; the H heads of one batch row
// side by side, so that the heads sharing a KV head read it from L2
// together.
struct Item {
  int b, h, kh, q0, q_rows, t_lo, t_hi;
  int64_t p_first, p_last;
  bool keep_all;   // the last row sees no key: keep (and mask) every tile
};

template <int BK>
__device__ __forceinline__ Item item_at(int w, int n_qb, int B, int Sq,
                                        int Skv, int H, int KH, int causal,
                                        int64_t window, int is_global,
                                        int64_t q_offset) {
  Item I;
  const int pair = w % (H * B);
  I.h = pair % H;
  I.b = pair / H;
  I.kh = I.h / (H / KH);
  I.q0 = (n_qb - 1 - w / (H * B)) * kBM;
  I.q_rows = min(kBM, Sq - I.q0);
  // the KV tiles some row may see: keys [lo, hi], from the first row's
  // window start to the last row's causal end (as in the SIMT kernel)
  I.p_first = q_offset + I.q0;
  I.p_last = I.p_first + I.q_rows - 1;
  const int64_t hi = causal ? min64(Skv - 1, I.p_last) : Skv - 1;
  const int64_t lo_last = is_global ? 0 : max64(0, I.p_last - window + 1);
  I.keep_all = lo_last > hi;
  I.t_lo = 0;
  I.t_hi = (Skv + BK - 1) / BK;
  if (!I.keep_all) {
    const int64_t lo = is_global ? 0 : max64(0, I.p_first - window + 1);
    I.t_lo = static_cast<int>(lo / BK);
    I.t_hi = static_cast<int>(hi / BK) + 1;
  }
  return I;
}

// the n-th item of this block: a persistent block per SM walks rounds of
// gridDim.x items, in snake order (forward, then backward), so that the
// longest items of one round meet the shortest of the next
__device__ __forceinline__ int item_of(int n) {
  const int g = static_cast<int>(gridDim.x), c = static_cast<int>(blockIdx.x);
  return n * g + (n % 2 == 0 ? c : g - 1 - c);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap to,
                        float* __restrict__ lse, int B,
                        int Sq, int Skv, int H, int KH, int causal,
                        int64_t window, int is_global, int64_t q_offset,
                        float scale_log2, int n_items) {
  using C = Cfg<D>;
  constexpr int BK = C::kBK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sK = sQ + C::kQBufs * C::kQBytes;   // [stage][slab][BK][64]
  unsigned char* sV = sK + kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * C::kKVBytes);
  uint64_t* q_empty = q_full + C::kQBufs;
  uint64_t* k_full = q_empty + C::kQBufs;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  const int n_qb = (Sq + kBM - 1) / kBM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kQBufs; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 2);                  // one per consumer group
    }
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
    // producer warpgroup: one thread issues every TMA load; the K / V
    // ring runs on across items (`it` counts the tiles loaded so far)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int n = 0;; ++n) {
        const int w = item_of(n);
        if (w >= n_items) break;
        const Item I = item_at<BK>(w, n_qb, B, Sq, Skv, H, KH, causal,
                                   window, is_global, q_offset);
        // the buffer's last item has stored its O
        const int qs = n % C::kQBufs;
        unsigned char* q_dst = sQ + qs * C::kQBytes;
        mbar_wait(&q_empty[qs], ((n / C::kQBufs) & 1) ^ 1);
        mbar_expect_tx(&q_full[qs], C::kQBytes);
#pragma unroll
        for (int s = 0; s < C::kSlabs; ++s)
          tma_load(q_dst + s * C::kQSlab, &tq, &q_full[qs], 64 * s, I.h,
                   I.q0, I.b);
        for (int t = I.t_lo; t < I.t_hi; ++t, ++it) {
          const int st = it % kStages;
          const uint32_t free = ((it / kStages) & 1) ^ 1;
          unsigned char* k_dst = sK + st * C::kKVBytes;
          unsigned char* v_dst = sV + st * C::kKVBytes;
          mbar_wait(&k_empty[st], free);
          mbar_expect_tx(&k_full[st], C::kKVBytes);
#pragma unroll
          for (int s = 0; s < C::kSlabs; ++s)
            tma_load(k_dst + s * C::kKVSlab, &tk, &k_full[st], 64 * s, I.kh,
                     t * BK, I.b);
          mbar_wait(&v_empty[st], free);
          mbar_expect_tx(&v_full[st], C::kKVBytes);
#pragma unroll
          for (int s = 0; s < C::kSlabs; ++s)
            tma_load(v_dst + s * C::kKVSlab, &tv, &v_full[st], 64 * s, I.kh,
                     t * BK, I.b);
        }
      }
    }
  } else {
    // consumer warpgroups: rows 64 cw .. 64 cw + 63 of each item; this
    // thread holds rows r and r + 8 of them, columns 8 j + c2 and + 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int rl = 16 * warp + lane / 4;          // row r - 64 cw
    const int r = 64 * cw + rl, c2 = 2 * (lane % 4);

    float acc[D / 2], s[BK / 2];
    uint32_t p[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float m0, m1, l0, l1;
    int it = 0;                                   // tiles consumed so far
    int stored = -1;   // the Q buffer whose O is still being stored, if any
    // once the TMA stores have read this warpgroup's O out of a Q buffer,
    // the buffer is free for the producer (one arrival per warpgroup)
    auto free_q = [&]() {
      if (stored >= 0 && threadIdx.x % 128 == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(&q_empty[stored]);
      }
      stored = -1;
    };

    // S = Q K^T of the tile in stage st: D / 16 steps of k16, both
    // operands K-major
    auto issue_qk = [&](uint32_t q_addr, int st) {
      const uint32_t k_addr = smem_u32(sK + st * C::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BK>(
            s, sw128_desc(q_addr + (kk / 4) * C::kQSlab + off, 16, 1024),
            sw128_desc(k_addr + (kk / 4) * C::kKVSlab + off, 16, 1024),
            kk > 0);
      }
    };
    // O += P V: BK / 16 steps of k16, V read transposed from its (keys, D)
    // tile; LBO steps over the 64-wide column slabs, SBO over 8 keys
    auto issue_pv = [&](int st) {
      const uint32_t v_addr = smem_u32(sV + st * C::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_rs<D>(acc, a,
                    sw128_desc(v_addr + kk * 16 * 128, C::kKVSlab, 1024));
      }
    };
    auto release = [&](uint64_t* bar) {   // this warp is done with a tile
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    for (int n = 0;; ++n) {
      const int w = item_of(n);
      if (w >= n_items) break;
      const Item I = item_at<BK>(w, n_qb, B, Sq, Skv, H, KH, causal,
                                 window, is_global, q_offset);
      const int64_t pos = q_offset + I.q0 + r;    // query position of row r
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      m0 = m1 = kNegInf;
      l0 = l1 = 0.f;

      // mask, online softmax and row sums of tile t (in s); returns the
      // rescale factors of rows r and r + 8 in a0, a1
      auto softmax = [&](int t, float& a0, float& a1) {
        // scale into the log2 domain. Only a tile that crosses the causal
        // diagonal or the window's edge, or holds keys past Skv, is
        // masked: row r + 8 h sees the tile's columns [lo_h, hi_h] (32-bit
        // offsets from the tile's first key, clamped to [-1, BK]); masked
        // keys take -1e30, keys past Skv -3e38 (below every masked score,
        // so their weight is exactly 0 even in a row that sees no key)
        const int k0 = t * BK;
        const bool edge = I.keep_all || k0 + BK > Skv ||
                          (causal && k0 + BK - 1 > I.p_first) ||
                          (!is_global && I.p_last - k0 >= window);
        if (edge) {
          int lo[2], hi[2];
          const int end = min(Skv - k0, BK) - 1 - c2;   // last key in range
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t qp = pos + 8 * h - k0;
            const int64_t top = causal ? min64(qp, BK) : BK;
            const int64_t bot = is_global ? 0 : max64(qp - window + 1, -1);
            hi[h] = static_cast<int>(max64(top, -1)) - c2;
            lo[h] = static_cast<int>(min64(bot, BK)) - c2;
          }
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int o = 8 * j + (e & 1), h = e >> 1;  // column - c2
              const float x = s[4 * j + e] * scale_log2;
              s[4 * j + e] = o > end ? kPastEnd
                             : (o >= lo[h] && o <= hi[h]) ? x : kNegInf;
            }
        } else {
#pragma unroll
          for (int j = 0; j < BK / 2; ++j) s[j] *= scale_log2;
        }
        // rows r (registers 4 j, 4 j + 1) and r + 8 (4 j + 2, 4 j + 3);
        // the 4 lanes of a quad hold a row together
        float mx[4] = {m0, m1, m0, m1};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[(e >> 1) + 2 * (j & 1)] =
                fmaxf(mx[(e >> 1) + 2 * (j & 1)], s[4 * j + e]);
        float mx0 = fmaxf(mx[0], mx[2]), mx1 = fmaxf(mx[1], mx[3]);
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        a0 = ex2(m0 - mx0);
        a1 = ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float rs[4] = {0.f, 0.f, 0.f, 0.f};     // l sums the unrounded p
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[4 * j + e] = ex2(s[4 * j + e] - (e < 2 ? m0 : m1));
            rs[(e >> 1) + 2 * (j & 1)] += s[4 * j + e];
          }
        l0 = l0 * a0 + (rs[0] + rs[2]);
        l1 = l1 * a1 + (rs[1] + rs[3]);
      };

      // Per tile j the warpgroup issues S_j = Q K_j^T and O += P_{j-1}
      // V_{j-1} together, then runs the softmax of S_j while the P V
      // product is on the tensor cores; O is rescaled once it is done. K_j
      // is released as soon as S_j is done, V_{j-1} after its product.
      const int nt = I.t_hi - I.t_lo;
      const int qs = n % C::kQBufs;
      unsigned char* so = sQ + qs * C::kQBytes + 64 * cw * 128;  // our rows
      mbar_wait(&q_full[qs], (n / C::kQBufs) & 1);
      for (int i = 0; i < nt; ++i) {
        const int st = (it + i) % kStages, pst = (it + i - 1) % kStages;
        mbar_wait(&k_full[st], ((it + i) / kStages) & 1);
        if (i > 0) mbar_wait(&v_full[pst], ((it + i - 1) / kStages) & 1);
        fence_regs(s);
        fence_regs(acc);
        wgmma_fence();
        issue_qk(smem_u32(so), st);
        wgmma_commit();
        if (i > 0) {
          issue_pv(pst);
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(s);
        release(&k_empty[st]);
        float a0, a1;
        softmax(I.t_lo + i, a0, a1);
        if (i == 0) free_q();      // the last item's stores are done by now
        wgmma_wait<0>();
        fence_regs(acc);
        fence_p(p);
        if (i > 0) release(&v_empty[pst]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= a0;
          acc[4 * j + 1] *= a0;
          acc[4 * j + 2] *= a1;
          acc[4 * j + 3] *= a1;
        }
        // P in bf16: the accumulator layout of S is the A-operand layout
        // of P V, 4 registers for each 16 keys
#pragma unroll
        for (int j = 0; j < BK / 4; ++j)
          p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      }
      {
        const int pst = (it + nt - 1) % kStages;
        mbar_wait(&v_full[pst], ((it + nt - 1) / kStages) & 1);
        fence_regs(acc);
        wgmma_fence();
        issue_pv(pst);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_p(p);
        release(&v_empty[pst]);
      }
      it += nt;

      // epilogue: l over the quad; O / max(l, 1e-30) rounded to bf16 into
      // this warpgroup's own Q rows (its Q K^T products are done) in the
      // 128-byte swizzle, then TMA stores of its 64 rows (rows past Sq
      // are not written); Q's buffer is free once they have read it
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      if (lse != nullptr && lane % 4 == 0) {
        // m in natural-log units (a row that saw no key keeps -1e30)
        const int64_t row0 = (static_cast<int64_t>(I.b) * H + I.h) * Sq +
                             I.q0;
        const float n0 = m0 <= kNegInf ? kNegInf : m0 * 0.6931471805599453f;
        const float n1 = m1 <= kNegInf ? kNegInf : m1 * 0.6931471805599453f;
        if (I.q0 + r < Sq) lse[row0 + r] = n0 + logf(fmaxf(l0, 1e-30f));
        if (I.q0 + r + 8 < Sq)
          lse[row0 + r + 8] = n1 + logf(fmaxf(l1, 1e-30f));
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        unsigned char* base = so + (j / 8) * C::kQSlab + c2 * 2;
        *reinterpret_cast<__nv_bfloat162*>(
            base + rl * 128 + (((j % 8) ^ (rl % 8)) * 16)) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        *reinterpret_cast<__nv_bfloat162*>(
            base + (rl + 8) * 128 + (((j % 8) ^ ((rl + 8) % 8)) * 16)) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                  acc[4 * j + 3] * inv1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      if (threadIdx.x % 128 == 0) {
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl)
          tma_store(&to, so + sl * C::kQSlab, 64 * sl, I.h, I.q0 + 64 * cw,
                    I.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      // with two Q buffers the next item runs from the other one: free
      // this one during its first tile; with one, free it now
      stored = qs;
      if (C::kQBufs == 1) free_q();
    }
    free_q();   // the stores must have read shared memory before exit
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int KH, int causal, int64_t window,
           int is_global, int64_t q_offset, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, to;
  int rc = make_map(&tq, q, B, Sq, H, D, kBM);
  if (rc == 0) rc = make_map(&tk, k, B, Skv, KH, D, C::kBK);
  if (rc == 0) rc = make_map(&tv, v, B, Skv, KH, D, C::kBK);
  if (rc == 0) rc = make_map(&to, o, B, Sq, H, D, kBM / 2);
  if (rc != 0) return rc;
  auto kern = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = static_cast<int64_t>((Sq + kBM - 1) / kBM) * H * B;
  if (items > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  // one persistent block per SM (the shared memory allows no second)
  const int grid = static_cast<int>(items < sms ? items : sms);
  kern<<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, to, lse, B, Sq, Skv, H, KH, causal, window, is_global,
      q_offset, scale * 1.4426950408889634f, static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int64_t B,
                                   int64_t Sq, int64_t Skv, int64_t H,
                                   int64_t KH, int64_t D, int64_t causal,
                                   int64_t window, int64_t is_global,
                                   int64_t q_offset, float scale,
                                   int64_t bf16, float* lse,
                                   cudaStream_t stream) {
  if (B == 0 || Sq == 0 || H == 0 || D == 0) return 0;
  if (D > 256 || Skv < 1 || KH < 1 || H % KH != 0 || q_offset < 0 ||
      B > 65535 || H > 65535 || Sq > (1LL << 30) || Skv > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int args[] = {static_cast<int>(B), static_cast<int>(Sq),
                      static_cast<int>(Skv), static_cast<int>(H),
                      static_cast<int>(KH), static_cast<int>(D)};
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, args[0], args[1], args[2],
                                   args[3], args[4], args[5],
                                   static_cast<int>(causal != 0), window,
                                   static_cast<int>(is_global != 0),
                                   q_offset, scale, stream);
  return dispatch<float>(q, k, v, o, lse, args[0], args[1], args[2], args[3],
                         args[4], args[5], static_cast<int>(causal != 0),
                         window, static_cast<int>(is_global != 0), q_offset,
                         scale, stream);
}

extern "C" int flash_attention_fwd_tc(const void* q, const void* k,
                                      const void* v, void* o, int64_t B,
                                      int64_t Sq, int64_t Skv, int64_t H,
                                      int64_t KH, int64_t D, int64_t causal,
                                      int64_t window, int64_t is_global,
                                      int64_t q_offset, float scale,
                                      float* lse, cudaStream_t stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if ((D != 64 && D != 128 && D != 256) || addr % 16 != 0 || Skv < 1 ||
      KH < 1 || H % KH != 0 || q_offset < 0 || B > 65535 || H > 65535 ||
      Sq > (1LL << 30) || Skv > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int b = static_cast<int>(B), sq = static_cast<int>(Sq),
            skv = static_cast<int>(Skv), h = static_cast<int>(H),
            kh = static_cast<int>(KH), c = static_cast<int>(causal != 0),
            g = static_cast<int>(is_global != 0);
  if (D == 64)
    return tc::launch<64>(q, k, v, o, lse, b, sq, skv, h, kh, c, window, g,
                          q_offset, scale, stream);
  if (D == 128)
    return tc::launch<128>(q, k, v, o, lse, b, sq, skv, h, kh, c, window, g,
                           q_offset, scale, stream);
  return tc::launch<256>(q, k, v, o, lse, b, sq, skv, h, kh, c, window, g,
                         q_offset, scale, stream);
}
