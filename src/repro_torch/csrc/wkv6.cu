// Chunked WKV6 recurrence of RWKV6 "Finch" token mixing. Plain C
// interface, loaded with ctypes by repro_torch/kernels/rwkv6_chunk/kernel.py;
// built for sm_90a.
//
// wkv6_fwd replaces the TPU kernel wkv6_pallas
// (src/repro/kernels/rwkv6_chunk/kernel.py:55). Per (batch, head) an
// (N, N) state S (rows: key channel n, columns: value channel m) runs over
// the sequence:
//     out_t = r_t (S + diag(u) k_t v_t^T)
//     S    <- diag(exp(logw_t)) S + k_t v_t^T
// computed in chunks of C = 16 steps in the matmul form of wkv6_chunked
// (src/repro/models/lm/rwkv6.py:88): with cum the inclusive prefix sum of
// logw over the chunk, cum_prev = cum - logw and last = cum[C - 1],
//   A[i][j]   = sum_n r[i][n] e^{cum_prev[i][n]} k[j][n] e^{-cum[j][n]}, j < i
//   A[i][i]   = sum_n r[i][n] u[n] k[i][n]
//   out[i][m] = sum_j A[i][j] v[j][m]
//               + sum_n r[i][n] e^{cum_prev[i][n]} S[n][m]
//   S[n][m]  <- e^{last[n]} S[n][m]
//               + sum_j k[j][n] e^{last[n] - cum[j][n]} v[j][m]
// r/k/v (B, T, H, N) bfloat16 or float32 (all three alike), logw
// (B, T, H, N) and u (H, N) float32, s0 (B, H, N, N) float32 or null for
// zeros; out (B, T, H, N) and s_final (B, H, N, N) float32. Unlike the TPU
// kernel it starts from s0 and returns the final state (the prefill hands
// it to the decode cache), and it takes any T >= 1: the steps past T in the
// last chunk count with logw = 0 and k = 0, which leaves the state as it
// is, and their outputs are not written. N <= 64; a smaller N is padded
// with zeros to 64 inside the block.
//
// Float32 range. The factored form e^{cum_prev} x e^{-cum} above, as the
// reference writes it, reaches e^{80} (logw >= -5 in the model, C = 16);
// it stays inside float32 only with exact float32 math. So every product
// is a float32 fmaf and every exp is expf (no fast-math, no tensor cores:
// bf16 or TF32 factors of that size would lose the result).
//
// What bounds it on an H100. At rwkv6-7b's prefill (B 4, T 2048, H 64,
// N 64, bf16 r/k/v) one launch moves 474.0 MB (r/k/v 201.3, logw 134.2,
// out 134.2, s_final 4.2): 0.1415 ms at 3.35 TB/s. Counting the whole
// 16 x 16 score tile and its product with v, it does 10.74 GFLOP in
// float32 (327,680 a chunk of a (batch, head)): 0.160 ms at 67 TFLOP/s.
// But the tile's upper half is zero: the causal work is 4 N^2 (the
// state's read and update) + 2 (C + 1) N (a row of the tile, diagonal
// included, and its product with v) + N^2 / C (the state's decay once a
// chunk) = 18,816 flops a step, 9.865 GFLOP a launch: 0.1472 ms.
// Operations bound it, at 0.1472 ms. The design:
//  - One block of 256 threads per (batch, head): 256 blocks, two on each
//    SM, all resident at once. The loop over chunks inside the block takes
//    the place of the TPU's sequential grid axis.
//  - The state lives in registers: thread (row group g, column m) holds
//    S[16 g .. 16 g + 15][m]. Its update needs only that thread's rows and
//    the chunk's decayed keys and values, so no thread reads another's
//    state. The output's sum over n is taken over each thread's 16 rows
//    and then across the four row groups of a column by warp shuffles
//    (lanes 8 apart hold the same column), which leave each lane four of
//    the chunk's 16 rows.
//  - Per chunk, shared memory holds logw and v, the decayed factors
//    r e^{cum_prev}, k e^{-cum}, k e^{last - cum} (rows padded by 4 floats
//    so that float4 reads of 8 different rows hit distinct banks), the
//    16 x 16 score tile and e^{last}: 27 KB a block.
//  - The next chunk's r, k, v and logw are loaded into registers while the
//    current chunk computes.
// There are no atomics and the order of every sum is fixed, so a relaunch
// is bit-identical. The function launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 16;          // chunk length (the reference's CHUNK)
constexpr int kN = 64;          // largest head size
constexpr int kThreads = 256;
constexpr int kLD = kN + 4;     // padded row of the decayed factors

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0.f); }
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __ushort_as_bfloat16(0);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ logw,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, float* __restrict__ out,
                      float* __restrict__ s_final, int T_len, int H, int N) {
  __shared__ __align__(16) float lw_s[kC][kN];
  __shared__ __align__(16) float v_s[kC][kN];
  __shared__ __align__(16) float ruk_s[kC][kN];   // r u k, for A's diagonal
  __shared__ __align__(16) float qd_s[kC][kLD];   // r e^{cum_prev}
  __shared__ __align__(16) float kd_s[kC][kLD];   // k e^{-cum}
  __shared__ __align__(16) float kr_s[kC][kLD];   // k e^{last - cum}
  __shared__ __align__(16) float a_s[kC][kC + 1];
  __shared__ __align__(16) float wl_s[kN];        // e^{last}

  const int bh = blockIdx.x;                      // b * H + h
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  // loads and decays: column n, rows qr + 4 e
  const int n = tid % kN, qr = tid / kN;
  // state and output: column m, rows 16 g .. 16 g + 15 (g: lanes 8 apart)
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 3;
  const int m = warp * 8 + (lane & 7);

  const int64_t step = static_cast<int64_t>(H) * N;   // between time steps
  const int64_t base = (static_cast<int64_t>(b) * T_len * H + h) * N;
  const float un = n < N ? u[h * N + n] : 0.f;

  float S[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int row = g * 16 + q;
    S[q] = (s0 != nullptr && row < N && m < N)
               ? s0[(static_cast<int64_t>(bh) * N + row) * N + m]
               : 0.f;
  }

  // this thread's elements of the chunk starting at t0, as loaded
  T pr[4], pk[4], pv[4];
  float pw[4];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + qr + 4 * e;
      pr[e] = pk[e] = pv[e] = zero_of<T>();
      pw[e] = 0.f;
      if (t < T_len && n < N) {
        const int64_t off = base + t * step + n;
        pr[e] = r[off];
        pk[e] = k[off];
        pv[e] = v[off];
        pw[e] = logw[off];
      }
    }
  };
  fetch(0);

  const int nchunks = (T_len + kC - 1) / kC;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kC;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lw_s[qr + 4 * e][n] = pw[e];
      v_s[qr + 4 * e][n] = to_f32(pv[e]);
    }
    __syncthreads();

    // decays: the prefix sum of logw down column n, kept at this thread's
    // rows, then the three decayed factors of its four elements
    float cum = 0.f, cum_at[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      cum += lw_s[i][n];
      if ((i & 3) == qr) cum_at[i >> 2] = cum;
    }
    const float last = cum;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = qr + 4 * e;
      const float rr = to_f32(pr[e]), kk = to_f32(pk[e]);
      qd_s[i][n] = rr * expf(cum_at[e] - pw[e]);
      kd_s[i][n] = kk * expf(-cum_at[e]);
      kr_s[i][n] = kk * expf(last - cum_at[e]);
      ruk_s[i][n] = rr * un * kk;
    }
    if (qr == 0) wl_s[n] = expf(last);
    if (c + 1 < nchunks) fetch(t0 + kC);   // in flight while this chunk runs
    __syncthreads();

    // the score tile: thread (i, j), zero above the diagonal
    {
      const int i = tid >> 4, j = tid & 15;
      float acc = 0.f;
      if (j < i) {
#pragma unroll
        for (int c4 = 0; c4 < kN; c4 += 4)
          acc = dot4(*reinterpret_cast<const float4*>(&qd_s[i][c4]),
                     *reinterpret_cast<const float4*>(&kd_s[j][c4]), acc);
      } else if (j == i) {
#pragma unroll
        for (int c4 = 0; c4 < kN; c4 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(&ruk_s[i][c4]);
          acc += x.x;
          acc += x.y;
          acc += x.z;
          acc += x.w;
        }
      }
      a_s[i][j] = acc;
    }
    __syncthreads();

    // the state's share of each output row, over this thread's 16 rows
    float p[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const float4* q4 = reinterpret_cast<const float4*>(&qd_s[i][g * 16]);
      float acc = 0.f;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq)
        acc = dot4(q4[qq], make_float4(S[4 * qq], S[4 * qq + 1],
                                       S[4 * qq + 2], S[4 * qq + 3]),
                   acc);
      p[i] = acc;
    }
    // ... summed over the four row groups: lanes 16 apart swap halves of
    // the 16 rows, then lanes 8 apart halves of those; lane (g, m) ends
    // with rows 4 g .. 4 g + 3
    const bool hi1 = (lane & 16) != 0, hi2 = (lane & 8) != 0;
    float p8[8], p4[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float send = hi1 ? p[e] : p[e + 8];
      const float keep = hi1 ? p[e + 8] : p[e];
      p8[e] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float send = hi2 ? p8[e] : p8[e + 4];
      const float keep = hi2 ? p8[e + 4] : p8[e];
      p4[e] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }

    // plus the chunk's own share, A v; write the rows inside T
    float vj[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) vj[j] = v_s[j][m];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * g + e;
      float acc = p4[e];
#pragma unroll
      for (int j = 0; j < kC; ++j) acc = fmaf(a_s[i][j], vj[j], acc);
      const int t = t0 + i;
      if (t < T_len && m < N) out[base + t * step + m] = acc;
    }

    // the state: decay, then add the chunk's keys times values
    {
      const float4* w4 = reinterpret_cast<const float4*>(&wl_s[g * 16]);
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const float4 w = w4[qq];
        S[4 * qq] *= w.x;
        S[4 * qq + 1] *= w.y;
        S[4 * qq + 2] *= w.z;
        S[4 * qq + 3] *= w.w;
      }
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float4* k4 = reinterpret_cast<const float4*>(&kr_s[j][g * 16]);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const float4 a = k4[qq];
          S[4 * qq] = fmaf(a.x, vj[j], S[4 * qq]);
          S[4 * qq + 1] = fmaf(a.y, vj[j], S[4 * qq + 1]);
          S[4 * qq + 2] = fmaf(a.z, vj[j], S[4 * qq + 2]);
          S[4 * qq + 3] = fmaf(a.w, vj[j], S[4 * qq + 3]);
        }
      }
    }
    __syncthreads();   // before the next chunk overwrites shared memory
  }

#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int row = g * 16 + q;
    if (row < N && m < N)
      s_final[(static_cast<int64_t>(bh) * N + row) * N + m] = S[q];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* out, void* s_final, int BH,
           int T_len, int H, int N, cudaStream_t stream) {
  wkv6_chunk_kernel<T><<<BH, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_final), T_len, H, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* logw, const void* u, const void* s0,
                        void* out, void* s_final, int64_t B, int64_t T,
                        int64_t H, int64_t N, int64_t bf16_inputs,
                        cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  // one block per (batch, head) in grid.x; t * H * N is taken in 64 bits
  if (B < 0 || H < 0 || T < 1 || N < 1 || N > kN || B * H > 0x7fffffffLL ||
      T > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bh = static_cast<int>(B * H), t = static_cast<int>(T),
            h = static_cast<int>(H), n = static_cast<int>(N);
  if (bf16_inputs)
    return launch<bf16>(r, k, v, logw, u, s0, out, s_final, bh, t, h, n,
                        stream);
  return launch<float>(r, k, v, logw, u, s0, out, s_final, bh, t, h, n,
                       stream);
}
