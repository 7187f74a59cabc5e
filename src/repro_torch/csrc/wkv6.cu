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
// bf16 or TF32 factors of that size would lose the result). The factor
// k e^{last - cum} is taken as (k e^{-cum}) e^{last}: both factors are
// normal floats (e^{-80} and e^{80} at the extremes) and their product is
// at most |k|.
//
// What bounds it on an H100. At rwkv6-7b's prefill (B 4, T 2048, H 64,
// N 64, bf16 r/k/v) one launch moves 474.0 MB (r/k/v 201.3, logw 134.2,
// out 134.2, s_final 4.2): 0.1415 ms at 3.35 TB/s. The causal work is
// 4 N^2 (the state's read and update) + 2 (C + 1) N (a row of the score
// tile, diagonal included, and its product with v) + N^2 / C (the state's
// decay once a chunk) = 18,816 flops a step, 9.865 GFLOP a launch: 0.1472
// ms at 67 TFLOP/s float32. Operations bound it; 87 % of them are the
// state's two products, out += (r e^{cum_prev}) S and S += (k e^{last -
// cum})^T v, which depend on the chunk before. Three limits of the SM
// sit close behind the FMA rate: each scheduler issues one instruction a
// clock, so every instruction besides an FMA costs an FMA's slot; shared
// memory returns 128 bytes a clock (an LDS.128 of a warp moves 512), so a
// thread has to do 16 FMAs for each float4 it reads there; and a loop of
// several thousand unrolled instructions runs past the instruction cache.
//
// The design: a block of 384 threads serves two (batch, head) pairs; each
// pair has four producer and two consumer warps, which hand chunks over
// through a ring of two stages in shared memory guarded by named barriers
// (bar.arrive by the writer, bar.sync by the reader; nothing block-wide in
// the loop). Warps 0-7 produce and 8-11 consume, so each of the SM's four
// schedulers runs two producer warps (one of which builds a score tile)
// and one consumer warp. The loops stay short: the consumer's body is
// about 1,150 instructions with a rolled loop over four output blocks and
// another over the chunk's 16 steps (fully unrolled, the same work ran
// slower).
//  - Producer, thread (column n, half) with 8 consecutive rows of the
//    chunk: loads chunk c + 1's r, k, v, logw into registers while it
//    prepares chunk c: the prefix sum of logw down the column (the second
//    half starts from the first half's total, taken by a shuffle, so the
//    sum runs in the sequential order of the reference's cumsum), the
//    decayed factors with two expf an element, the diagonal r u k summed
//    over n by shuffles and over the four warps in a fixed order. Two of
//    the four warps then take the causal 16 x 16 score tile: ten 4 x 4
//    tiles, each over four slices of n (one lane each) summed by two
//    shuffle rounds. The stage receives r e^{cum_prev}, k e^{last - cum},
//    v, e^{last} and the score tile; FULL is arrived on.
//  - Consumer, thread (row group g = lane / 8, column block) holds the
//    state of 16 rows (float4 groups 4 q + g) by 4 columns in registers:
//    every float4 it reads feeds 16 FMAs, and the 8 lanes of a quarter
//    warp read the same factors. Per chunk it waits on FULL, then for each
//    block a of four output rows takes the state's share over its 16 rows
//    plus the chunk's own share over the four steps j = 4 g .. 4 g + 3 (A
//    v), and sums the four row groups by two shuffle rounds (row b of the
//    block is taken as 4 a + (b ^ g), so that each round keeps the lower
//    half with no select) while the next block computes; lane g writes row
//    4 a + g. Then it decays and updates the state, each step's factors
//    loaded during the step before, and arrives on the stage's EMPTY
//    barrier, on which the producer waits before it writes that stage
//    again.
// Shared memory: 17.5 KB a stage, 70 KB a block. There are no atomics and
// the order of every sum is fixed, so a relaunch is bit-identical. The
// function launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 16;          // chunk length (the reference's CHUNK)
constexpr int kN = 64;          // largest head size
constexpr int kHeads = 2;       // (batch, head) pairs a block serves
constexpr int kProdWarps = 4;   // per pair
constexpr int kConsWarps = 2;   // per pair
constexpr int kProducers = 32 * kProdWarps;
constexpr int kPerHead = 32 * (kProdWarps + kConsWarps);
constexpr int kThreads = kHeads * kPerHead;
constexpr int kStages = 2;
constexpr unsigned kAll = 0xffffffffu;

// named barriers (0 is __syncthreads): FULL and EMPTY per pair and stage,
// one among a pair's producers
__device__ __forceinline__ int full_bar(int hs, int s) {
  return 1 + hs * kStages + s;
}
__device__ __forceinline__ int empty_bar(int hs, int s) {
  return 1 + (kHeads + hs) * kStages + s;
}
__device__ __forceinline__ int prod_bar(int hs) {
  return 1 + 2 * kHeads * kStages + hs;
}
static_assert(1 + 2 * kHeads * kStages + kHeads <= 16, "named barriers");

struct Stage {
  float qd[kC][kN];     // r e^{cum_prev}
  float kr[kC][kN];     // k e^{last - cum}
  float kd[kC][kN];     // k e^{-cum} (producer only)
  float v[kC][kN];
  float a[kC][kC];      // the score tile, zero above the diagonal
  float wl[kN];         // e^{last}
  float dp[kProdWarps][kC];   // the diagonal's sums over each warp's n
};
constexpr size_t kSmem = sizeof(Stage) * kStages * kHeads;

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

struct Args {
  const float* logw;
  const float* u;
  const float* s0;
  float* out;
  float* s_final;
  int64_t base;   // element offset of (b, t = 0, h, n = 0)
  int64_t step;   // elements between time steps, H * N
  int T_len, h, N, bh, hs, nchunks;
};

template <typename T>
__device__ __forceinline__ void producer(Stage* st, int pi,
                                         const T* __restrict__ r,
                                         const T* __restrict__ k,
                                         const T* __restrict__ v,
                                         const Args& p) {
  const int l = threadIdx.x & 31;
  const int hf = l >> 4;                 // rows 8 hf .. 8 hf + 7
  const int n = 16 * pi + (l & 15);      // column
  const bool nok = n < p.N;
  const float un = nok ? p.u[p.h * p.N + n] : 0.f;

  // zero the score tiles: those above the diagonal are never written
  for (int s = 0; s < kStages; ++s)
    for (int x = 32 * pi + l; x < kC * kC; x += kProducers)
      st[s].a[x / kC][x % kC] = 0.f;

  T pr[8], pk[8], pv[8];
  float pw[8];
  auto fetch = [&](int t0) {
    const int t1 = t0 + 8 * hf;
    const int64_t off = p.base + static_cast<int64_t>(t1) * p.step + n;
    if (nok && t1 + 8 <= p.T_len) {       // all 8 rows inside T
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int64_t o = off + e * p.step;
        pr[e] = r[o];
        pk[e] = k[o];
        pv[e] = v[o];
        pw[e] = p.logw[o];
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      pr[e] = pk[e] = pv[e] = zero_of<T>();
      pw[e] = 0.f;
      if (nok && t1 + e < p.T_len) {
        const int64_t o = off + e * p.step;
        pr[e] = r[o];
        pk[e] = k[o];
        pv[e] = v[o];
        pw[e] = p.logw[o];
      }
    }
  };
  fetch(0);

  // the diagonal's shuffle sum leaves lane l the row 8 hf + dr
  const int dr = 4 * ((l >> 3) & 1) + 2 * ((l >> 2) & 1) + ((l >> 1) & 1);
  // the score tile, by two of the four warps (0 and 1 for the first pair,
  // 2 and 3 for the second, so that each scheduler runs one of them): lane
  // = 4 x 4 tile t (of five) x slice sl of n; tile t of warp pi is (I, J)
  // = nibble t of these words
  const int tile = l >> 2, sl = l & 3;
  const unsigned tI = (pi & 1) ? 0x22211u : 0x33330u;
  const unsigned tJ = (pi & 1) ? 0x21010u : 0x32100u;
  const int I = (tI >> (4 * tile)) & 15, J = (tJ >> (4 * tile)) & 15;
  const bool tiles = (pi >> 1) == p.hs && tile < 5;

  for (int c = 0; c < p.nchunks; ++c) {
    const int s = c % kStages;
    Stage& X = st[s];
    float lw[8], rr[8], kk[8], vv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      lw[e] = pw[e];
      rr[e] = to_f32(pr[e]);
      kk[e] = to_f32(pk[e]);
      vv[e] = to_f32(pv[e]);
    }
    if (c + 1 < p.nchunks) fetch((c + 1) * kC);   // in flight from here

    // the prefix sum down column n, in the sequential order
    float cum[8], run = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      run += lw[e];
      cum[e] = run;
    }
    const float first = __shfl_sync(kAll, run, l & 15);
    if (hf) {
      run = first;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        run += lw[e];
        cum[e] = run;
      }
    }
    const float wl = expf(__shfl_sync(kAll, run, (l & 15) | 16));
    float qd[8], kd[8], ruk[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qd[e] = rr[e] * expf(cum[e] - lw[e]);
      kd[e] = kk[e] * expf(-cum[e]);
      ruk[e] = rr[e] * un * kk[e];
    }

    // the diagonal: sum r u k over this warp's 16 columns (lanes 8, 4, 2, 1
    // apart hold the same rows), halving the rows each round
    float d4[4], d2[2], d1;
    {
      const bool hi = (l & 8) != 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float send = hi ? ruk[e] : ruk[e + 4];
        const float keep = hi ? ruk[e + 4] : ruk[e];
        d4[e] = keep + __shfl_xor_sync(kAll, send, 8);
      }
    }
    {
      const bool hi = (l & 4) != 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float send = hi ? d4[e] : d4[e + 2];
        const float keep = hi ? d4[e + 2] : d4[e];
        d2[e] = keep + __shfl_xor_sync(kAll, send, 4);
      }
    }
    {
      const bool hi = (l & 2) != 0;
      const float send = hi ? d2[0] : d2[1];
      const float keep = hi ? d2[1] : d2[0];
      d1 = keep + __shfl_xor_sync(kAll, send, 2);
    }
    d1 += __shfl_xor_sync(kAll, d1, 1);   // a + b == b + a: both lanes agree

    if (c >= kStages) bar_sync(empty_bar(p.hs, s), kPerHead);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 8 * hf + e;
      X.qd[i][n] = qd[e];
      X.kd[i][n] = kd[e];
      X.kr[i][n] = kd[e] * wl;
      X.v[i][n] = vv[e];
    }
    if (!hf) X.wl[n] = wl;
    if (!(l & 1)) X.dp[pi][8 * hf + dr] = d1;
    bar_sync(prod_bar(p.hs), kProducers);

    // the score tile (I, J) over n = 4 (4 c4 + sl) .. + 3; entry 4 a + b
    // of acc is row 4 I + (a ^ sl), column 4 J + b, so that two shuffle
    // rounds leave lane sl row 4 I + sl
    if (tiles) {
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll 1
      for (int c4 = 0; c4 < 4; ++c4) {
        const int col = 4 * (4 * c4 + sl);
        float4 q[4], kx[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) q[a] = ld4(&X.qd[4 * I + (a ^ sl)][col]);
#pragma unroll
        for (int b = 0; b < 4; ++b) kx[b] = ld4(&X.kd[4 * J + b][col]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[4 * a + b] = dot4(q[a], kx[b], acc[4 * a + b]);
      }
      constexpr unsigned kTiles = 0x000fffffu;   // lanes of the five tiles
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[e] += __shfl_xor_sync(kTiles, acc[e + 8], 2);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e] += __shfl_xor_sync(kTiles, acc[e + 4], 1);
      const int i = 4 * I + sl;
      const float diag =
          ((X.dp[0][i] + X.dp[1][i]) + X.dp[2][i]) + X.dp[3][i];
      float o[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * J + b;
        o[b] = j < i ? acc[b] : (j == i ? diag : 0.f);
      }
      *reinterpret_cast<float4*>(&X.a[i][4 * J]) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
    bar_arrive(full_bar(p.hs, s), kPerHead);
  }
}

__device__ __forceinline__ void consumer(Stage* st, int ci, const Args& p) {
  const int l = threadIdx.x & 31;
  // row group g = l / 8: the 8 lanes of a quarter warp read one address
  // of the factors, which the shared memory serves in fewer clocks than
  // several addresses
  const int g = l >> 3;
  const int m0 = 4 * (8 * ci + (l & 7));     // columns m0 .. m0 + 3
  const bool vec_out = (p.N % 4) == 0 && m0 + 4 <= p.N;
  // the state: S[q][s4][cc] = S[16 q + 4 g + s4][m0 + cc]
  float S[4][4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int s4 = 0; s4 < 4; ++s4)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int row = 16 * q + 4 * g + s4, m = m0 + cc;
        S[q][s4][cc] =
            (p.s0 != nullptr && row < p.N && m < p.N)
                ? p.s0[(static_cast<int64_t>(p.bh) * p.N + row) * p.N + m]
                : 0.f;
      }

  for (int c = 0; c < p.nchunks; ++c) {
    const int s = c % kStages;
    const Stage& X = st[s];
    const int t0 = c * kC;
    bar_sync(full_bar(p.hs, s), kPerHead);

    // this thread's share of the chunk's own term: steps j = 4 g + jj
    float4 vg[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) vg[jj] = ld4(&X.v[4 * g + jj][m0]);
    // the output, four rows at a time: entry b of o is row 4 a + (b ^ g).
    // The first factor rows of the next block are loaded while a block
    // computes, and a block's sums over the row groups run beside the next
    // block's products
    float4 xn[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) xn[b] = ld4(&X.qd[b ^ g][4 * g]);
    auto block = [&](int a, float (&o)[4][4]) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) o[b][cc] = 0.f;
      float4 xq[4][4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        xq[0][b] = xn[b];
#pragma unroll
        for (int q = 1; q < 4; ++q)
          xq[q][b] = ld4(&X.qd[4 * a + (b ^ g)][16 * q + 4 * g]);
      }
      float4 at[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) at[b] = ld4(&X.a[4 * a + (b ^ g)][4 * g]);
      if (a + 1 < 4) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          xn[b] = ld4(&X.qd[4 * (a + 1) + (b ^ g)][4 * g]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float x[4] = {xq[q][b].x, xq[q][b].y, xq[q][b].z,
                              xq[q][b].w};
#pragma unroll
          for (int s4 = 0; s4 < 4; ++s4)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              o[b][cc] = fmaf(x[s4], S[q][s4][cc], o[b][cc]);
        }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float av[4] = {at[b].x, at[b].y, at[b].z, at[b].w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          o[b][0] = fmaf(av[jj], vg[jj].x, o[b][0]);
          o[b][1] = fmaf(av[jj], vg[jj].y, o[b][1]);
          o[b][2] = fmaf(av[jj], vg[jj].z, o[b][2]);
          o[b][3] = fmaf(av[jj], vg[jj].w, o[b][3]);
        }
      }
    };
    // ... summed over the four row groups: lanes 16 apart (g ^ 2) hold
    // entries 2, 3 of each other's entries 0, 1, lanes 8 apart (g ^ 1)
    // entry 1 of entry 0; lane (g, m0) ends with row 4 a + g, written if
    // inside T
    auto finish = [&](int a, float (&o)[4][4]) {
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          o[b][cc] += __shfl_xor_sync(kAll, o[b + 2][cc], 16);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        o[0][cc] += __shfl_xor_sync(kAll, o[1][cc], 8);
      const int t = t0 + 4 * a + g;
      if (t < p.T_len) {
        float* dst = p.out + p.base + t * p.step + m0;
        if (vec_out) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(o[0][0], o[0][1], o[0][2], o[0][3]);
        } else {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            if (m0 + cc < p.N) dst[cc] = o[0][cc];
        }
      }
    };
    float o[4][4], prev[4][4];
    block(0, prev);
#pragma unroll 1
    for (int a = 1; a < 4; ++a) {
      block(a, o);
      finish(a - 1, prev);
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) prev[b][cc] = o[b][cc];
    }
    finish(3, prev);

    // the state: decay, then add the chunk's keys times values
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 d = ld4(&X.wl[16 * q + 4 * g]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        S[q][0][cc] *= d.x;
        S[q][1][cc] *= d.y;
        S[q][2][cc] *= d.z;
        S[q][3][cc] *= d.w;
      }
    }
    // ... the next step's key factors and values loaded while this one
    // computes
    float4 vn = ld4(&X.v[0][m0]), kn[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) kn[q] = ld4(&X.kr[0][16 * q + 4 * g]);
#pragma unroll 2
    for (int j = 0; j < kC; ++j) {
      const float vc[4] = {vn.x, vn.y, vn.z, vn.w};
      float4 x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = kn[q];
      if (j + 1 < kC) {
        vn = ld4(&X.v[j + 1][m0]);
#pragma unroll
        for (int q = 0; q < 4; ++q) kn[q] = ld4(&X.kr[j + 1][16 * q + 4 * g]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          S[q][0][cc] = fmaf(x[q].x, vc[cc], S[q][0][cc]);
          S[q][1][cc] = fmaf(x[q].y, vc[cc], S[q][1][cc]);
          S[q][2][cc] = fmaf(x[q].z, vc[cc], S[q][2][cc]);
          S[q][3][cc] = fmaf(x[q].w, vc[cc], S[q][3][cc]);
        }
      }
    }
    // the producer waits on this only for a chunk it has still to write
    if (c + kStages < p.nchunks) bar_arrive(empty_bar(p.hs, s), kPerHead);
  }

#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int s4 = 0; s4 < 4; ++s4)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int row = 16 * q + 4 * g + s4, m = m0 + cc;
        if (row < p.N && m < p.N)
          p.s_final[(static_cast<int64_t>(p.bh) * p.N + row) * p.N + m] =
              S[q][s4][cc];
      }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ logw,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, float* __restrict__ out,
                      float* __restrict__ s_final, int BH, int T_len, int H,
                      int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const bool produce = warp < kHeads * kProdWarps;
  Args p;
  // warps 0-3 and 8-9 serve the first pair, 4-7 and 10-11 the second
  p.hs = produce ? warp / kProdWarps
                 : (warp - kHeads * kProdWarps) / kConsWarps;
  p.bh = blockIdx.x * kHeads + p.hs;             // b * H + h
  if (p.bh >= BH) return;   // an odd B * H: that pair's warps have no work
  const int b = p.bh / H;
  p.h = p.bh % H;
  p.logw = logw;
  p.u = u;
  p.s0 = s0;
  p.out = out;
  p.s_final = s_final;
  p.step = static_cast<int64_t>(H) * N;
  p.base = (static_cast<int64_t>(b) * T_len * H + p.h) * N;
  p.T_len = T_len;
  p.N = N;
  p.nchunks = (T_len + kC - 1) / kC;
  Stage* st = reinterpret_cast<Stage*>(smem) + p.hs * kStages;
  if (produce)
    producer<T>(st, warp % kProdWarps, r, k, v, p);
  else
    consumer(st, warp % kConsWarps, p);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* out, void* s_final, int BH,
           int T_len, int H, int N, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (BH + kHeads - 1) / kHeads;
  wkv6_chunk_kernel<T><<<blocks, kThreads, kSmem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_final), BH, T_len, H,
      N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* logw, const void* u, const void* s0,
                        void* out, void* s_final, int64_t B, int64_t T,
                        int64_t H, int64_t N, int64_t bf16_inputs,
                        cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  // two (batch, head) pairs per block in grid.x; t * H * N is taken in
  // 64 bits
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
