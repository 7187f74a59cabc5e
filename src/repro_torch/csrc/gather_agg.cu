// Fused gather + per-edge-weighted reduce for the GNN aggregation, and its
// scatter-add backward for dx. Plain C interface, loaded with ctypes by
// repro_torch/kernels/gather_agg/kernel.py; built for sm_90a.
//
// gather_agg_fwd replaces the TPU kernel gather_agg_fwd_pallas
// (src/repro/kernels/gather_agg/kernel.py:56):
//     out[i, :] = sum_j w[i, j] * x[idx[i, j], :]      (j = 0 .. r-1)
// What bounds it on an H100: device-memory bytes. Each output row reads r
// whole source rows (2408 bytes each at F = 602) and does 2 flops per
// float read, far below the card's ~20 flops/byte float32 ridge. Design:
// one block per destination row; the row's r indices and weights are
// staged once in shared memory; the threads stride over F so that a warp
// reads consecutive addresses of each gathered row (coalesced), with the
// widest vector load (float4 / float2 / float) that F and the base
// pointers allow — F = 602 is not a multiple of 4, so it takes float2.
// The sum runs in j order with separate multiply and add, the order the
// TPU kernel accumulates in, and never materialises (n_dst, r, F).
//
// gather_agg_bwd_dx replaces gather_agg_bwd_dx_pallas (kernel.py:101):
//     dx[s, :] = sum over edges e with idx_e == s of w_e * g[dst_e, :]
// It is bound by bytes too (each edge reads one g row). Design: the edges
// arrive stably sorted by source row with per-row [row_start, row_end)
// ranges (computed outside with torch.sort / torch.searchsorted, as the
// reference argsorts outside its Pallas body). The runs are very uneven:
// every padded destination row of a batch points at the one sentinel
// source row, so that row can own tens of thousands of (zero-weight)
// edges, and one block walking it alone serialises the launch. So each
// run is cut into chunks of at most `chunk` edges: bwd_dx_chunk_kernel
// sums one chunk per block in sorted order, and writes a row that fits in
// one chunk (almost all of them, empty rows included) straight into dx;
// the chunks of longer rows go to a scratch buffer, which
// bwd_dx_combine_kernel sums in chunk order. The order is fixed, so the
// result is bit-identical from run to run, with no float atomics and no
// zero-fill pass; a row of at most `chunk` edges is summed exactly in the
// reference's sorted order. Masked edges (w = 0) are kept, so a NaN in g
// propagates as in the reference.
//
// Both functions launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// acc = acc + w * x, rounded as two operations (no fused multiply-add)
template <int V>
__device__ __forceinline__ void axpy(float (&acc)[V], float w,
                                     const float (&x)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(w, x[k]));
}

template <int V>
__global__ void fwd_kernel(const float* __restrict__ x,
                           const int32_t* __restrict__ idx,
                           const float* __restrict__ w,
                           float* __restrict__ out,
                           int64_t n_dst, int r, int64_t F) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem);
  float* s_w = reinterpret_cast<float*>(s_idx + r);
  const int64_t n_vec = F / V;
  for (int64_t i = blockIdx.x; i < n_dst; i += gridDim.x) {
    for (int j = threadIdx.x; j < r; j += blockDim.x) {
      s_idx[j] = idx[i * r + j];
      s_w[j] = w[i * r + j];
    }
    __syncthreads();
    for (int64_t c = threadIdx.x; c < n_vec; c += blockDim.x) {
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < r; ++j) {
        float v[V];
        load_vec<V>(x + static_cast<int64_t>(s_idx[j]) * F + c * V, v);
        axpy<V>(acc, s_w[j], v);
      }
      store_vec<V>(out + i * F + c * V, acc);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int64_t n_chunks(int32_t count, int chunk) {
  return count > chunk ? (count + chunk - 1) / chunk : 1;
}

template <int V>
__global__ void bwd_dx_chunk_kernel(const float* __restrict__ g,
                                    const int32_t* __restrict__ dst_sorted,
                                    const float* __restrict__ w_sorted,
                                    const int32_t* __restrict__ row_start,
                                    const int32_t* __restrict__ row_end,
                                    const int32_t* __restrict__ chunk_first,
                                    const int32_t* __restrict__ multi_first,
                                    float* __restrict__ dx,
                                    float* __restrict__ partial,
                                    int64_t n_src, int64_t F, int chunk,
                                    int64_t n_chunks_max) {
  const int64_t n_vec = F / V;
  for (int64_t c = blockIdx.x; c < n_chunks_max; c += gridDim.x) {
    // the row owning chunk c: the last s with chunk_first[s] <= c
    int64_t lo = 0, hi = n_src;
    while (hi - lo > 1) {
      const int64_t mid = (lo + hi) / 2;
      if (chunk_first[mid] <= c) lo = mid; else hi = mid;
    }
    const int64_t s = lo;
    const int32_t e_begin = row_start[s];
    const int32_t e_end = row_end[s];
    const int64_t nch = n_chunks(e_end - e_begin, chunk);
    const int64_t k = c - chunk_first[s];
    if (k >= nch) continue;               // past the last row's chunks
    const int32_t a = e_begin + static_cast<int32_t>(k) * chunk;
    const int32_t b = min(a + chunk, e_end);
    float* target = nch == 1 ? dx + s * F
                             : partial + (multi_first[s] + k) * F;
    for (int64_t v = threadIdx.x; v < n_vec; v += blockDim.x) {
      float acc[V];
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = 0.0f;
#pragma unroll 4
      for (int32_t e = a; e < b; ++e) {
        float x[V];
        load_vec<V>(g + static_cast<int64_t>(__ldg(dst_sorted + e)) * F +
                        v * V, x);
        axpy<V>(acc, __ldg(w_sorted + e), x);
      }
      store_vec<V>(target + v * V, acc);
    }
  }
}

template <int V>
__global__ void bwd_dx_combine_kernel(const float* __restrict__ partial,
                                      const int32_t* __restrict__ row_start,
                                      const int32_t* __restrict__ row_end,
                                      const int32_t* __restrict__ multi_first,
                                      float* __restrict__ dx, int64_t n_src,
                                      int64_t F, int chunk) {
  const int64_t n_vec = F / V;
  for (int64_t s = blockIdx.x; s < n_src; s += gridDim.x) {
    const int64_t nch = n_chunks(row_end[s] - row_start[s], chunk);
    if (nch == 1) continue;               // written by the chunk kernel
    const float* base = partial + multi_first[s] * F;
    for (int64_t v = threadIdx.x; v < n_vec; v += blockDim.x) {
      float acc[V];
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = 0.0f;
#pragma unroll 4
      for (int64_t k = 0; k < nch; ++k) {
        float x[V];
        load_vec<V>(base + k * F + v * V, x);
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] = __fadd_rn(acc[q], x[q]);
      }
      store_vec<V>(dx + s * F + v * V, acc);
    }
  }
}

// widest vector whose loads and stores stay aligned for every row
int vec_width(int64_t F, const void* a, const void* b) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a) |
                      reinterpret_cast<uintptr_t>(b);
  if (F % 4 == 0 && p % 16 == 0) return 4;
  if (F % 2 == 0 && p % 8 == 0) return 2;
  return 1;
}

int threads_for(int64_t n_vec) {
  int64_t t = ((n_vec + 31) / 32) * 32;
  return static_cast<int>(t < kMaxThreads ? (t < 32 ? 32 : t) : kMaxThreads);
}

unsigned grid_for(int64_t rows) {
  return static_cast<unsigned>(rows < (1LL << 30) ? rows : (1LL << 30));
}

}  // namespace

extern "C" int gather_agg_fwd(const float* x, const int32_t* idx,
                              const float* w, float* out, int64_t n_dst,
                              int64_t r, int64_t F, cudaStream_t stream) {
  if (n_dst == 0 || F == 0) return 0;
  const int V = vec_width(F, x, out);
  const dim3 grid(grid_for(n_dst));
  const dim3 block(threads_for(F / V));
  const size_t smem = static_cast<size_t>(r) * (sizeof(int32_t) + sizeof(float));
  const int ri = static_cast<int>(r);
  if (V == 4) {
    fwd_kernel<4><<<grid, block, smem, stream>>>(x, idx, w, out, n_dst, ri, F);
  } else if (V == 2) {
    fwd_kernel<2><<<grid, block, smem, stream>>>(x, idx, w, out, n_dst, ri, F);
  } else {
    fwd_kernel<1><<<grid, block, smem, stream>>>(x, idx, w, out, n_dst, ri, F);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_agg_bwd_dx(const float* g, const int32_t* dst_sorted,
                                 const float* w_sorted,
                                 const int32_t* row_start,
                                 const int32_t* row_end,
                                 const int32_t* chunk_first,
                                 const int32_t* multi_first, float* dx,
                                 float* partial, int64_t n_src, int64_t F,
                                 int64_t chunk, int64_t n_chunks_max,
                                 cudaStream_t stream) {
  if (n_src == 0 || F == 0) return 0;
  const int Vg = vec_width(F, g, dx);
  const int Vp = vec_width(F, partial, dx);
  const int V = Vg < Vp ? Vg : Vp;
  const dim3 block(threads_for(F / V));
  const dim3 grid_c(grid_for(n_chunks_max));
  const dim3 grid_r(grid_for(n_src));
  const int ch = static_cast<int>(chunk);
#define REPRO_BWD_DX(VW)                                                     \
  bwd_dx_chunk_kernel<VW><<<grid_c, block, 0, stream>>>(                     \
      g, dst_sorted, w_sorted, row_start, row_end, chunk_first, multi_first, \
      dx, partial, n_src, F, ch, n_chunks_max);                              \
  bwd_dx_combine_kernel<VW><<<grid_r, block, 0, stream>>>(                   \
      partial, row_start, row_end, multi_first, dx, n_src, F, ch);
  if (V == 4) {
    REPRO_BWD_DX(4)
  } else if (V == 2) {
    REPRO_BWD_DX(2)
  } else {
    REPRO_BWD_DX(1)
  }
#undef REPRO_BWD_DX
  return static_cast<int>(cudaGetLastError());
}
