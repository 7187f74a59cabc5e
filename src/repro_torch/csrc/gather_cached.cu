// Two-level (cache-or-global) feature row gather for the device-resident
// feature cache. Plain C interface, loaded with ctypes by
// repro_torch/kernels/gather_cached/kernel.py; built for sm_90a.
//
// gather_cached_fwd replaces the TPU kernel gather_cached_fwd_pallas
// (src/repro/kernels/gather_cached/kernel.py:44):
//     g = clip(ids[k], 0, N - 1)
//     out[k, :] = cache[pos[g], :]  if 0 <= ids[k] < N and pos[g] >= 0
//               = feats[g, :]       otherwise
// Ids outside [0, N) are padding: they read the clipped global row.
//
// What bounds it on an H100: device-memory bytes. It is a copy: one row
// read and one row written per id (2408 bytes each at F = 602), no
// arithmetic. Design: one warp per output row (8 rows per block, the grid
// striding over the rows). The warp reads ids[k] and pos[g] once, picks
// the source row of the one table it selects, and its lanes copy the row
// in the widest vector (float4 / float2 / float) that F and the three base
// pointers allow — F = 602 is not a multiple of 4, so it takes float2.
// The TPU kernel partitions the ids hits-first so that its BlockSpec
// pipeline never re-fetches the pinned row of the table it did not select;
// here each row reads only the table it selects, so no sort is needed.
// There is no reduction, so relaunches are bit-identical by construction.
//
// The function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;            // one warp per row

template <typename T>                       // float4, float2 or float
__global__ void gather_cached_kernel(const T* __restrict__ cache,
                                     const T* __restrict__ feats,
                                     const int32_t* __restrict__ pos,
                                     const int32_t* __restrict__ ids,
                                     T* __restrict__ out, int64_t M,
                                     int64_t N, int64_t n_vec) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                   (threadIdx.x >> 5);
       k < M; k += n_warps) {               // warp-uniform
    const int64_t id = __ldg(ids + k);
    const int64_t g = id < 0 ? 0 : (id >= N ? N - 1 : id);
    const int32_t sel = __ldg(pos + g);
    const bool hit = id >= 0 && id < N && sel >= 0;
    const T* src = hit ? cache + static_cast<int64_t>(sel) * n_vec
                       : feats + g * n_vec;
    T* dst = out + k * n_vec;
#pragma unroll 4
    for (int64_t c = lane; c < n_vec; c += 32) dst[c] = __ldg(src + c);
  }
}

// widest vector whose loads and stores stay aligned for every row
int vec_width(int64_t F, const void* a, const void* b, const void* c) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a) |
                      reinterpret_cast<uintptr_t>(b) |
                      reinterpret_cast<uintptr_t>(c);
  if (F % 4 == 0 && p % 16 == 0) return 4;
  if (F % 2 == 0 && p % 8 == 0) return 2;
  return 1;
}

template <typename T>
void launch(const float* cache, const float* feats, const int32_t* pos,
            const int32_t* ids, float* out, int64_t M, int64_t N,
            int64_t n_vec, cudaStream_t stream) {
  int64_t blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  gather_cached_kernel<T><<<static_cast<unsigned>(blocks),
                            32 * kRowsPerBlock, 0, stream>>>(
      reinterpret_cast<const T*>(cache), reinterpret_cast<const T*>(feats),
      pos, ids, reinterpret_cast<T*>(out), M, N, n_vec);
}

}  // namespace

extern "C" int gather_cached_fwd(const float* cache, const float* feats,
                                 const int32_t* pos, const int32_t* ids,
                                 float* out, int64_t M, int64_t N, int64_t F,
                                 cudaStream_t stream) {
  if (M == 0 || F == 0) return 0;
  const int V = vec_width(F, cache, feats, out);
  if (V == 4) {
    launch<float4>(cache, feats, pos, ids, out, M, N, F / 4, stream);
  } else if (V == 2) {
    launch<float2>(cache, feats, pos, ids, out, M, N, F / 2, stream);
  } else {
    launch<float>(cache, feats, pos, ids, out, M, N, F, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
