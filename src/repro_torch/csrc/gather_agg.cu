// Fused gather + per-edge-weighted reduce for the GNN aggregation, and its
// two backward kernels: the scatter-add for dx and the gather-dot for dw.
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/gather_agg/kernel.py; built for sm_90a.
//
// gather_agg_fwd replaces the TPU kernel gather_agg_fwd_pallas
// (src/repro/kernels/gather_agg/kernel.py:56):
//     out[i, :] = sum_j w[i, j] * x[idx[i, j], :]      (j = 0 .. r-1)
// What bounds it on an H100: device-memory bytes. Each output row reads r
// whole source rows (2408 bytes each at F = 602) and does 2 flops per
// float read, far below the card's ~20 flops/byte float32 ridge. The rows
// a call gathers are read ~4.6 times each, but the L2 cache (50 MB) holds
// too few of them for the order of the destination rows to matter:
// GraphSAGE's layer 0 gathers 390 MB of distinct rows, drawn at random
// within communities, the largest of which holds 77 % of the synthetic
// Reddit graph (431 MB of features); timing it with the rows permuted or
// sorted by their first source gives the level order's time. So the
// design is about keeping enough row loads in flight. A group of G lanes
// (a power of two, each lane holding kAggFloats floats of a row: 16 lanes
// at F = 64, 4 at F = 10, a whole warp at F >= 128) owns a destination row
// and 256-thread blocks hold 256 / G rows; a row wider than a warp's tile
// (F = 602: 301 float2 in 5 tiles of 64) is cut into tiles owned by
// neighbouring warps, so that all of its bytes are asked for at once. The
// row's indices and weights are read by the group's lanes in one
// coalesced load and broadcast by shuffle (no shared memory, no barrier);
// each lane loads the vectors of kAggEdges (5) edges, then adds them.
// More edges in flight per lane (10) cost registers and resident blocks,
// and measured slower than 5 at 6 blocks per SM (40 registers). A batch
// whose edges all name one row loads it once and adds it to each: a
// destination row that the batch pads to its cap names the padding row r
// times (weight 0), and such rows are 13 % of a full batch's rows and up
// to 96 % of a small one's. Loads are
// the widest vector (float4 / float2 / float) that F and the base
// pointers allow. The sum runs in j order from 0 with separate multiply
// and add, so the output equals gather_agg_ref_ordered bit for bit and
// never materialises (n_dst, r, F). Masked edges (w = 0) are read and
// summed, so a NaN in x propagates as in the reference.
//
// gather_agg_bwd_dx replaces gather_agg_bwd_dx_pallas (kernel.py:101):
//     dx[s, :] = sum over edges e with idx_e == s of w_e * g[dst_e, :]
// It is bound by bytes: it writes every dx row, most of them (a level's
// rows that no edge names) zeros, and reads each edge's g row; where g
// outgrows the L2 cache (GAT's first layer: 76 MB, each row read by r
// edges) those reads go to device memory again and again.
// The edges arrive as runs of equal source rows in a stable by-source
// order, the reference's order, from one of two places:
//  - a plan (gather_agg_bwd_dx_plan): the keys stably sorted once per
//    index, as the reference argsorts outside its Pallas body (CUB's
//    radix sort, the one torch.sort calls, over only the bits [0, n)
//    needs, in one call with the edge ids and each row's run offsets).
//    The plan holds no weights: the kernel reads w through the edge id,
//    so one plan serves every launch over that index. A plan of `src`
//    also serves the head-folded index `src * H + h` (GAT): row s * H + h
//    walks s's run with destination i * H + h, which is the order a
//    stable sort of the folded index gives;
//  - the index itself, when the caller states that it is non-decreasing
//    (a level's self rows): a row finds its run by binary search in the
//    keys, with no plan and no sort. The kernel checks every adjacent pair
//    of those keys and their range, and traps on a violation, so an
//    unsorted index gives a launch error, never a wrong dx.
// Design: a group of lanes sized to F (one lane for F = 4, a whole warp
// for F >= 256), several groups to a warp and 256 threads to a block,
// owns up to 8 consecutive rows of one head (1 or 2 on a plan), whose
// runs are one contiguous span of sorted edges. It walks that span in
// batches that cross row boundaries: a batch loads its edge ids and
// weights, then its g rows (as wide vectors as alignment allows), and
// only then adds, so that a lane keeps several row loads in flight even
// where rows hold one edge or none; a row is stored when the walk passes
// its end. The heads of the same rows sit in neighbouring groups, so
// their g rows are read together. A row of at most kChunk (64) edges,
// empty rows included, is summed and written in this one pass.
// The runs are very uneven: every padded destination row of a batch names
// the one padding source row, so that row can own tens of thousands of
// (zero-weight) edges. Such a long run is cut at the multiples of kChunk
// of the sorted edge array: each window of kChunk positions holds at most
// two pieces of long runs (one ending in it, one starting in it), so the
// pieces have static scratch slots (2 per window) and need no scan; they
// are summed in the same phase as the rows. After a grid-wide barrier
// each long run's pieces are summed in window order, kChunk pieces per
// group, into dx or, for a run of more than kChunk windows, into the
// group's first slot; after a second barrier those are summed in order.
// A small call (at most 16384 edges, and tasks that fit on the card at
// once) runs the three phases as one cooperative launch, split by
// grid-wide barriers, so that it costs the host one launch; a larger one
// as three launches. Every sum starts from 0 and runs in a fixed order
// with separate multiply and add, so a row of at most kChunk edges equals
// the CPU's index_add_ (edge order) bit for bit, and a relaunch is
// bit-identical, with no atomics. Masked edges (w = 0) are kept, so a NaN
// in g propagates as in the reference.
//
// gather_agg_bwd_dw replaces gather_agg_bwd_dw_pallas (kernel.py:151):
//     dw[i, j] = <g[i, :], x[idx[i, j], :]>
// the gradient of the per-edge weights, live only when they carry one
// (GAT's attention weights). It is bound by bytes: it reads g once, each
// gathered x row, idx, and writes dw, for 2 flops per float of x. Design:
// fwd's gather, padded rows included (one dot, copied to each edge). The
// lane groups and tiles are fwd's; per batch of
// kAggEdges edges a lane holds its slice of g[i] (loaded once per tile)
// and loads every edge's slice of x together, keeping one partial dot per
// edge (fused multiply-adds in column order); the group then reduces the
// batch's partials in log2 G shuffle exchanges, halving the values each
// lane holds at every step, and the lanes left holding them store
// dw[i, j0 .. j0 + 5) together. Every sum runs in a fixed order (columns,
// then the exchange tree), so relaunches are bit-identical, with no
// atomics; against the plain version each entry is within
// 2 F eps sum_k |g[i, k] x[idx[i, j], k]|. The TPU kernel pads r to 128
// lanes for its stores; here the output is (n_dst, r).
//
// Every function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() of its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <cub/device/device_radix_sort.cuh>

namespace cg = cooperative_groups;

namespace {

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

// the lanes of this thread's group of G
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return G == 32 ? 0xffffffffu
                 : ((1u << G) - 1) << (threadIdx.x & 31 & ~(G - 1));
}

// ---------------------------------------------------------------------------
// gather_agg_fwd and gather_agg_bwd_dw: the same gather
// ---------------------------------------------------------------------------
constexpr int kAggThreads = 256;
constexpr int kAggEdges = 5;    // edges whose rows a lane loads before it
                                // adds; a row is walked in batches of this
                                // many (the models' r = 10: two)
constexpr int kAggPow2 = 8;     // kAggEdges rounded up to a power of two
constexpr int kAggFloats = 4;   // floats of each gathered row a lane holds
                                // per batch and column tile
constexpr int kDwBlocks = 4;    // resident blocks per SM of bwd_dw_kernel
                                // (64 registers)

// ... and of fwd_kernel: 6 (40 registers) at float4 rows of 8 lanes or
// more (the main path's F = 64 and 256), 5 (48) at float2 rows of a warp
// (F = 602), which spill in 40; 4 (64) at the others
__host__ __device__ constexpr int fwd_blocks(int V, int G) {
  return V == 4 && G >= 8 ? 6 : V == 2 && G == 32 ? 5 : 4;
}

// Row i's edges [j0, j0 + m), m <= kAggEdges: lane gl of the group holds
// the index and weight of edges j0 + gl + G * k, read in one coalesced
// load per k (a warp's groups own consecutive rows, so consecutive
// addresses); every lane reads them by shuffle.
template <int G>
struct EdgeBatch {
  static constexpr int K = (kAggEdges + G - 1) / G;
  int32_t idx[K];
  float w[K];

  __device__ __forceinline__ void load(const int32_t* __restrict__ ip,
                                       const float* __restrict__ wp,
                                       int m, int gl) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = gl + G * k;
      idx[k] = j < m ? __ldg(ip + j) : 0;
      w[k] = (wp != nullptr && j < m) ? __ldg(wp + j) : 0.0f;
    }
  }
  // true in every lane of the group if all m edges name one source row
  // (a padded destination row's edges all name the padding row)
  __device__ __forceinline__ bool one_row(int m, int gl,
                                          unsigned mask) const {
    const int32_t s0 = __shfl_sync(mask, idx[0], 0, G);
    bool same = true;
#pragma unroll
    for (int k = 0; k < K; ++k) same &= gl + G * k >= m || idx[k] == s0;
    return (__ballot_sync(mask, same) & mask) == mask;
  }
  // the source row of edge j0 + e (e a constant after unrolling)
  __device__ __forceinline__ int64_t src(int e, unsigned mask) const {
    return __shfl_sync(mask, idx[e / G], e % G, G);
  }
  __device__ __forceinline__ float weight(int e, unsigned mask) const {
    return __shfl_sync(mask, w[e / G], e % G, G);
  }
};

// Loads the group's column tile (vectors c0 + G * q of each lane) of the
// source rows of the batch's first n edges into v, all before any is used
template <int V, int G, int U, int Q>
__device__ __forceinline__ void load_rows(const float* __restrict__ x,
                                          int64_t F, const EdgeBatch<G>& eb,
                                          int n, int64_t c0, int64_t n_vec,
                                          unsigned mask, float (&v)[U][Q][V]) {
#pragma unroll
  for (int e = 0; e < U; ++e) {
    if (e < n) {
      const float* row = x + eb.src(e, mask) * F;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (c0 + q * G < n_vec) load_vec<V>(row + (c0 + q * G) * V, v[e][q]);
    }
  }
}

// out[i, :] = sum_j w[i, j] * x[idx[i, j], :]. A group of G lanes owns
// one column tile of one row: lane gl holds vectors c0 + gl + G * q
// (q < Q), so that each load of the group reads consecutive addresses. A
// row wider than one tile (G = 32) is cut into T tiles owned by
// neighbouring groups, so that all of its bytes are asked for together.
// For each batch of kAggEdges edges the group loads every edge's vectors
// first and only then adds them, in j order from 0 (multiply, then add).
template <int V, int G>
__global__ void __launch_bounds__(kAggThreads, fwd_blocks(V, G))
fwd_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
           const float* __restrict__ w, float* __restrict__ out,
           int64_t n_dst, int r, int64_t F, int T) {
  constexpr int Q = kAggFloats / V;
  constexpr int U = kAggEdges;
  const int64_t task = static_cast<int64_t>(blockIdx.x) * (kAggThreads / G) +
                       threadIdx.x / G;
  const int64_t i = task / T;
  if (i >= n_dst) return;                       // the whole group
  const int gl = threadIdx.x % G;
  const unsigned mask = group_mask<G>();
  const int64_t n_vec = F / V;
  const int64_t c0 = (task - i * T) * (G * Q) + gl;
  float acc[Q][V];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[q][k] = 0.0f;
  for (int j0 = 0; j0 < r; j0 += U) {
    const int m = r - j0 < U ? r - j0 : U;
    EdgeBatch<G> eb;
    eb.load(idx + i * r + j0, w + i * r + j0, m, gl);
    float v[U][Q][V];
    if (eb.one_row(m, gl, mask)) {
      // one load serves every edge: the same bytes, the same sums
      load_rows<V, G>(x, F, eb, 1, c0, n_vec, mask, v);
#pragma unroll
      for (int e = 0; e < U; ++e) {
        if (e < m) {
          const float we = eb.weight(e, mask);
#pragma unroll
          for (int q = 0; q < Q; ++q)
            if (c0 + q * G < n_vec) axpy<V>(acc[q], we, v[0][q]);
        }
      }
      continue;
    }
    load_rows<V, G>(x, F, eb, m, c0, n_vec, mask, v);
#pragma unroll
    for (int e = 0; e < U; ++e) {
      if (e < m) {
        const float we = eb.weight(e, mask);
#pragma unroll
        for (int q = 0; q < Q; ++q)
          if (c0 + q * G < n_vec) axpy<V>(acc[q], we, v[e][q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (c0 + q * G < n_vec)
      store_vec<V>(out + i * F + (c0 + q * G) * V, acc[q]);
}

// Sums each of a lane's C values t[0 .. C) over the G lanes of its group:
// a halving exchange (the lane whose bit O is clear keeps the lower half
// of the values, its partner the upper half, each adding the other's
// copy, the clear lane's value first), then xor butterflies once one
// value is left. Afterwards lane gl holds, in t[0 .. max(C / G, 1)), the
// sums of values gl * C / G, ... (C >= G), or of value gl / (G / C).
template <int G, int O, int C, int N>
__device__ __forceinline__ void group_sum(float (&t)[N], int gl,
                                          unsigned mask) {
  if constexpr (O >= 1) {
    const bool up = (gl & O) != 0;
    constexpr int H = C > 1 ? C / 2 : 1;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float mine = C > 1 && up ? t[k + H] : t[k];
      const float other = __shfl_xor_sync(
          mask, C > 1 && !up ? t[k + H] : t[k], O, G);
      t[k] = up ? __fadd_rn(other, mine) : __fadd_rn(mine, other);
    }
    group_sum<G, O / 2, H, N>(t, gl, mask);
  }
}

// dw[i, j] = <g[i, :], x[idx[i, j], :]>. A group of G lanes owns one row
// (all of its column tiles, in turn), with fwd_kernel's lanes: per batch
// of kAggEdges edges and column tile it loads its slice of g[i] and every
// edge's slice of x together, and keeps one partial dot per edge (fused
// multiply-adds in column order); group_sum then reduces the batch's
// partials over the group in log2 G exchanges, and the lanes holding the
// results store dw[i, j0 ..] together.
template <int V, int G>
__global__ void __launch_bounds__(kAggThreads, kDwBlocks)
bwd_dw_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
              const float* __restrict__ g, float* __restrict__ dw,
              int64_t n_dst, int r, int64_t F) {
  constexpr int Q = kAggFloats / V;
  constexpr int U = kAggEdges;
  constexpr int P = kAggPow2;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (kAggThreads / G) +
                    threadIdx.x / G;
  if (i >= n_dst) return;                       // the whole group
  const int gl = threadIdx.x % G;
  const unsigned mask = group_mask<G>();
  const int64_t n_vec = F / V;
  const float* gi = g + i * F;
  for (int j0 = 0; j0 < r; j0 += U) {
    const int m = r - j0 < U ? r - j0 : U;
    EdgeBatch<G> eb;
    eb.load(idx + i * r + j0, nullptr, m, gl);
    float t[P];
#pragma unroll
    for (int e = 0; e < P; ++e) t[e] = 0.0f;
    // one source row for all m edges: one dot, copied to each
    const int n_rows = eb.one_row(m, gl, mask) ? 1 : m;
    for (int64_t c0 = gl; c0 - gl < n_vec; c0 += G * Q) {
      float gv[Q][V];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (c0 + q * G < n_vec) load_vec<V>(gi + (c0 + q * G) * V, gv[q]);
      float v[U][Q][V];
      load_rows<V, G>(x, F, eb, n_rows, c0, n_vec, mask, v);
#pragma unroll
      for (int e = 0; e < U; ++e)
        if (e < n_rows)
#pragma unroll
          for (int q = 0; q < Q; ++q)
            if (c0 + q * G < n_vec)
#pragma unroll
              for (int k = 0; k < V; ++k)
                t[e] = fmaf(gv[q][k], v[e][q][k], t[e]);
    }
#pragma unroll
    for (int e = 1; e < U; ++e)
      if (n_rows == 1) t[e] = t[0];
    group_sum<G, G / 2, P, P>(t, gl, mask);
    constexpr int kHeld = P >= G ? P / G : 1;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const int e = P >= G ? gl * (P / G) + k : gl / (G / P);
      if (e < m && (P >= G || gl % (G / P) == 0)) dw[i * r + j0 + e] = t[k];
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

unsigned grid_for(int64_t rows) {
  return static_cast<unsigned>(rows < (1LL << 30) ? rows : (1LL << 30));
}

// lanes of a row: enough for kAggFloats / V vectors each, a power of two
// up to 32
int agg_lanes(int64_t F, int V) {
  const int64_t q = kAggFloats / V;
  const int64_t per_lane = (F / V + q - 1) / q;
  int G = 1;
  while (G < 32 && G < per_lane) G *= 2;
  return G;
}

template <int V, int G>
cudaError_t launch_agg(bool dw, const float* x, const int32_t* idx,
                       const float* wg, float* out, int64_t n_dst, int r,
                       int64_t F, cudaStream_t stream) {
  constexpr int kGroups = kAggThreads / G;
  // fwd: the column tiles of a row, each a task
  const int64_t tile = static_cast<int64_t>(G) * (kAggFloats / V);
  const int T = dw ? 1 : static_cast<int>((F / V + tile - 1) / tile);
  const int64_t blocks = (n_dst * T + kGroups - 1) / kGroups;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (dw) {
    bwd_dw_kernel<V, G><<<grid, kAggThreads, 0, stream>>>(x, idx, wg, out,
                                                          n_dst, r, F);
  } else {
    fwd_kernel<V, G><<<grid, kAggThreads, 0, stream>>>(x, idx, wg, out,
                                                       n_dst, r, F, T);
  }
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_agg_v(bool dw, const float* x, const int32_t* idx,
                         const float* wg, float* out, int64_t n_dst, int r,
                         int64_t F, cudaStream_t stream) {
  switch (agg_lanes(F, V)) {
    case 1: return launch_agg<V, 1>(dw, x, idx, wg, out, n_dst, r, F, stream);
    case 2: return launch_agg<V, 2>(dw, x, idx, wg, out, n_dst, r, F, stream);
    case 4: return launch_agg<V, 4>(dw, x, idx, wg, out, n_dst, r, F, stream);
    case 8: return launch_agg<V, 8>(dw, x, idx, wg, out, n_dst, r, F, stream);
    case 16:
      return launch_agg<V, 16>(dw, x, idx, wg, out, n_dst, r, F, stream);
    default:
      return launch_agg<V, 32>(dw, x, idx, wg, out, n_dst, r, F, stream);
  }
}

// one launch of fwd_kernel (dw false: wg is w, out is (n_dst, F)) or of
// bwd_dw_kernel (wg is g, out is dw (n_dst, r))
cudaError_t launch_agg_any(bool dw, const float* x, const int32_t* idx,
                           const float* wg, float* out, int64_t n_dst,
                           int64_t r, int64_t F, cudaStream_t stream) {
  const int V = vec_width(F, x, dw ? static_cast<const void*>(wg)
                                   : static_cast<const void*>(out));
  const int ri = static_cast<int>(r);
  return V == 4   ? launch_agg_v<4>(dw, x, idx, wg, out, n_dst, ri, F, stream)
         : V == 2 ? launch_agg_v<2>(dw, x, idx, wg, out, n_dst, ri, F, stream)
                  : launch_agg_v<1>(dw, x, idx, wg, out, n_dst, ri, F, stream);
}

// ---------------------------------------------------------------------------
// gather_agg_bwd_dx
// ---------------------------------------------------------------------------
constexpr int kChunk = 64;      // longest run one group sums whole; window
constexpr int kQT = 2;          // vectors of a row each lane holds per tile
constexpr int kDxThreads = 256;
constexpr int kDxBlocks = 4;    // resident blocks per SM the kernels target
constexpr int64_t kCoopEdges = 1 << 14;  // most edges of a call that runs
                                        // as one cooperative launch
constexpr int kWalkRows = 8;    // most rows one group walks: the sorted
                                // path's (its binary searches amortise
                                // over them); a plan's runs are longer and
                                // unevener, so its groups walk 2, and a
                                // whole warp's 1

struct DxArgs {
  const float* g;          // (rows of the call, F) cotangent
  const int32_t* keys;     // (E,) non-decreasing base source row per edge
  const int32_t* order;    // (E,) flat edge id per sorted position; null:
                           //   the identity (the index is the keys)
  const int32_t* row_ptr;  // (n + 1,) run offsets; null: binary search
  const float* w;          // (rows of the call, r) weights; null: all 1
  float* dx;               // (n * H, F)
  float* partial;          // (2 * n_win * H, F) pieces of the long runs
  int64_t n;               // base source rows
  int64_t E;               // base edges
  int64_t r;               // edges per destination row of the call
  int64_t F;
  int64_t n_win;           // windows of kChunk sorted positions
  int H;                   // heads folded into the rows (1: none)
  int rows;                // rows one group walks (<= G, <= kWalkRows)
};

__device__ __forceinline__ int64_t lower_bound(const int32_t* keys,
                                               int64_t E, int64_t s) {
  int64_t lo = 0, hi = E;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// [a, b): the sorted positions of base row s's edges
__device__ __forceinline__ void run_of(const DxArgs& A, int64_t s,
                                       int64_t& a, int64_t& b) {
  if (A.row_ptr != nullptr) {
    a = __ldg(A.row_ptr + s);
    b = __ldg(A.row_ptr + s + 1);
    return;
  }
  // both ends at once: keys < s and keys <= s
  int64_t lo0 = 0, hi0 = A.E, lo1 = 0, hi1 = A.E;
  while (lo0 < hi0 || lo1 < hi1) {
    if (lo0 < hi0) {
      const int64_t m = (lo0 + hi0) >> 1;
      if (__ldg(A.keys + m) < s) lo0 = m + 1; else hi0 = m;
    }
    if (lo1 < hi1) {
      const int64_t m = (lo1 + hi1) >> 1;
      if (__ldg(A.keys + m) <= s) lo1 = m + 1; else hi1 = m;
    }
  }
  a = lo0;
  b = lo1;
}

// the destination row of sorted edge e for head h, and its weight (the
// wrapper keeps every edge id and weight index below 2^31)
__device__ __forceinline__ uint32_t edge_dst(const DxArgs& A, int64_t e,
                                             int h, float& wt) {
  const uint32_t f = static_cast<uint32_t>(
      A.order != nullptr ? __ldg(A.order + e) : e);
  const uint32_t r = static_cast<uint32_t>(A.r);
  const uint32_t i = f / r;
  const uint32_t d = i * static_cast<uint32_t>(A.H) + h;
  wt = A.w != nullptr ? __ldg(A.w + (d * r + (f - i * r))) : 1.0f;
  return d;
}

// edges per batch whose rows a lane loads before adding: 2 rows of 8
// floats, or 4 of fewer, which keeps a thread within 64 registers
template <int V>
__host__ __device__ constexpr int edge_batch() {
  return V * kQT >= 8 ? 2 : 4;
}

// out[:] = sum over sorted edges [a, b) of w_e * g[dst_e], in order from
// 0; lane gl of a group of G lanes owns vectors gl, gl + G, ...
template <int V, int G>
__device__ __forceinline__ void sum_edges(const DxArgs& A, int64_t a,
                                          int64_t b, int h,
                                          float* __restrict__ out, int gl) {
  constexpr int U = edge_batch<V>();
  const int64_t n_vec = A.F / V;
  for (int64_t c0 = gl; c0 < n_vec; c0 += G * kQT) {
    float acc[kQT][V];
#pragma unroll
    for (int q = 0; q < kQT; ++q)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[q][k] = 0.0f;
    for (int64_t e0 = a; e0 < b; e0 += U) {
      const int m = static_cast<int>(b - e0 < U ? b - e0 : U);
      uint32_t d[U];
      float wt[U];
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (k < m) d[k] = edge_dst(A, e0 + k, h, wt[k]);
      float x[U][kQT][V];
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int q = 0; q < kQT; ++q)
          if (k < m && c0 + q * G < n_vec)
            load_vec<V>(A.g + static_cast<int64_t>(d[k]) * A.F +
                            (c0 + q * G) * V, x[k][q]);
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int q = 0; q < kQT; ++q)
          if (k < m && c0 + q * G < n_vec) axpy<V>(acc[q], wt[k], x[k][q]);
    }
#pragma unroll
    for (int q = 0; q < kQT; ++q)
      if (c0 + q * G < n_vec) store_vec<V>(out + (c0 + q * G) * V, acc[q]);
  }
}

// out[:] = sum in order of the scratch rows slot(0), ..., slot(cnt - 1)
template <int V, int G, class Slot>
__device__ __forceinline__ void sum_slots(const DxArgs& A, int64_t cnt,
                                          Slot slot, float* out, int gl) {
  constexpr int U = edge_batch<V>();
  const int64_t n_vec = A.F / V;
  for (int64_t c0 = gl; c0 < n_vec; c0 += G * kQT) {
    float acc[kQT][V];
#pragma unroll
    for (int q = 0; q < kQT; ++q)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[q][k] = 0.0f;
    for (int64_t k0 = 0; k0 < cnt; k0 += U) {
      const int m = static_cast<int>(cnt - k0 < U ? cnt - k0 : U);
      float x[U][kQT][V];
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int q = 0; q < kQT; ++q)
          if (k < m && c0 + q * G < n_vec)
            load_vec<V>(A.partial + slot(k0 + k) * A.F + (c0 + q * G) * V,
                        x[k][q]);
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int q = 0; q < kQT; ++q)
          if (k < m && c0 + q * G < n_vec)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[q][v] = __fadd_rn(acc[q][v], x[k][q][v]);
    }
#pragma unroll
    for (int q = 0; q < kQT; ++q)
      if (c0 + q * G < n_vec) store_vec<V>(out + (c0 + q * G) * V, acc[q]);
  }
}

// task q = (window t, side, head h) of the long runs: side 0 is the run
// holding the window's first position, side 1 the run holding its last
// one when that is another run. True if that run is long (> kChunk edges).
struct Piece {
  int64_t s, a, b, t;
  int h;
};

__device__ __forceinline__ bool piece_of(const DxArgs& A, int64_t q,
                                         Piece& P) {
  P.h = static_cast<int>(q % A.H);
  const int64_t ts = q / A.H;
  P.t = ts >> 1;
  const int64_t p0 = P.t * kChunk;
  const int64_t p1 = p0 + kChunk < A.E ? p0 + kChunk : A.E;
  const int64_t s0 = __ldg(A.keys + p0);
  P.s = s0;
  if (ts & 1) {
    P.s = __ldg(A.keys + p1 - 1);
    if (P.s == s0) return false;
  }
  run_of(A, P.s, P.a, P.b);
  return P.b - P.a > kChunk;
}

// the scratch row of run [a, b)'s piece in window u (its first window's
// piece is side 1 when the run starts inside that window)
__device__ __forceinline__ int64_t slot_of(const DxArgs& A, const Piece& P,
                                           int64_t u) {
  return (2 * u + (P.a > u * kChunk ? 1 : 0)) * A.H + P.h;
}

// rows [s0, s0 + A.rows) of head h, one group: lane j holds row s0 + j's
// run.
// The group walks the span of those rows' edges (contiguous in sorted
// order) in batches of U edges that cross row boundaries, so that many
// rows' loads are in flight at once; each short row (at most kChunk
// edges) is summed from 0 in order and stored, empty rows as zeros; a
// long row's run is skipped (its pieces' sum writes it).
template <int V, int G>
__device__ __forceinline__ void walk_rows(const DxArgs& A, int64_t s0,
                                          int h, int gl, unsigned gmask) {
  constexpr int U = edge_batch<V>();
  const int64_t n_vec = A.F / V;
  const int nrows = static_cast<int>(A.n - s0 < A.rows ? A.n - s0 : A.rows);
  int64_t a_l = 0, b_l = 0;
  if (gl < nrows) run_of(A, s0 + gl, a_l, b_l);
  const unsigned long_rows =
      (__ballot_sync(gmask, gl < nrows && b_l - a_l > kChunk) & gmask) >>
      (threadIdx.x & 31 & ~(G - 1));
  // every lane of the group takes every tile (the shuffles need them all)
  for (int64_t tile = 0; tile < n_vec; tile += G * kQT) {
    const int64_t c0 = tile + gl;
    float acc[kQT][V];
#pragma unroll
    for (int q = 0; q < kQT; ++q)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[q][k] = 0.0f;
    int j = 0;                                  // the row being summed
    int64_t e = __shfl_sync(gmask, a_l, 0, G);  // the next edge
    int64_t bj = __shfl_sync(gmask, b_l, 0, G); // the end of row j's run
    // store row j (and the empty rows after it) up to the row holding e
    auto flush = [&](int64_t upto) {
      while (j < nrows && ((long_rows >> j) & 1 || upto >= bj)) {
        if (!((long_rows >> j) & 1)) {
          float* out = A.dx + ((s0 + j) * A.H + h) * A.F;
#pragma unroll
          for (int q = 0; q < kQT; ++q) {
            if (c0 + q * G < n_vec)
              store_vec<V>(out + (c0 + q * G) * V, acc[q]);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[q][k] = 0.0f;
          }
        } else {
          e = upto = bj;                        // skip the long run
        }
        if (++j < nrows) bj = __shfl_sync(gmask, b_l, j, G);
      }
    };
    for (;;) {
      flush(e);
      if (j >= nrows) break;
      // the batch stays before the next long row's run
      const unsigned later = long_rows >> j;
      const int64_t lim =
          later ? __shfl_sync(gmask, a_l, j + __ffs(later) - 1, G)
                : __shfl_sync(gmask, b_l, nrows - 1, G);
      const int m = static_cast<int>(lim - e < U ? lim - e : U);
      uint32_t d[U];
      float wt[U];
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (k < m) d[k] = edge_dst(A, e + k, h, wt[k]);
      float x[U][kQT][V];
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int q = 0; q < kQT; ++q)
          if (k < m && c0 + q * G < n_vec)
            load_vec<V>(A.g + static_cast<int64_t>(d[k]) * A.F +
                            (c0 + q * G) * V, x[k][q]);
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (k < m) {
          flush(e + k);                         // rows ending before it
#pragma unroll
          for (int q = 0; q < kQT; ++q)
            if (c0 + q * G < n_vec) axpy<V>(acc[q], wt[k], x[k][q]);
        }
      }
      e += m;
    }
  }
}

// a piece of a long run (task q = (window, side, head)): its edges in this
// window, summed into its scratch slot
template <int V, int G>
__device__ __forceinline__ void piece_task(const DxArgs& A, int64_t q,
                                           int gl) {
  Piece P;
  if (!piece_of(A, q, P)) return;
  const int64_t p0 = P.t * kChunk;
  const int64_t p1 = p0 + kChunk;
  sum_edges<V, G>(A, P.a > p0 ? P.a : p0, P.b < p1 ? P.b : p1, P.h,
                  A.partial + q * A.F, gl);
}

// task = (base rows [t * R, t * R + R), head h): the heads of the same
// rows sit in neighbouring groups, whose g rows are neighbours too
template <int V, int G>
__device__ __forceinline__ void row_task(const DxArgs& A, int64_t task,
                                         int gl) {
  const int64_t t = task / A.H;
  walk_rows<V, G>(A, t * A.rows, static_cast<int>(task - t * A.H), gl,
                  group_mask<G>());
}

// the long runs' pieces, summed in window order. Level 1: the task of
// every kChunk-th window of a run sums the pieces of its kChunk windows,
// into dx if that is the whole run, else into its own first slot (read
// only by this task). Level 2: a run of more than kChunk windows sums
// those group sums in order into dx.
template <int V, int G>
__device__ __forceinline__ void combine_task(const DxArgs& A, int64_t q,
                                             int level, int gl) {
  Piece P;
  if (!piece_of(A, q, P)) return;
  const int64_t t0 = P.a / kChunk;
  const int64_t n_win = (P.b - 1) / kChunk - t0 + 1;
  float* row = A.dx + (P.s * A.H + P.h) * A.F;
  if (level == 1) {
    if ((P.t - t0) % kChunk != 0) return;
    const int64_t cnt = t0 + n_win - P.t < kChunk ? t0 + n_win - P.t
                                                  : kChunk;
    sum_slots<V, G>(A, cnt,
                    [&](int64_t k) { return slot_of(A, P, P.t + k); },
                    n_win <= kChunk ? row : A.partial + q * A.F, gl);
  } else {
    if (P.t != t0 || n_win <= kChunk) return;
    sum_slots<V, G>(
        A, (n_win + kChunk - 1) / kChunk,
        [&](int64_t k) { return slot_of(A, P, t0 + k * kChunk); }, row,
        gl);
  }
}

// the caller's promise on the sorted path: keys non-decreasing and within
// [0, n); a violation traps
__device__ __forceinline__ void check_sorted(const DxArgs& A, int64_t tid,
                                             int64_t threads) {
  for (int64_t p = tid; p + 1 < A.E; p += threads)
    if (__ldg(A.keys + p) > __ldg(A.keys + p + 1)) __trap();
  if (tid == 0 && A.E > 0 &&
      (__ldg(A.keys) < 0 || __ldg(A.keys + A.E - 1) >= A.n))
    __trap();
}

// The three phases of a call: (1) the pieces of the long runs (first, so
// their longer sums start first), then every row of at most kChunk edges,
// written to dx (empty rows as zeros); (2) and (3) the two levels of the
// pieces' sum. A small call (tasks that fit on the card at once, at most
// kCoopEdges edges), whose time is the host's, runs them as one
// cooperative launch, the phases split by grid-wide barriers, so that it
// costs the host one launch; a larger one as three launches, whose blocks
// the hardware schedules as they free up (it balances the uneven rows and
// the long runs' chains better than one kernel holding every phase).
template <int V, int G>
__global__ void __launch_bounds__(kDxThreads, kDxBlocks)
bwd_dx_kernel(DxArgs A, int64_t piece_tasks, int64_t row_tasks) {
  constexpr int kGroups = kDxThreads / G;
  const int gl = threadIdx.x % G;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kGroups +
                        threadIdx.x / G;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGroups;
  if (A.row_ptr == nullptr) {
    check_sorted(A, static_cast<int64_t>(blockIdx.x) * kDxThreads +
                        threadIdx.x,
                 static_cast<int64_t>(gridDim.x) * kDxThreads);
  }
  for (int64_t t = first; t < piece_tasks + row_tasks; t += stride) {
    if (t < piece_tasks) {
      piece_task<V, G>(A, t, gl);
    } else {
      row_task<V, G>(A, t - piece_tasks, gl);
    }
  }
  if (piece_tasks == 0) return;                 // the same in every block
  for (int level = 1; level <= 2; ++level) {
    cg::this_grid().sync();
    for (int64_t t = first; t < piece_tasks; t += stride)
      combine_task<V, G>(A, t, level, gl);
  }
}

// the same phases as three launches: phase 1 (a task per group) ...
template <int V, int G>
__global__ void __launch_bounds__(kDxThreads, kDxBlocks)
bwd_dx_rows_kernel(DxArgs A, int64_t piece_tasks, int64_t row_tasks) {
  constexpr int kGroups = kDxThreads / G;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kGroups +
                    threadIdx.x / G;
  if (A.row_ptr == nullptr)
    check_sorted(A, static_cast<int64_t>(blockIdx.x) * kDxThreads +
                        threadIdx.x,
                 static_cast<int64_t>(gridDim.x) * kDxThreads);
  if (t < piece_tasks) {
    piece_task<V, G>(A, t, threadIdx.x % G);
  } else if (t < piece_tasks + row_tasks) {
    row_task<V, G>(A, t - piece_tasks, threadIdx.x % G);
  }
}

// ... and phases 2 and 3
template <int V, int G>
__global__ void __launch_bounds__(kDxThreads, kDxBlocks)
bwd_dx_combine_kernel(DxArgs A, int64_t piece_tasks, int level) {
  constexpr int kGroups = kDxThreads / G;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kGroups +
                    threadIdx.x / G;
  if (t < piece_tasks) combine_task<V, G>(A, t, level, threadIdx.x % G);
}

// a plan's values to sort: the edge ids 0 .. E-1; traps on a key outside
// [0, n), which the radix sort (of the key's low bits only) would misplace
__global__ void bwd_dx_iota_kernel(const int32_t* __restrict__ idx,
                                   int64_t E, int64_t n,
                                   int32_t* __restrict__ ids) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < E; e += stride) {
    const int32_t k = __ldg(idx + e);
    if (k < 0 || k >= n) __trap();
    ids[e] = static_cast<int32_t>(e);
  }
}

// a plan's run offsets: row_ptr[s] = the first sorted position whose key
// is >= s, for s in [0, n]
__global__ void bwd_dx_plan_kernel(const int32_t* __restrict__ keys,
                                   int64_t E, int32_t* __restrict__ row_ptr,
                                   int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       s <= n; s += stride)
    row_ptr[s] = static_cast<int32_t>(lower_bound(keys, E, s));
}

// blocks of bwd_dx_kernel<V, G> that fit on the card at once, by device
template <int V, int G>
int coresident_blocks() {
  static int blocks[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (blocks[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, bwd_dx_kernel<V, G>, kDxThreads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    blocks[dev] = per_sm * sms;
  }
  return blocks[dev];
}

template <int V, int G>
cudaError_t launch_dx(DxArgs A, cudaStream_t stream) {
  constexpr int kGroups = kDxThreads / G;
  int64_t piece_tasks = 2 * A.n_win * A.H;
  int64_t row_tasks = (A.n + A.rows - 1) / A.rows * A.H;
  const int64_t want = (piece_tasks + row_tasks + kGroups - 1) / kGroups;
  const int most = coresident_blocks<V, G>();
  if (most <= 0) return cudaErrorInvalidConfiguration;
  if (want <= most && A.E <= kCoopEdges) {
    void* args[] = {&A, &piece_tasks, &row_tasks};
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(bwd_dx_kernel<V, G>),
        dim3(static_cast<unsigned>(want)), dim3(kDxThreads), args, 0,
        stream);
  }
  bwd_dx_rows_kernel<V, G><<<static_cast<unsigned>(want), kDxThreads, 0,
                             stream>>>(A, piece_tasks, row_tasks);
  const int64_t piece_blocks = (piece_tasks + kGroups - 1) / kGroups;
  if (piece_blocks > 0) {
    for (int level = 1; level <= 2; ++level)
      bwd_dx_combine_kernel<V, G><<<static_cast<unsigned>(piece_blocks),
                                    kDxThreads, 0, stream>>>(
          A, piece_tasks, level);
  }
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_dx_v(const DxArgs& A, int G, cudaStream_t stream) {
  switch (G) {
    case 1: return launch_dx<V, 1>(A, stream);
    case 2: return launch_dx<V, 2>(A, stream);
    case 4: return launch_dx<V, 4>(A, stream);
    case 8: return launch_dx<V, 8>(A, stream);
    case 16: return launch_dx<V, 16>(A, stream);
    default: return launch_dx<V, 32>(A, stream);
  }
}
}  // namespace

extern "C" int gather_agg_fwd(const float* x, const int32_t* idx,
                              const float* w, float* out, int64_t n_dst,
                              int64_t r, int64_t F, cudaStream_t stream) {
  if (n_dst == 0 || F == 0) return 0;
  return static_cast<int>(
      launch_agg_any(false, x, idx, w, out, n_dst, r, F, stream));
}

// The plan of an index: its keys stably sorted with the edge ids beside
// them (CUB's LSD radix sort, over the `bits` low bits that [0, n) needs:
// the sort torch.sort calls, without its passes over bits that are all
// zero), then each row's run offsets. `temp` holds `temp_bytes`, the size
// gather_agg_bwd_dx_plan_bytes returns for E; `ids` is scratch of E.
extern "C" int64_t gather_agg_bwd_dx_plan_bytes(int64_t E) {
  size_t bytes = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, bytes,
                                  static_cast<const int32_t*>(nullptr),
                                  static_cast<int32_t*>(nullptr),
                                  static_cast<const int32_t*>(nullptr),
                                  static_cast<int32_t*>(nullptr),
                                  static_cast<int>(E));
  return static_cast<int64_t>(bytes);
}

extern "C" int gather_agg_bwd_dx_plan(const int32_t* idx, int32_t* keys,
                                      int32_t* order, int32_t* row_ptr,
                                      int32_t* ids, void* temp,
                                      int64_t temp_bytes, int64_t E,
                                      int64_t n, int64_t bits,
                                      cudaStream_t stream) {
  if (E > 0) {
    bwd_dx_iota_kernel<<<grid_for((E + kDxThreads - 1) / kDxThreads),
                         kDxThreads, 0, stream>>>(idx, E, n, ids);
    size_t bytes = static_cast<size_t>(temp_bytes);
    const cudaError_t rc = cub::DeviceRadixSort::SortPairs(
        temp, bytes, idx, keys, ids, order, static_cast<int>(E), 0,
        static_cast<int>(bits), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  bwd_dx_plan_kernel<<<grid_for((n + 1 + kDxThreads - 1) / kDxThreads),
                       kDxThreads, 0, stream>>>(keys, E, row_ptr, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_agg_bwd_dx(const float* g, const int32_t* keys,
                                 const int32_t* order,
                                 const int32_t* row_ptr, const float* w,
                                 float* dx, float* partial, int64_t n,
                                 int64_t E, int64_t r, int64_t H, int64_t F,
                                 cudaStream_t stream) {
  if (n == 0 || F == 0) return 0;
  DxArgs A{g, keys, order, row_ptr, w, dx, partial, n, E, r, F,
           (E + kChunk - 1) / kChunk, static_cast<int>(H),
           row_ptr == nullptr ? kWalkRows : 2};
  const int Vg = vec_width(F, g, dx);
  const int Vp = vec_width(F, partial, dx);
  const int V = Vg < Vp ? Vg : Vp;
  // lanes per row: enough for kQT vectors each, a power of two up to 32
  const int64_t per_lane = (F / V + kQT - 1) / kQT;
  int G = 1;
  while (G < 32 && G < per_lane) G *= 2;
  if (A.rows > G) A.rows = G;
  if (row_ptr != nullptr && G == 32) A.rows = 1;
  const cudaError_t rc = V == 4   ? launch_dx_v<4>(A, G, stream)
                         : V == 2 ? launch_dx_v<2>(A, G, stream)
                                  : launch_dx_v<1>(A, G, stream);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

extern "C" int gather_agg_bwd_dw(const float* x, const int32_t* idx,
                                 const float* g, float* dw, int64_t n_dst,
                                 int64_t r, int64_t F, cudaStream_t stream) {
  if (n_dst == 0 || r == 0) return 0;
  return static_cast<int>(
      launch_agg_any(true, x, idx, g, dw, n_dst, r, F, stream));
}
