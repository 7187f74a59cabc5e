// The tile walk of the grouped expert matmul's tensor-core kernels
// (moe_gmm.cu's forward, moe_gmm_bwd.cu's dx): which row tiles of each
// expert hold an occupied row, and the fixed list of (expert, row tile,
// column tile) that persistent blocks walk. kernels/build.py hashes this
// header into every library's name.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace moe_walk {

// any of rows [r0, r1) of expert e occupied? `rows` (E, G) int32: group g
// holds Cg rows, of which the first rows[e, g] are occupied (`rows` null:
// all are)
__device__ __forceinline__ bool rows_occupied(const int* rows, int e, int G,
                                              int Cg, int r0, int r1) {
  if (rows == nullptr) return true;
  for (int g = r0 / Cg; g < G && g * Cg < r1; ++g) {
    const int first = max(r0, g * Cg) - g * Cg;
    if (first < __ldg(rows + static_cast<int64_t>(e) * G + g)) return true;
  }
  return false;
}

// The tile list every block walks: the occupied tiles, expert by expert
// (within an expert column tile nt, then its occupied row tiles), then the
// empty ones in the same order. `occ` picks the part. masks[e] (shared
// memory, built once a block) has bit mt set when row tile mt of expert e
// holds a non-zero row, so the walk reads no global memory.
struct Tiles {
  const uint32_t* masks;
  int E, MT, NT;

  __device__ uint32_t part(int e, bool occ) const {
    const uint32_t all = MT == 32 ? ~0u : (1u << MT) - 1;
    return occ ? masks[e] : ~masks[e] & all;
  }
  __device__ int count(int e, bool occ) const {
    return __popc(part(e, occ));
  }
  __device__ int nth(int e, bool occ, int q) const {   // q-th set bit
    uint32_t m = part(e, occ);
    for (; q > 0; --q) m &= m - 1;
    return __ffs(m) - 1;
  }
};

// a forward-only cursor over one part of the list: tile k (k rising from
// call to call) is expert e's tile k - before
struct Cursor {
  int e = 0, before = 0, here = -1;

  __device__ bool locate(const Tiles& T, bool occ, int k, int& e_out,
                         int& mt, int& nt) {
    for (;;) {
      if (e >= T.E) return false;
      if (here < 0) here = T.count(e, occ) * T.NT;
      if (k < before + here) break;
      before += here;
      here = -1;
      ++e;
    }
    const int j = k - before, om = here / T.NT;
    e_out = e;
    nt = j / om;
    mt = T.nth(e, occ, j % om);
    return true;
  }
};

// the n-th tile of this block: k = n gridDim.x + blockIdx.x of the list;
// false past its end
struct Walk {
  Tiles T;
  int n_occ, n_all;
  Cursor full, empty;

  __device__ bool next(int n, int& e, int& mt, int& nt, bool& occ) {
    const int64_t k64 = static_cast<int64_t>(n) * gridDim.x + blockIdx.x;
    if (k64 >= n_all) return false;
    const int k = static_cast<int>(k64);
    occ = k < n_occ;
    return occ ? full.locate(T, true, k, e, mt, nt)
               : empty.locate(T, false, k - n_occ, e, mt, nt);
  }
};

}  // namespace moe_walk
