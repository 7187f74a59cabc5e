// The epoch-boundary CLOCK walk of the dynamic feature cache. Plain C
// interface, loaded with ctypes by repro_torch/kernels/clock_refill/
// kernel.py; built for sm_90a.
//
// It replaces no Pallas kernel: its counterpart is the reference's jitted
// device scan `_refill_jit` (src/repro/featcache/dynamic.py:184), a
// lax.scan over candidates of lax.while_loops over the ring. In plain
// PyTorch that walk is a Python loop with a host read per step. It
// computes, for candidates (cand_ids[k], cand_fs[k]) taken in order (miss
// frequency high to low, ties by node id):
//     f = cand_fs[k]; if f <= 0: stop
//     walk the hand over the ring of C slots, clearing the reference bit of
//     every slot it passes, until a slot with a clear bit and
//     slot_freq < f; after 2C steps with no such slot: stop (every later
//     candidate is colder and fails too)
//     victim v: evict its node (pos[old] = -1), admit the candidate
//     (slot_ids[v] = id, pos[id] = v, slot_freq[v] = f, bit clear),
//     hand = v + 1
// and reports the admitted (slot, node) pairs, their count and the total
// number of walk steps. Every output equals refill_np's
// (src/repro/featcache/dynamic.py:328), slot for slot, including the bits
// a failed pass leaves cleared and the final hand.
//
// What bounds it on an H100: neither bytes nor operations but the chain of
// dependent decisions: each candidate's victim depends on the bits and the
// hand the previous one left. Design: one block of 1024 threads walks the
// whole ring. The reference bit rides in the sign bit of slot_freq
// (frequencies are >= 0) in one word per slot, held in shared memory when
// C words fit in the opt-in shared memory (46,593 slots are 186 KB of
// the 227 KB), else in a global scratch array that stays in L2. For each
// candidate the block tests the walk's steps j = 0, 1, ... in windows of
// 1024, one step a thread: step j looks at slot (hand + j) mod C and
// stops there if slot_freq < f and, in the first rotation (j < C), its bit
// is clear (by the second rotation the walk has cleared every bit). A
// block-wide minimum over the window gives the first stopping step j*;
// the threads of steps before it (first rotation) clear their bits. That
// is the victim, the bits and the hand of the walk that moves one slot at
// a time, in about (j* / 1024 + 1) block steps of three barriers each.
// Thread 0 then updates pos and slot_ids and records the admission. No
// atomics and no data-dependent order: relaunches are bit-identical.
//
// The function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() of the launch (or the error of a failed
// attribute call). *used_smem tells which home the words had.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kBit = static_cast<int32_t>(0x80000000u);
constexpr int32_t kFreq = 0x7fffffff;
constexpr int32_t kNone = 0x7fffffff;       // no stopping step in a window
constexpr size_t kStaticSmem = 1024;        // reduction scratch, rounded up

__global__ void __launch_bounds__(kThreads)
clock_walk_kernel(int32_t* __restrict__ pos, int32_t* __restrict__ slot_ids,
                  int32_t* __restrict__ refbit,
                  int32_t* __restrict__ slot_freq,
                  int32_t* __restrict__ hand_io,
                  const int32_t* __restrict__ cand_ids,
                  const int32_t* __restrict__ cand_fs, int64_t K,
                  int32_t* __restrict__ adm_slots,
                  int32_t* __restrict__ adm_nodes,
                  int32_t* __restrict__ n_adm, int64_t* __restrict__ steps_out,
                  int32_t* __restrict__ gwords, int32_t C, int use_smem) {
  extern __shared__ int32_t smem_words[];
  __shared__ int32_t warp_min[kWarps];
  __shared__ int32_t s_found;
  int32_t* words = use_smem ? smem_words : gwords;
  const int tid = threadIdx.x;
  for (int32_t i = tid; i < C; i += kThreads)
    words[i] = slot_freq[i] | (refbit[i] ? kBit : 0);
  __syncthreads();

  // uniform across the block: every thread keeps the same copies
  int32_t hand = *hand_io;
  int32_t admitted = 0;
  int64_t steps = 0;
  const int32_t two_c = 2 * C;
  for (int64_t k = 0; k < K; ++k) {
    const int32_t f = cand_fs[k];
    if (f <= 0) break;                      // sorted: no candidates left
    int32_t found = kNone;
    for (int32_t base = 0; base < two_c; base += kThreads) {
      const int32_t j = base + tid;
      int32_t h = 0, w = 0, stop_at = kNone;
      if (j < two_c) {
        h = hand + j;                       // < 3C: at most two wraps
        if (h >= C) h -= C;
        if (h >= C) h -= C;
        w = words[h];
        if ((w & kFreq) < f && (j >= C || w >= 0)) stop_at = j;
      }
      const int32_t wmin = __reduce_min_sync(0xffffffffu, stop_at);
      if ((tid & 31) == 0) warp_min[tid >> 5] = wmin;
      __syncthreads();
      if (tid < 32) {
        const int32_t bmin = __reduce_min_sync(0xffffffffu, warp_min[tid]);
        if (tid == 0) s_found = bmin;
      }
      __syncthreads();
      found = s_found;
      // the walk passed every step before `found`: clear those bits (only
      // first-rotation steps hold one; the victim's own slot, passed once
      // in the first rotation when found >= C, thread 0 rewrites below)
      if (j < C && j < found && w < 0 && j + C != found) words[h] = w & kFreq;
      if (found != kNone && tid == 0) {
        int32_t v = hand + found;
        if (v >= C) v -= C;
        if (v >= C) v -= C;
        const int32_t cid = cand_ids[k];
        const int32_t old = slot_ids[v];
        if (old >= 0) pos[old] = -1;
        slot_ids[v] = cid;
        pos[cid] = v;
        words[v] = f;                       // admitted with its bit clear
        adm_slots[admitted] = v;
        adm_nodes[admitted] = cid;
      }
      __syncthreads();
      if (found != kNone) break;
    }
    if (found == kNone) {                   // a full 2C scan, no victim:
      steps += two_c;                       // every bit is clear and the
      break;                                // hand is back where it began
    }
    steps += found;
    hand += found + 1;
    while (hand >= C) hand -= C;
    ++admitted;
  }

  for (int32_t i = tid; i < C; i += kThreads) {
    const int32_t w = words[i];
    slot_freq[i] = w & kFreq;
    refbit[i] = w < 0 ? 1 : 0;
  }
  if (tid == 0) {
    *hand_io = hand;
    *n_adm = admitted;
    *steps_out = steps;
  }
}

}  // namespace

// pos (N,), slot_ids / refbit / slot_freq (C,) and hand (1,) are updated
// in place; cand_ids / cand_fs hold K <= C candidates; adm_slots /
// adm_nodes (K,) receive the admissions, n_adm (1,) their count, steps
// (1,) the walk's steps; words (C,) is scratch for when shared memory is
// too small.
extern "C" int clock_refill_walk(int32_t* pos, int32_t* slot_ids,
                                 int32_t* refbit, int32_t* slot_freq,
                                 int32_t* hand, const int32_t* cand_ids,
                                 const int32_t* cand_fs, int64_t K,
                                 int32_t* adm_slots, int32_t* adm_nodes,
                                 int32_t* n_adm, int64_t* steps,
                                 int32_t* words, int64_t C, int* used_smem,
                                 cudaStream_t stream) {
  *used_smem = 0;
  if (C <= 0 || C > (1 << 29) || K < 0 || K > C)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(C) * sizeof(int32_t);
  const int smem = bytes + kStaticSmem <= static_cast<size_t>(optin);
  const size_t dyn = smem ? bytes : 0;
  err = cudaFuncSetAttribute(clock_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  clock_walk_kernel<<<1, kThreads, dyn, stream>>>(
      pos, slot_ids, refbit, slot_freq, hand, cand_ids, cand_fs, K,
      adm_slots, adm_nodes, n_adm, steps, words, static_cast<int32_t>(C),
      smem);
  *used_smem = smem;
  return static_cast<int>(cudaGetLastError());
}
