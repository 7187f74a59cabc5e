// The epoch-boundary CLOCK walk of the dynamic feature cache. Plain C
// interface, loaded with ctypes by repro_torch/kernels/clock_refill/
// kernel.py; built for sm_90a.
//
// It replaces no Pallas kernel: its counterpart is the reference's jitted
// device scan `_refill_jit` (src/repro/featcache/dynamic.py:185), a
// lax.scan over candidates of lax.while_loops over the ring. It computes,
// for candidates (cand_ids[k], cand_fs[k]) taken in order (miss frequency
// high to low, ties by node id):
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
// decisions, each candidate's victim depending on where the previous one
// stopped. The design shortens that chain. Number the hand's moves as
// visits p = 0, 1, ... of slot (hand + p) mod C. Candidates come sorted, so
// an admitted slot holds f_k >= every later f and is never a victim again;
// visit p is therefore the current candidate's victim exactly when its
// slot was not admitted in this refill, p >= C or its ORIGINAL bit is
// clear, and its original slot_freq is below f. Everything else follows
// from the list of victim visits. Three stages, five launches, one C call:
//
// 1. Prepare, grid-wide: pack slot_freq and the bit into one word a slot
//    (the bit in the sign: frequencies are >= 0); find the runs of equal
//    candidate frequency (flags, a count per block, one block's scan of the
//    counts, then each run's f and end). Traps on frequencies that are not
//    sorted high to low.
// 2. Walk, one warp: a window of W = min(256, C) visits (so it never
//    holds a slot twice), lane i testing visits p + i, p + 32 + i, ... at
//    the current run's f; eight ballots give the eligible visits and the
//    run's next candidates take them lowest first (rank = the eligible
//    visits before it, by popc). A run that ends inside the window leaves
//    the visits after its last victim to be tested again at the next run's
//    f. The 2C stop is exact: only the window's first candidate can reach
//    its limit inside it. The run table reaches the warp 32 runs a load,
//    the next 32 already in flight. The ring's words live in shared
//    memory ("resident") when C words fit in the opt-in shared memory
//    (46,593 slots are 186 KB of the 227 KB); past that they stream
//    through a shared ring of 64 chunks of 32 visits filled by cp.async
//    ("streamed"), and an admission writes its word back to global memory,
//    which the ring reads again C > 4,096 visits later. Only the victim
//    slots, their count, the visit count V and the warp's rounds (windows
//    decided) come out.
// 3. Apply, grid-wide: the first min(V, C) slots from the old hand lose
//    their bit; admission k evicts slot v's node and puts candidate k there
//    (every slot is admitted at most once and every candidate is
//    non-resident, so no two admissions write one entry); then hand,
//    n_adm and steps = V - n_adm.
//
// No atomics and no data-dependent order: relaunches are bit-identical.
// The function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launches (or the error of a failed
// attribute call). *resident tells which home the words had
// (clock_refill_home); clock_refill_window gives the window's width.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;                 // prepare blocks (32 warps)
constexpr int kApply = 256;
constexpr int32_t kBit = static_cast<int32_t>(0x80000000u);
constexpr int32_t kFreq = 0x7fffffff;
constexpr int kSub = 8;                      // sub-windows of 32 visits
constexpr int kWin = 32 * kSub;              // visits a window decides
constexpr int kStages = 64;                  // streamed: chunks in flight
constexpr int kRing = kStages * 32;          // streamed: words in the ring
constexpr size_t kReserve = 1024;            // kept free of the opt-in
constexpr int kMeta = 4;                     // runs, old hand

int64_t blocks_of(int64_t n) { return (n + kBlock - 1) / kBlock; }

// inclusive scan over a block of kBlock threads; *total gets the sum
__device__ int block_scan(int x, int* total) {
  __shared__ int sums[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  const int out = x + (wid ? sums[wid - 1] : 0);
  *total = sums[31];
  __syncthreads();
  return out;
}

// prepare (1): pack the words, copy the old hand, count run starts a block
__global__ void __launch_bounds__(kBlock)
clock_pack_kernel(const int32_t* __restrict__ refbit,
                  const int32_t* __restrict__ slot_freq,
                  const int32_t* __restrict__ hand,
                  const int32_t* __restrict__ cand_fs, int32_t K,
                  int32_t C, int32_t* __restrict__ words,
                  int32_t* __restrict__ blk, int32_t* __restrict__ meta) {
  const int32_t i = blockIdx.x * kBlock + threadIdx.x;
  if (i < C) words[i] = slot_freq[i] | (refbit[i] > 0 ? kBit : 0);
  if (i == 0) meta[1] = *hand;
  if (static_cast<int32_t>(blockIdx.x) * kBlock >= K) return;  // uniform
  int start = 0;
  if (i < K) {
    const int32_t f = cand_fs[i];
    const int32_t prev = i ? cand_fs[i - 1] : kFreq;
    if (f > prev) __trap();                  // not sorted high to low
    start = f > 0 && (i == 0 || f != prev);
  }
  const int n = __syncthreads_count(start);
  if (threadIdx.x == 0) blk[blockIdx.x] = n;
}

// prepare (2), one block: exclusive scan of the counts, meta[0] = runs
__global__ void __launch_bounds__(kBlock)
clock_scan_kernel(int32_t* __restrict__ blk, int32_t nb,
                  int32_t* __restrict__ meta) {
  int carry = 0;
  for (int32_t base = 0; base < nb; base += kBlock) {
    const int32_t i = base + threadIdx.x;
    const int x = i < nb ? blk[i] : 0;
    int total;
    const int incl = block_scan(x, &total);
    if (i < nb) blk[i] = carry + incl - x;
    carry += total;
  }
  if (threadIdx.x == 0) meta[0] = carry;
}

// prepare (3): run r's frequency and end (one past its last candidate)
__global__ void __launch_bounds__(kBlock)
clock_runs_kernel(const int32_t* __restrict__ cand_fs, int32_t K,
                  const int32_t* __restrict__ blk,
                  int32_t* __restrict__ run_f, int32_t* __restrict__ run_end) {
  const int32_t i = blockIdx.x * kBlock + threadIdx.x;
  int32_t f = 0;
  int start = 0, last = 0;
  if (i < K) {
    f = cand_fs[i];
    start = f > 0 && (i == 0 || f != cand_fs[i - 1]);
    last = f > 0 && (i + 1 == K || cand_fs[i + 1] != f);
  }
  int total;
  const int r = block_scan(start, &total) + blk[blockIdx.x] - 1;
  if (start) run_f[r] = f;
  if (last) run_end[r] = i + 1;
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// walk: one warp decides; a resident launch's other warps only load.
// A window holds W = min(kWin, C) visits, lane i the visits at offsets
// o = 32j + i (sub-window j); the eligible ones are taken lowest first.
template <bool kStreamed>
__global__ void __launch_bounds__(kBlock)
clock_walk_kernel(int32_t* __restrict__ words,
                  const int32_t* __restrict__ run_f,
                  const int32_t* __restrict__ run_end,
                  const int32_t* __restrict__ meta, int32_t C,
                  int32_t* __restrict__ adm_slots,
                  int32_t* __restrict__ n_adm,
                  int64_t* __restrict__ steps_out,
                  int64_t* __restrict__ rounds_out) {
  extern __shared__ int32_t sw[];            // resident: C words; else ring
  if (!kStreamed) {
    for (int32_t i = threadIdx.x; i < C; i += blockDim.x) sw[i] = words[i];
    __syncthreads();
    if (threadIdx.x >= 32) return;
  }
  const int lane = threadIdx.x;
  const unsigned below_me = (1u << lane) - 1;
  const int W = C < kWin ? C : kWin;
  const int32_t R = meta[0], hand0 = meta[1];
  const int64_t two_c = 2 * static_cast<int64_t>(C);

  // streamed: chunk c holds visits 32c .. 32c + 31 at ring entries
  // (c mod kStages) * 32 + lane; `issued` chunks are in flight or landed
  int64_t issued = 0;
  int32_t issue_slot = hand0;                // slot of visit 32 * issued
  auto issue = [&]() {
    int32_t s = issue_slot + lane;
    if (s >= C) s -= C;
    cp_async4(&sw[((issued & (kStages - 1)) << 5) + lane], &words[s]);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    ++issued;
    issue_slot += 32;
    if (issue_slot >= C) issue_slot -= C;
  };
  if (kStreamed)
    while (issued < kStages) issue();

  // the run table, 32 runs a load, the next 32 in flight
  int32_t cur_f = 0, cur_end = 0, nxt_f = 0, nxt_end = 0;
  if (lane < R) cur_f = run_f[lane], cur_end = run_end[lane];
  if (lane + 32 < R) nxt_f = run_f[lane + 32], nxt_end = run_end[lane + 32];

  int64_t p = 0, pk = 0;                     // window start; k's first visit
  int32_t s0 = hand0;                        // slot of visit p
  int32_t k = 0;                             // next candidate
  int64_t rounds = 0;                        // windows decided
  bool failed = false;
  for (int32_t r = 0; r < R && !failed; ++r) {
    if (r > 0 && (r & 31) == 0) {
      cur_f = nxt_f, cur_end = nxt_end, nxt_f = 0, nxt_end = 0;
      if (r + 32 + lane < R)
        nxt_f = run_f[r + 32 + lane], nxt_end = run_end[r + 32 + lane];
    }
    const int32_t f = __shfl_sync(0xffffffffu, cur_f, r & 31);
    const int32_t end = __shfl_sync(0xffffffffu, cur_end, r & 31);
    while (k < end) {
      ++rounds;
      if (kStreamed) {
        // the window reads chunks p / 32 .. p / 32 + kSub; a chunk's ring
        // entries are free once the window has passed it
        while (issued < (p >> 5) + kStages) issue();
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - kSub - 1)
                     : "memory");
        __syncwarp();
      }
      // offsets below `first_rot` are in the first rotation (p + o < C),
      // offsets below `lim` in candidate k's 2C visits
      const int64_t rot = C - p, lim64 = pk + two_c - p;
      const int first_rot = rot > W ? W : rot < 0 ? 0 : static_cast<int>(rot);
      const int lim = lim64 > W ? W + 1 : static_cast<int>(lim64);
      int32_t slot[kSub];
      bool elig[kSub];
      unsigned mask[kSub];
      int cnt = 0, base[kSub];
      bool any_in_lim = false;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int o = 32 * j + lane;
        int32_t s = s0 + o;                  // o < W <= C: one wrap at most
        if (s >= C) s -= C;
        slot[j] = s;
        int32_t w = kFreq;                   // a dead lane is never eligible
        if (kStreamed)
          w = sw[static_cast<int>((p + o) & (kRing - 1))];
        else if (o < W)
          w = sw[s];
        elig[j] = o < W && (w & kFreq) < f && (o >= first_rot || w >= 0);
        mask[j] = __ballot_sync(0xffffffffu, elig[j]);
        base[j] = cnt;
        cnt += __popc(mask[j]);
        const int in = lim - 32 * j;
        any_in_lim |= (mask[j] & (in >= 32 ? 0xffffffffu
                                  : in <= 0 ? 0u : (1u << in) - 1)) != 0;
      }
      if (!any_in_lim) {
        if (lim <= W) {                      // 2C visits with no victim
          failed = true;
          break;
        }
        p += W;
        s0 += W;
        if (s0 >= C) s0 -= C;
        continue;
      }
      const int take = min(cnt, end - k);
      int last = 0;                          // offset of the last victim
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int rank = base[j] + __popc(mask[j] & below_me);
        const bool victim = elig[j] && rank < take;
        if (victim) {
          adm_slots[k + rank] = slot[j];
          if (kStreamed)
            words[slot[j]] = f;              // read again C visits later
          else
            sw[slot[j]] = f;
        }
        // sub-window j holds the last victim when its victims end there
        if (base[j] < take && take <= base[j] + __popc(mask[j]))
          last = 32 * j + 31 -
                 __clz(base[j] + __popc(mask[j]) == take
                           ? mask[j] : __ballot_sync(0xffffffffu, victim));
      }
      __syncwarp();                          // orders the words' stores
      k += take;
      pk = p + last + 1;
      const int adv = take == cnt && k < end ? W : last + 1;
      p += adv;
      s0 += adv;
      if (s0 >= C) s0 -= C;
    }
  }
  if (kStreamed) asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (lane == 0) {
    *n_adm = k;
    *steps_out = (failed ? pk + two_c : pk) - k;
    if (rounds_out) *rounds_out = rounds;
  }
}

// apply: bits, then each admission on its own, then the hand
__global__ void __launch_bounds__(kApply)
clock_apply_kernel(int32_t* __restrict__ pos, int32_t* __restrict__ slot_ids,
                   int32_t* __restrict__ refbit,
                   int32_t* __restrict__ slot_freq,
                   int32_t* __restrict__ hand_io,
                   const int32_t* __restrict__ cand_ids,
                   const int32_t* __restrict__ cand_fs,
                   const int32_t* __restrict__ adm_slots,
                   int32_t* __restrict__ adm_nodes,
                   const int32_t* __restrict__ n_adm,
                   const int64_t* __restrict__ steps,
                   const int32_t* __restrict__ meta, int32_t C) {
  const int32_t t = blockIdx.x * kApply + threadIdx.x;
  const int32_t n = *n_adm, hand0 = meta[1];
  const int64_t visits = *steps + n;
  if (t < C) {
    int32_t d = t - hand0;
    if (d < 0) d += C;
    if (d < visits) refbit[t] = 0;
  }
  if (t < n) {
    const int32_t v = adm_slots[t], cid = cand_ids[t];
    const int32_t old = slot_ids[v];
    if (old >= 0) pos[old] = -1;
    pos[cid] = v;
    slot_ids[v] = cid;
    slot_freq[v] = cand_fs[t];
    adm_nodes[t] = cid;
  }
  if (t == 0) *hand_io = static_cast<int32_t>((hand0 + visits % C) % C);
}

}  // namespace

// int32 words of scratch clock_refill_walk takes for C slots and K
// candidates: the packed words, the run table, the block counts, meta.
extern "C" int64_t clock_refill_scratch(int64_t C, int64_t K) {
  return C + 2 * K + blocks_of(K) + kMeta;
}

// The visits a window decides at most (min(it, C) for C slots).
extern "C" int clock_refill_window() { return kWin; }

// 1 when the C words stay resident in the shared memory of a block that
// may opt into `optin` bytes, 0 when they stream through the ring.
extern "C" int clock_refill_home(int64_t C, int64_t optin) {
  return C > 0 && static_cast<size_t>(C) * sizeof(int32_t) + kReserve <=
                      static_cast<size_t>(optin);
}

// pos (N,), slot_ids / refbit / slot_freq (C,) and hand (1,) are updated
// in place; cand_ids / cand_fs hold K <= C candidates; adm_slots /
// adm_nodes (K,) receive the admissions, n_adm (1,) their count, steps
// (1,) the walk's steps; scratch holds clock_refill_scratch(C, K) words;
// rounds (1,) int64, when not null, receives the windows the warp decided.
extern "C" int clock_refill_walk(int32_t* pos, int32_t* slot_ids,
                                 int32_t* refbit, int32_t* slot_freq,
                                 int32_t* hand, const int32_t* cand_ids,
                                 const int32_t* cand_fs, int64_t K,
                                 int32_t* adm_slots, int32_t* adm_nodes,
                                 int32_t* n_adm, int64_t* steps,
                                 int32_t* scratch, int64_t C,
                                 int64_t* rounds, int* resident,
                                 cudaStream_t stream) {
  *resident = 0;
  if (C <= 0 || C > (1 << 29) || K < 0 || K > C)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(C) * sizeof(int32_t);
  const int res = clock_refill_home(C, optin);
  // streamed: a slot's word is fetched again only after its admission C
  // visits earlier was written back (the ring reads at most kRing ahead)
  if (!res && C <= 2 * kRing) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t c32 = static_cast<int32_t>(C), k32 = static_cast<int32_t>(K);
  const int32_t nb = static_cast<int32_t>(blocks_of(K));
  int32_t* words = scratch;
  int32_t* run_f = words + C;
  int32_t* run_end = run_f + K;
  int32_t* blk = run_end + K;
  int32_t* meta = blk + nb;

  clock_pack_kernel<<<static_cast<unsigned>(blocks_of(C)), kBlock, 0,
                      stream>>>(refbit, slot_freq, hand, cand_fs, k32, c32,
                                words, blk, meta);
  clock_scan_kernel<<<1, kBlock, 0, stream>>>(blk, nb, meta);
  if (nb) clock_runs_kernel<<<nb, kBlock, 0, stream>>>(cand_fs, k32, blk,
                                                       run_f, run_end);
  if (res) {
    err = cudaFuncSetAttribute(clock_walk_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    clock_walk_kernel<false><<<1, kBlock, bytes, stream>>>(
        words, run_f, run_end, meta, c32, adm_slots, n_adm, steps, rounds);
  } else {
    clock_walk_kernel<true><<<1, 32, kRing * sizeof(int32_t), stream>>>(
        words, run_f, run_end, meta, c32, adm_slots, n_adm, steps, rounds);
  }
  clock_apply_kernel<<<static_cast<unsigned>((C + kApply - 1) / kApply),
                       kApply, 0, stream>>>(
      pos, slot_ids, refbit, slot_freq, hand, cand_ids, cand_fs, adm_slots,
      adm_nodes, n_adm, steps, meta, c32);
  *resident = res;
  return static_cast<int>(cudaGetLastError());
}
