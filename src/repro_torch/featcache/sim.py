"""Software-cache simulators (paper §6.5.1/§6.5.2 analogue), copied from
`repro/featcache/sim.py` (pure numpy).

The paper measures a DGL GPU-resident feature cache and MIG-cut L2
capacities; these simulators *model* the dynamic cache instead: they
replay the exact per-batch feature-access streams produced by each policy
through an LRU (or CLOCK) of a given capacity and report miss rates.

`lru_miss_rate` is a vectorized stack-distance implementation: an access is
an LRU hit iff its reuse distance (distinct ids accessed since the previous
access to the same id) is below the capacity, so the whole simulation
reduces to computing reuse distances — done here batch-at-a-time with
numpy (a sorted-positions rank query per batch plus a merge-counting pass
for intra-batch corrections). The per-access `OrderedDict` loop survives
as `_lru_miss_rate_ref`, the loop-equivalence oracle.

The STATIC cache (`repro_torch.featcache.plan.CachePlan`) is not simulated
— the trainer measures it (`gather_cached` hit counters);
`static_miss_rate` replays a host stream against a plan for a cross-check.
`policy_access_stream` replays the port's own numpy batch builder.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Iterator, List

import numpy as np

from repro_torch import sampling
from repro_torch.core import partition
from repro_torch.core import minibatch


# ---------------------------------------------------------------------------
# LRU: vectorized stack-distance simulation
# ---------------------------------------------------------------------------
def _count_prev_greater(p: np.ndarray) -> np.ndarray:
    """c[j] = #{i < j : p[i] > p[j]} — vectorized bottom-up merge counting
    (log(k) numpy passes). `p` must be int64 with values >= -1."""
    n = len(p)
    if n <= 1:
        return np.zeros(n, np.int64)
    m = 1 << (n - 1).bit_length()
    vals = np.full(m, -2, np.int64)             # -2: padding sentinel,
    vals[:n] = p                                # never counts as "greater"
    c = np.zeros(m, np.int64)
    srt = vals.copy()                           # progressively block-sorted
    off = int(vals.max()) + 3                   # per-row key offset (> all)
    s = 1
    while s < m:
        two = srt.reshape(-1, 2 * s)
        left = two[:, :s]                       # sorted ascending
        q = vals.reshape(-1, 2 * s)[:, s:]      # right half, original order
        rows = np.arange(two.shape[0])[:, None]
        lk = (rows * off + (left + 2)).ravel()  # globally sorted keys
        qk = (rows * off + (q + 2)).ravel()
        le = np.searchsorted(lk, qk, side="right") \
            - np.repeat(rows.ravel() * s, s)
        add = s - le                            # left elements > query
        tgt = (rows * 2 * s + s + np.arange(s)[None, :]).ravel()
        c[tgt] += add
        srt = np.sort(two, axis=1).ravel()
        s *= 2
    return c[:n]


def _distinct_chunks(arrays: List[np.ndarray]) -> Iterator[np.ndarray]:
    """Split the stream into maximal runs of DISTINCT ids (per-batch arrays
    are already deduped upstream, so this normally yields one chunk per
    batch; intra-batch duplicates just force extra cuts)."""
    for a in arrays:
        k = len(a)
        if k == 0:
            continue
        order = np.argsort(a, kind="stable")
        sa = a[order]
        prev = np.full(k, -1, np.int64)
        same = sa[1:] == sa[:-1]
        prev[order[1:][same]] = order[:-1][same]
        start = 0
        while start < k:
            dup = np.nonzero(prev[start:] >= start)[0]
            end = start + int(dup.min()) if len(dup) else k
            yield a[start:end]
            start = end


def lru_miss_rate(batches: Iterable[np.ndarray], capacity: int) -> float:
    """batches: per-batch arrays of accessed node ids (already deduped).

    Exactly equivalent to the `OrderedDict` LRU loop
    (`_lru_miss_rate_ref`): access t to id u hits iff the number of
    distinct OTHER ids accessed since u's previous access is < capacity.
    Per distinct-id chunk at stream offset t0, the reuse distance of entry
    j with previous position p_j is

        d_j = #{seen ids with last_pos > p_j}        (rank query, sorted)
            + (j - 1)                                (earlier in-chunk ids,
                                                      all repositioned > p_j)
            - #{i < j : p_i > p_j}                   (...minus the ones the
                                                      rank query counted at
                                                      their OLD position)
    """
    capacity = int(capacity)
    arrays = [np.asarray(b).ravel() for b in batches]
    total = int(sum(len(a) for a in arrays))
    if total == 0:
        return 1.0
    uniq, inv = np.unique(np.concatenate(arrays), return_inverse=True)
    splits = np.cumsum([len(a) for a in arrays])[:-1]
    inv_arrays = np.split(inv.astype(np.int64), splits)
    last_pos = np.full(len(uniq), -1, np.int64)
    hits = 0
    t0 = 0
    for u in _distinct_chunks(inv_arrays):
        k = len(u)
        p = last_pos[u]
        seen = np.sort(last_pos[last_pos >= 0])
        after = len(seen) - np.searchsorted(seen, p, side="right")
        d = after + np.arange(k) - _count_prev_greater(p)
        hits += int(((p >= 0) & (d < capacity)).sum())
        last_pos[u] = t0 + np.arange(k)
        t0 += k
    return 1.0 - hits / total


def _lru_miss_rate_ref(batches: Iterable[np.ndarray],
                       capacity: int) -> float:
    """The original per-access OrderedDict loop — kept as the
    loop-equivalence oracle for the vectorized `lru_miss_rate`."""
    cache: OrderedDict = OrderedDict()
    hits = 0
    total = 0
    for ids in batches:
        for u in np.asarray(ids):
            u = int(u)
            total += 1
            if u in cache:
                cache.move_to_end(u)
                hits += 1
            else:
                cache[u] = True
                if len(cache) > capacity:
                    cache.popitem(last=False)
    return 1.0 - hits / max(total, 1)


# ---------------------------------------------------------------------------
# CLOCK: second-chance approximation of LRU
# ---------------------------------------------------------------------------
CLOCK_TIE_BREAK = """THE CLOCK tie-breaking rule, shared verbatim by the
simulator (`clock_replay` / `clock_miss_rate`) and the on-device epoch
refill (`repro.featcache.dynamic.refill`) so the simulated and measured
caches are the same policy:

  1. victim among equal-priority slots (reference bit CLEAR — at the
     refill, clear AND strictly colder than the candidate): the FIRST
     such slot at or after the hand in cyclic slot order — the hand walk
     clears the bit of every slot it passes and stops at the first
     eligible one; the hand then advances one past the victim.
  2. empty slots fill in ascending slot order before any eviction.
  3. inserted rows start with the reference bit CLEAR; only reuse sets it.
  4. equal-priority CANDIDATES are considered in arrival order: stream
     order in the simulator; ascending node id at the refill (candidates
     there are sorted by miss frequency desc, node id asc — the same
     lexsort rule `plan.select_rows` uses).
  5. candidate vs incumbent at EQUAL frequency (refill only): the
     incumbent stays — admission requires strictly greater frequency."""


def clock_replay(batches: Iterable[np.ndarray], capacity: int):
    """CLOCK (second-chance) replacement: one reference bit per slot, a
    rotating hand that clears bits until it finds a victim. The cheap
    hardware-style stand-in for LRU, and the simulated target of the
    on-device admission loop (the dynamic cache). Tie-breaking
    follows `CLOCK_TIE_BREAK` exactly.

    Returns `(miss_rate, slot_id (C,), refbit (C,), hand, filled)` — the
    final cache state is exposed so tests can pin the tie rule."""
    capacity = int(capacity)
    slot_of = {}                                  # id -> slot
    slot_id = np.full(capacity, -1, np.int64)
    refbit = np.zeros(capacity, bool)
    hand = 0
    filled = 0
    hits = 0
    total = 0
    for ids in batches:
        for u in np.asarray(ids).ravel():
            u = int(u)
            total += 1
            s = slot_of.get(u)
            if s is not None:
                refbit[s] = True
                hits += 1
                continue
            if filled < capacity:
                s = filled                        # rule 2: fill in order
                filled += 1
            else:
                while refbit[hand]:               # rule 1: second chance
                    refbit[hand] = False
                    hand = (hand + 1) % capacity
                s = hand
                del slot_of[int(slot_id[s])]
                hand = (hand + 1) % capacity
            slot_id[s] = u
            slot_of[u] = s
            refbit[s] = False                     # rule 3: insert CLEAR
    return 1.0 - hits / max(total, 1), slot_id, refbit, hand, filled


def clock_miss_rate(batches: Iterable[np.ndarray], capacity: int) -> float:
    """Miss rate of `clock_replay`. NOTE: CLOCK is NOT a stack algorithm —
    unlike LRU it is neither pointwise dominated by LRU nor monotone in
    capacity (Belady-style anomalies exist; tests pin a counterexample).
    It tracks LRU from above on average, which is what fig9/fig10 report."""
    return clock_replay(batches, capacity)[0]


# ---------------------------------------------------------------------------
# static plan replay + access streams
# ---------------------------------------------------------------------------
def static_miss_rate(batches: Iterable[np.ndarray],
                     cached_ids: np.ndarray) -> float:
    """Host replay of a static cache (`CachePlan.cached_ids()`): the
    fraction of accesses NOT resident: the host cross-check of the
    measured device counters (`gather_cached`)."""
    cached = np.unique(np.asarray(cached_ids))
    hits = 0
    total = 0
    for ids in batches:
        a = np.asarray(ids).ravel()
        total += len(a)
        hits += int(np.isin(a, cached).sum())
    return 1.0 - hits / max(total, 1)


def policy_access_stream(graph, policy, batch_size, fanouts, n_batches=16,
                         seed=0) -> List[np.ndarray]:
    """Unique input-node ids per batch under `policy` (numpy builder),
    sampled through the policy's bound sampler. The shared `ctx` spans the
    whole stream, so LABOR's per-epoch ranks persist across batches — the
    cross-batch repetition is exactly what an LRU cache rewards."""
    rng = np.random.default_rng((seed, 0))  # salt 0: legacy stream slot
    batches = partition.batches_for_epoch(
        graph.train_ids, graph.communities, policy, batch_size, rng)
    sampler = sampling.for_policy(policy)
    ctx = {}
    out = []
    for b in batches[:n_batches]:
        _, level = minibatch.build_batch_np(rng, graph, b, fanouts, sampler,
                                            ctx=ctx)
        out.append(level)
    return out
