"""CLOCK (second-chance) admission for the feature cache, on the device
(`repro/featcache/dynamic.py:73-386`).

A static `CachePlan` freezes admission at plan time. The paper's
cache-locality argument (Figs 9-10) is about the *actual* access
distribution a (policy, sampler) pair produces, which drifts from any
presample — so the simulated CLOCK policy (`featcache.sim`) becomes
trainer-carried mutable state: the cache observes its own hits and
misses on the device and re-admits at epoch boundaries.

State machine of one cache slot across an epoch:

      resident row hit                       epoch-boundary refill
    ┌──────────────────┐                  ┌────────────────────────────┐
    │ reference bit←1  │   hand passes:   │ bit clear & colder than a  │
    │ slot_freq += 1   │   bit 1 → 0,     │ candidate → EVICT; row is  │
    └──────────────────┘   slot survives  │ swapped, bit starts CLEAR  │
      miss on node u       (2nd chance)   └────────────────────────────┘
    ┌──────────────────┐
    │ freq[u] += 1     │  → u becomes an admission candidate
    └──────────────────┘

Per TRAIN batch (no host read): `ref_updates` turns the extended
`gather_cached` counters (`kernels.gather_cached.ops.cache_ref_updates`)
into new reference bits, per-slot hit counts and the per-node
candidate-frequency accumulator; `with_refs` reassembles the state
without copying the `(C, F)` rows. Evaluation reads through the cache but
never feeds the counters.

At each epoch boundary `refill` runs a FREQUENCY-GATED CLOCK pass
(`kernels.clock_refill`): candidates are the missed, non-resident nodes
sorted by miss frequency (desc, node id asc); for each, the hand walks
the ring clearing the reference bit of every slot it passes and skipping
slots that were referenced (the second chance) OR whose occupant's epoch
access count is at least the candidate's. The candidate claims the first
clear, strictly-colder slot; a full scan of 2C steps with none ends the
pass (colder candidates cannot do better). Cache rows are exact copies of
global feature rows, so the loss trajectory does not depend on where the
rows live. The walk is the hand-written CUDA kernel on the card and the
plain loop on the CPU; `refill_np` is the reference's pure-numpy oracle,
copied verbatim, that both must match slot for slot.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.analysis.sync_gate import allowed_sync
from repro_torch.featcache.plan import (CachePlan, as_plan, build_plan,
                                        cache_ref_updates_np)
from repro_torch.kernels.clock_refill.ops import clock_refill
from repro_torch.kernels.gather_cached.ops import cache_ref_updates
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience import faults


@dataclass
class DynamicCacheState:
    """Trainer-carried CLOCK cache state; rides into checkpoints (its
    `DATA_FIELDS`, in the reference's registered order) for bit-exact
    resume. All tensors live on one device.

    cache:     (C, F) float32 — exact copies of the resident feature rows.
    pos:       (N,) int32 — cache slot of node i, or -1 (not resident).
    slot_ids:  (C,) int32 — node id resident in each slot (-1 = empty).
    refbit:    (C,) int32 0/1 — CLOCK reference bits; set by hits, cleared
               only by the hand (they persist across epochs).
    slot_freq: (C,) int32 — per-slot hit counts THIS epoch (refill gate).
    freq:      (N,) int32 — per-node miss counts THIS epoch (candidates).
    hand:      () int32 — the clock hand.
    capacity / policy: metadata; `policy` names the admission that seeded
               the initial residency."""
    cache: torch.Tensor
    pos: torch.Tensor
    slot_ids: torch.Tensor
    refbit: torch.Tensor
    slot_freq: torch.Tensor
    freq: torch.Tensor
    hand: torch.Tensor
    capacity: int
    policy: str

    DATA_FIELDS = ("cache", "pos", "slot_ids", "refbit", "slot_freq",
                   "freq", "hand")

    def cached_ids(self) -> np.ndarray:
        """(<=C,) resident node ids in cache-row order (skips empty slots)."""
        ids = self.slot_ids.cpu().numpy()
        return ids[ids >= 0]

    def to(self, device) -> "DynamicCacheState":
        return replace(self, **{f: getattr(self, f).to(device)
                                for f in self.DATA_FIELDS})

    def describe(self) -> str:
        return f"clock[{self.policy}]@C={self.capacity}"


def from_plan(plan: CachePlan) -> DynamicCacheState:
    """Seed the CLOCK state from a static plan: same residency, all
    reference bits clear, hand at slot 0, zeroed accumulators."""
    pos = plan.pos.cpu().numpy()
    C = int(plan.capacity)
    slot_ids = np.full(C, -1, np.int32)
    ids = np.where(pos >= 0)[0]
    slot_ids[pos[ids]] = ids
    dev = plan.pos.device
    return DynamicCacheState(
        cache=plan.cache,
        pos=plan.pos,
        slot_ids=torch.as_tensor(slot_ids).to(dev),
        refbit=torch.zeros(C, dtype=torch.int32, device=dev),
        slot_freq=torch.zeros(C, dtype=torch.int32, device=dev),
        freq=torch.zeros(pos.shape[0], dtype=torch.int32, device=dev),
        hand=torch.zeros((), dtype=torch.int32, device=dev),
        capacity=C,
        policy=plan.policy,
    )


def as_cache(obj, graph, **kw):
    """Normalize ANY cache spec the trainer and the stream accept: None,
    a `CachePlan` and a `DynamicCacheState` pass through; an admission
    name builds a static plan; `"dynamic"` (or `"dynamic:<admission>"`,
    default admission `presampled_freq`) builds that static plan and
    promotes it to a CLOCK state. `kw` goes to `build_plan`."""
    if obj is None or isinstance(obj, (CachePlan, DynamicCacheState)):
        return obj
    if isinstance(obj, str) and (obj == "dynamic"
                                 or obj.startswith("dynamic:")):
        adm = obj.split(":", 1)[1] if ":" in obj else "presampled_freq"
        return from_plan(build_plan(graph, adm, **kw))
    return as_plan(obj, graph, **kw)


# ---------------------------------------------------------------------------
# per-batch reference-bit / frequency accumulation (every train step)
# ---------------------------------------------------------------------------
def ref_updates(state: DynamicCacheState, ids) -> Tuple:
    """Fold one batch of reads into `(refbit, slot_freq, freq)` on the
    device, with no host read. Returns only the three updated tensors;
    `with_refs` reassembles the state. Mirror: `ref_updates_np`."""
    slot_hits, node_miss = cache_ref_updates(state.pos, ids, state.capacity)
    return (torch.maximum(state.refbit, (slot_hits > 0).to(torch.int32)),
            state.slot_freq + slot_hits,
            state.freq + node_miss)


def with_refs(state: DynamicCacheState, refs) -> DynamicCacheState:
    """Reassemble `ref_updates` output into a new state (same rows)."""
    refbit, slot_freq, freq = refs
    return replace(state, refbit=refbit, slot_freq=slot_freq, freq=freq)


def ref_updates_np(state: Dict[str, np.ndarray], ids) -> Dict[str, np.ndarray]:
    """Numpy mirror of `ref_updates` over a `state_to_np` dict."""
    slot_hits, node_miss = cache_ref_updates_np(
        state["pos"], ids, len(state["slot_ids"]))
    out = dict(state)
    out["refbit"] = np.maximum(state["refbit"],
                               (slot_hits > 0).astype(np.int32))
    out["slot_freq"] = state["slot_freq"] + slot_hits
    out["freq"] = state["freq"] + node_miss
    return out


# ---------------------------------------------------------------------------
# epoch-boundary CLOCK eviction/refill
# ---------------------------------------------------------------------------
def refill(state: DynamicCacheState,
           feats: torch.Tensor) -> Tuple[DynamicCacheState, int]:
    """Epoch-boundary frequency-gated CLOCK eviction/refill.

    Swaps cold slots for hot missed rows (`kernels.clock_refill`): the
    candidates in (miss-frequency desc, node id asc) order each claim the
    first hand-walked slot that is clear AND strictly colder; a
    victimless full scan ends the pass. Rows are copied from `feats` — the
    SAME (N, F) matrix the uncached path reads. The epoch accumulators
    (`slot_freq`, `freq`) reset; reference bits persist (only the hand
    clears them). The input state is not modified. Returns
    `(new_state, admitted)`, `admitted` the refill churn as a host int
    (the refill's one host read).

    Call it outside differentiated code (the trainer refills between
    batches at epoch boundaries). Oracle: `refill_np`."""
    with obs_trace.span("clock_refill", cat="cache"):
        cache, walk, admitted = clock_refill(
            state.cache, state.pos, state.slot_ids, state.refbit,
            state.slot_freq, state.freq, state.hand, feats)
    new_state = replace(
        state, cache=cache, pos=walk.pos, slot_ids=walk.slot_ids,
        refbit=walk.refbit,
        slot_freq=torch.zeros_like(walk.slot_freq),  # next epoch's counters
        freq=torch.zeros_like(state.freq),
        hand=walk.hand)
    spec = faults.fire("cache_corrupt")
    if spec is not None:
        # chaos site (repro_torch.resilience): hand back a state whose
        # residency invariants are violated — the trainer's
        # `integrity_ok` check at this very boundary must catch it and
        # degrade to the uncached gather BEFORE any read goes through
        # the bad position map
        new_state = _corrupt_state(new_state,
                                   faults.active().payload_rng(spec))
    return new_state, admitted


def _corrupt_state(state: DynamicCacheState,
                   rng: np.random.Generator) -> DynamicCacheState:
    """Deterministic residency scramble (the `cache_corrupt` payload):
    point one extra node at an already-claimed slot, so the pos->slot
    map stops being a bijection and `integrity_ok` must fail."""
    pos = state.pos.cpu().numpy().copy()
    res = np.where(pos >= 0)[0]
    non = np.where(pos < 0)[0]
    if len(res) and len(non):
        pos[non[int(rng.integers(len(non)))]] = \
            pos[res[int(rng.integers(len(res)))]]
    elif len(res) >= 2:                 # full residency: cross two entries
        a, b = res[rng.permutation(len(res))[:2]]
        pos[a] = pos[b]
    else:
        return state                    # nothing corruptible (C ~ 0)
    return replace(state, pos=torch.as_tensor(pos).to(state.pos.device))


def integrity_ok(state: DynamicCacheState) -> bool:
    """Cheap residency-invariant check (one O(N + C) pass on the device,
    one bool read on the host): the slot_ids<->pos maps must be a
    bijection over the resident rows, pos values in range, reference bits
    boolean. The trainer runs this at every epoch-boundary refill — the
    one point residency changes — and degrades to the uncached gather on
    failure (cache rows are bit-copies, so dropping the cache never
    perturbs the loss trajectory)."""
    C = state.capacity
    N = state.pos.shape[0]
    slots = torch.arange(C, dtype=torch.int32, device=state.pos.device)
    resident = state.slot_ids >= 0
    # every resident slot's occupant must map straight back to it ...
    occ = torch.clamp(state.slot_ids, 0, N - 1).long()
    ok = torch.where(resident, state.pos[occ] == slots, True).all()
    # ... and be the ONLY claimant: resident pos entries == resident slots
    ok &= (state.pos >= 0).sum() == resident.sum()
    ok &= ((state.pos >= -1) & (state.pos < C)).all()
    ok &= ((state.refbit == 0) | (state.refbit == 1)).all()
    with allowed_sync("integrity"):
        return bool(ok)


def refill_np(state: Dict[str, np.ndarray],
              feats: np.ndarray) -> Tuple[Dict[str, np.ndarray], int]:
    """Pure-numpy CLOCK refill — THE oracle `refill` must match
    slot-for-slot: residency, cache rows, reference bits (including the
    ones a failed pass leaves cleared), accumulator resets, and the final
    hand position. Operates on a `state_to_np` dict; returns
    `(new_state_dict, admitted)`."""
    cache = state["cache"].copy()
    pos = state["pos"].copy()
    slot_ids = state["slot_ids"].copy()
    refbit = state["refbit"].copy()
    slot_freq = state["slot_freq"].copy()
    freq = state["freq"]
    hand = int(state["hand"])
    C = len(slot_ids)
    cand_freq = np.where(pos < 0, freq, 0)
    order = np.lexsort((np.arange(len(freq)), -cand_freq))[:C]
    admitted = 0
    feats = np.asarray(feats)
    for cand in order:
        f = int(cand_freq[cand])
        if f <= 0:
            break                       # sorted desc: no candidates left
        steps = 0                       # frequency-gated second-chance walk
        while steps < 2 * C and (refbit[hand] > 0
                                 or int(slot_freq[hand]) >= f):
            refbit[hand] = 0
            hand = (hand + 1) % C
            steps += 1
        if steps >= 2 * C:
            break                       # every slot at least as hot: every
            # later (colder) candidate fails too
        v = hand
        old = int(slot_ids[v])
        if old >= 0:
            pos[old] = -1
        slot_ids[v] = cand
        pos[cand] = v
        cache[v] = feats[cand].astype(cache.dtype)
        slot_freq[v] = f
        refbit[v] = 0                   # insert CLEAR
        hand = (v + 1) % C
        admitted += 1
    out = dict(state)
    out.update(cache=cache, pos=pos, slot_ids=slot_ids, refbit=refbit,
               slot_freq=np.zeros_like(slot_freq),
               freq=np.zeros_like(freq),
               hand=np.asarray(hand, np.int32))
    return out, admitted


def state_to_np(state: DynamicCacheState) -> Dict[str, np.ndarray]:
    """Materialize the device state as a dict of numpy arrays (the mirror
    functions' representation; also handy for test equality checks)."""
    return {f: getattr(state, f).cpu().numpy()
            for f in DynamicCacheState.DATA_FIELDS}
