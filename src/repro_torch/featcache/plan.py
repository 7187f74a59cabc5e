"""Cache admission planning: which of the N feature rows live on the
device (`repro/featcache/plan.py`).

The paper's cache story (§6.5) is about *reuse*: structure-aware batches
revisit the same feature rows across consecutive mini-batches, so a modest
device-resident cache absorbs much of the feature traffic. `CachePlan` is
the static realization: an admission policy scores every node on the host,
the top-`capacity` rows are copied into a compact `(C, F)` device tensor,
and an `int32[N]` position map (`-1` = miss) routes each feature read
either into the cache or back to the global matrix
(`repro_torch.kernels.gather_cached`).

Admission policies are frozen dataclasses with pure-numpy scoring, exactly
the reference's, so plans are reproducible and equal the reference's row
for row, and the device hit counters can be checked against the numpy
mirror (`cache_stats_np`):

    degree_hot        score = degree (classic static GNN feature cache)
    community_freq    score = training mass of the node's community,
                      degree-weighted (structure-aware: COMM-RAND batches
                      hammer whole communities at a time)
    presampled_freq   score = measured access counts over a presampled
                      epoch prefix of the ACTUAL (policy, sampler) stream
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.featcache.sim import policy_access_stream


@runtime_checkable
class AdmissionPolicy(Protocol):
    """Protocol every registered admission policy satisfies. `scores` is
    host-side numpy: higher score = cached first. Ties break toward lower
    node id (deterministic plans)."""

    @property
    def name(self) -> str: ...

    def scores(self, graph, ctx: dict) -> np.ndarray:
        """(N,) float64 hotness scores. `ctx` may carry the training
        context ({"policy", "batch_size", "fanouts", "seed"}) for policies
        that presample the access stream."""
        ...

    def describe(self) -> str: ...


_REGISTRY: Dict[str, Callable[..., "AdmissionPolicy"]] = {}


def register_admission(name: str):
    """Register an admission-policy factory under `name`."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def make_admission(name: str, **kwargs) -> "AdmissionPolicy":
    if name not in _REGISTRY:
        raise KeyError(f"unknown admission policy {name!r}; "
                       f"registered: {available_admissions()}")
    return _REGISTRY[name](**kwargs)


def available_admissions() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def as_admission(obj) -> "AdmissionPolicy":
    """Normalize an admission name / instance."""
    if isinstance(obj, str):
        return make_admission(obj)
    if hasattr(obj, "scores") and hasattr(obj, "describe"):
        return obj
    raise TypeError(f"not an admission policy: {obj!r}")


# ---------------------------------------------------------------------------
# registered policies
# ---------------------------------------------------------------------------
@register_admission("degree_hot")
@dataclass(frozen=True)
class DegreeHotAdmission:
    """Cache the highest-degree nodes: high-degree rows are sampled as
    neighbors proportionally more often, regardless of batch policy."""

    @property
    def name(self) -> str:
        return "degree_hot"

    def scores(self, graph, ctx: dict) -> np.ndarray:
        return graph.degrees().astype(np.float64)

    def describe(self) -> str:
        return "degree_hot"


@register_admission("community_freq")
@dataclass(frozen=True)
class CommunityFreqAdmission:
    """Cache nodes of training-heavy communities, hottest-degree first.

    Score = (# training roots in the node's community) * (degree + 1):
    community-biased sampling (p -> 1) keeps neighbor expansion inside the
    root's community, so a community's expected access frequency tracks its
    training mass, and within a community the high-degree hubs soak up the
    fanout draws."""

    @property
    def name(self) -> str:
        return "community_freq"

    def scores(self, graph, ctx: dict) -> np.ndarray:
        comm = graph.communities
        n_comm = int(comm.max()) + 1
        mass = np.zeros(n_comm, np.float64)
        np.add.at(mass, comm[graph.train_ids], 1.0)
        return mass[comm] * (graph.degrees().astype(np.float64) + 1.0)

    def describe(self) -> str:
        return "community_freq"


@register_admission("presampled_freq")
@dataclass(frozen=True)
class PresampledFreqAdmission:
    """Cache the empirically hottest rows: replay `n_batches` batches of
    the ACTUAL (policy, sampler) access stream on the host (the same numpy
    builder caps calibration uses) and score nodes by access count. The
    strongest static policy — it sees exactly the distribution the cache
    will serve — at the cost of a presampling pass per plan."""
    n_batches: int = 16

    @property
    def name(self) -> str:
        return "presampled_freq"

    def scores(self, graph, ctx: dict) -> np.ndarray:
        policy = ctx.get("policy")
        if policy is None:
            raise ValueError("presampled_freq admission needs ctx['policy'] "
                             "(the BatchPolicy whose stream it presamples)")
        stream = policy_access_stream(
            graph, policy, ctx.get("batch_size", 512),
            ctx.get("fanouts", (10, 10)), n_batches=self.n_batches,
            seed=ctx.get("seed", 0))
        counts = np.zeros(graph.num_nodes, np.float64)
        for ids in stream:
            np.add.at(counts, np.asarray(ids), 1.0)
        return counts

    def describe(self) -> str:
        return f"presampled_freq(n={self.n_batches})"


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@dataclass
class CachePlan:
    """Device-resident static feature cache.

    cache: (C, F) float32 — exact copies of the admitted feature rows, so
           serving a hit is bit-identical to reading the global matrix.
    pos:   (N,) int32 — cache position of node i, or -1 (miss).
    Both live on one device. capacity / policy: metadata."""
    cache: torch.Tensor
    pos: torch.Tensor
    capacity: int
    policy: str

    def cached_ids(self) -> np.ndarray:
        """(C,) node ids resident in the cache, in cache-row order."""
        pos = self.pos.cpu().numpy()
        ids = np.where(pos >= 0)[0]
        return ids[np.argsort(pos[ids])]

    def to(self, device) -> "CachePlan":
        return replace(self, cache=self.cache.to(device),
                       pos=self.pos.to(device))

    def to_dynamic(self):
        """Promote this static plan to CLOCK admission state
        (`repro_torch.featcache.dynamic.DynamicCacheState`): same
        residency, clear reference bits, zeroed accumulators, hand at
        slot 0."""
        from repro_torch.featcache.dynamic import from_plan
        return from_plan(self)

    def describe(self) -> str:
        return f"{self.policy}@C={self.capacity}"


def select_rows(scores: np.ndarray, capacity: int) -> np.ndarray:
    """Top-`capacity` node ids by score, ties toward lower id (sorted by
    id for locality of the cache array itself)."""
    C = min(int(capacity), len(scores))
    # lexsort: primary -scores, secondary node id (ascending)
    order = np.lexsort((np.arange(len(scores)), -scores))[:C]
    return np.sort(order)


def build_plan(graph, admission="degree_hot", capacity: int = None, *,
               frac: float = 0.2, policy=None, batch_size: int = 512,
               fanouts=(10, 10), seed: int = 0,
               features: np.ndarray = None,
               device: DeviceLike = None) -> CachePlan:
    """Score -> select -> materialize the tensors on `device` (the CUDA
    device unless the caller passes another).

    `capacity` is a row count (defaults to `frac` * N). `policy` (plus
    batch_size/fanouts/seed) is the training context presampling admission
    policies replay."""
    dev = resolve_device(device)
    adm = as_admission(admission)
    N = graph.num_nodes
    cap = int(capacity) if capacity is not None else int(N * frac)
    cap = max(cap, 1)           # a (0, F) cache array has no valid gather
    ctx = {"policy": policy, "batch_size": batch_size, "fanouts": fanouts,
           "seed": seed}
    ids = select_rows(adm.scores(graph, ctx), cap)
    pos = np.full(N, -1, np.int32)
    pos[ids] = np.arange(len(ids), dtype=np.int32)
    feats = graph.features if features is None else features
    return CachePlan(
        cache=torch.as_tensor(
            np.asarray(np.asarray(feats)[ids], np.float32)).to(dev),
        pos=torch.as_tensor(pos).to(dev),
        capacity=len(ids),
        policy=adm.describe(),
    )


def as_plan(obj, graph, **kw) -> "CachePlan":
    """Normalize a CachePlan / admission name / admission instance; None
    passes through (cache disabled)."""
    if obj is None or isinstance(obj, CachePlan):
        return obj
    return build_plan(graph, obj, **kw)


# ---------------------------------------------------------------------------
# numpy mirror of the device hit/miss counters
# ---------------------------------------------------------------------------
def cache_stats_np(pos: np.ndarray, ids: np.ndarray,
                   num_nodes: int) -> Tuple[int, int]:
    """(hits, misses) over the VALID entries of `ids` (sentinel
    `num_nodes` = padding) — the exact mirror of the device counters
    `repro_torch.kernels.gather_cached.ops.cache_stats` returns."""
    ids = np.asarray(ids)
    valid = (ids >= 0) & (ids < num_nodes)
    hit = valid & (np.asarray(pos)[np.clip(ids, 0, num_nodes - 1)] >= 0)
    return int(hit.sum()), int((valid & ~hit).sum())


def cache_ref_updates_np(pos: np.ndarray, ids: np.ndarray,
                         capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-slot hit counts `(C,)` and per-node miss counts `(N,)` over the
    VALID entries of `ids` (same validity rule as `cache_stats_np`): the
    numpy mirror of the extended device counters the dynamic cache reads,
    `repro_torch.kernels.gather_cached.ops.cache_ref_updates`."""
    pos = np.asarray(pos)
    ids = np.asarray(ids)
    num_nodes = len(pos)
    valid = (ids >= 0) & (ids < num_nodes)
    gid = np.clip(ids, 0, num_nodes - 1)
    sel = pos[gid]
    hit = valid & (sel >= 0)
    slot_hits = np.zeros(capacity, np.int32)
    np.add.at(slot_hits, sel[hit], 1)
    node_miss = np.zeros(num_nodes, np.int32)
    np.add.at(node_miss, gid[valid & ~hit], 1)
    return slot_hits, node_miss
