"""Batch-construction policies: one protocol, one registry
(`repro/batching/policy.py`).

A `BatchPolicy` decides the (possibly constrained-random) order in which
training roots are visited each epoch, plus the intra-community sampling
weight `p` used by the biased neighbor sampler:

    rand        uniform random shuffle (baseline)
    norand      static community order (no shuffle)
    comm_rand   block shuffle with the MIX knob (paper §4.1)
    clustergcn  random unions of communities (prior work, §6.3)
    labor       uniform order + LABOR shared-randomness sampling (§6.3)

A policy also decides how neighbors are drawn, via `sampler_spec()`: a
plain `(name, kwargs)` pair into the `repro_torch.sampling` registry. The
COMM-RAND family and ClusterGCN bind the biased two-phase sampler at
their `p`; `labor` binds `LaborSampler`, whose shared ranks shrink its
footprint (`p` means nothing to it). Orders are plain numpy and equal the
reference's for the same Generator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Callable, Dict, List, Protocol, Tuple,
                    runtime_checkable)

import numpy as np

from repro_torch.batching import order as order_mod


@runtime_checkable
class BatchPolicy(Protocol):
    """Protocol every registered policy satisfies."""

    p: float        # intra-community edge weight during neighbor sampling

    @property
    def name(self) -> str: ...

    def epoch_order(self, train_ids: np.ndarray, communities: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        """A permutation of `train_ids` for one epoch."""
        ...

    def sampler_spec(self) -> Tuple[str, Dict]:
        """(name, kwargs) into the `repro_torch.sampling` registry."""
        ...

    def describe(self) -> str: ...


_REGISTRY: Dict[str, Callable[..., "BatchPolicy"]] = {}


def register(name: str):
    """Register a policy factory under `name` (used by `make_policy`)."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def make_policy(name: str, **kwargs) -> "BatchPolicy":
    """Instantiate a registered policy: `make_policy("comm_rand", mix=.125)`."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown policy {name!r}; registered: {available_policies()}")
    return _REGISTRY[name](**kwargs)


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def as_policy(obj) -> "BatchPolicy":
    """Normalize a policy name / policy object to a BatchPolicy."""
    if isinstance(obj, str):
        return make_policy(obj)
    if hasattr(obj, "epoch_order") and hasattr(obj, "p"):
        return obj
    raise TypeError(f"not a batch policy: {obj!r}")


@dataclass(frozen=True)
class CommRandPolicy:
    """Mini-batch construction policy.

    root_mode:
      rand      — uniform random shuffle of the training set (baseline)
      norand    — static, community-ordered (no shuffle)
      comm_rand — block shuffle (communities as blocks + intra-block shuffle)
    mix: fraction of #communities merged into one super-block before
         shuffling (0.0 = MIX-0%, 0.125 = MIX-12.5%, ...). Only for comm_rand.
    p: intra-community edge weight during neighbor sampling; inter gets 1-p.
       0.5 = uniform (baseline), 1.0 = intra-only.
    """
    root_mode: str = "rand"
    mix: float = 0.0
    p: float = 0.5

    @property
    def name(self) -> str:
        return self.root_mode

    def epoch_order(self, train_ids: np.ndarray, communities: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        if self.root_mode == "rand":
            return train_ids[order_mod.hash_perm(
                len(train_ids), order_mod.epoch_words(rng))]
        groups = order_mod.community_groups(train_ids, communities)
        if self.root_mode == "norand":
            return np.concatenate(groups)
        if self.root_mode != "comm_rand":
            raise ValueError(self.root_mode)
        return order_mod.block_shuffle(groups, self.mix, rng)

    def sampler_spec(self) -> Tuple[str, Dict]:
        return ("biased", {"p": self.p})

    def describe(self) -> str:
        if self.root_mode == "rand":
            root = "RAND-ROOTS"
        elif self.root_mode == "norand":
            root = "NORAND-ROOTS"
        else:
            root = f"COMM-RAND-MIX-{self.mix * 100:g}%"
        return f"{root} p={self.p:g}"


@register("rand")
def _make_rand(p: float = 0.5, **_kw) -> CommRandPolicy:
    return CommRandPolicy("rand", 0.0, p)


@register("norand")
def _make_norand(p: float = 1.0, **_kw) -> CommRandPolicy:
    return CommRandPolicy("norand", 0.0, p)


@register("comm_rand")
def _make_comm_rand(mix: float = 0.125, p: float = 1.0,
                    **_kw) -> CommRandPolicy:
    return CommRandPolicy("comm_rand", mix, p)


# ---------------------------------------------------------------------------
# prior-work policies (paper §6.3)
# ---------------------------------------------------------------------------
@register("clustergcn")
@dataclass(frozen=True)
class ClusterGCNPolicy:
    """ClusterGCN [14] partition unions: each epoch shuffles the community
    ids and merges consecutive groups of `parts_per_batch` into one batch.
    `member_groups` gives the full induced-node groups the baseline trainer
    consumes; `epoch_order` is the same grouping restricted to train roots.
    """
    parts_per_batch: int = 2
    p: float = 0.5

    @property
    def name(self) -> str:
        return "clustergcn"

    def community_order(self, communities: np.ndarray,
                        rng: np.random.Generator) -> List[np.ndarray]:
        n_comm = int(communities.max()) + 1
        order = order_mod.hash_perm(n_comm, order_mod.epoch_words(rng))
        return np.split(order, range(self.parts_per_batch, n_comm,
                                     self.parts_per_batch))

    @staticmethod
    def _grouped(ids: np.ndarray, comm_of_ids: np.ndarray, n_comm: int,
                 unions: List[np.ndarray]) -> List[np.ndarray]:
        """One bucketed pass: argsort `ids` by community once, then each
        union is a concat of bucket slices; the position sort restores the
        original `ids` order."""
        by_comm = np.argsort(comm_of_ids, kind="stable")
        bounds = np.zeros(n_comm + 1, np.int64)
        np.add.at(bounds, comm_of_ids + 1, 1)
        np.cumsum(bounds, out=bounds)
        out = []
        for union in unions:
            pos = np.concatenate(
                [by_comm[bounds[c]:bounds[c + 1]] for c in union]
                or [np.zeros(0, np.int64)])
            out.append(ids[np.sort(pos)])
        return out

    def member_groups(self, communities: np.ndarray,
                      rng: np.random.Generator) -> List[np.ndarray]:
        """ALL node ids per community union (one epoch of subgraph batches)."""
        n_comm = int(communities.max()) + 1
        return self._grouped(np.arange(len(communities)), communities,
                             n_comm, self.community_order(communities, rng))

    def epoch_order(self, train_ids: np.ndarray, communities: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        n_comm = int(communities.max()) + 1
        return np.concatenate(self._grouped(
            train_ids, communities[train_ids], n_comm,
            self.community_order(communities, rng)))

    def sampler_spec(self) -> Tuple[str, Dict]:
        return ("biased", {"p": self.p})

    def describe(self) -> str:
        # p is part of the description: CapsCalibrator keys its disk cache
        # on describe(), and p changes the sampled-neighborhood footprint
        return f"ClusterGCN({self.parts_per_batch} parts/batch) p={self.p:g}"


@register("labor")
@dataclass(frozen=True)
class LaborPolicy:
    """LABOR-lite [9]: structure-agnostic roots (uniform shuffle); the
    footprint reduction comes from shared per-node hash randomness during
    neighbor sampling — `sampler_spec()` binds `sampling.LaborSampler`.
    `p` exists only to satisfy the BatchPolicy protocol; the LABOR sampler
    ignores it."""
    p: float = 0.5

    @property
    def name(self) -> str:
        return "labor"

    def epoch_order(self, train_ids: np.ndarray, communities: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        return train_ids[order_mod.hash_perm(
            len(train_ids), order_mod.epoch_words(rng))]

    def sampler_spec(self) -> Tuple[str, Dict]:
        return ("labor", {})

    def describe(self) -> str:
        return "LABOR-lite(shared-randomness)"


# ---------------------------------------------------------------------------
# convenience: one epoch of root-id batches, no device work
# ---------------------------------------------------------------------------
def root_batches(graph, policy, batch_size: int, *, seed: int = 0,
                 epoch: int = 0, drop_last: bool = False) -> np.ndarray:
    """(n_batches, batch_size) root ids for `epoch`, -1-padded. Deterministic
    in (seed, epoch) — the same derivation `BatchStream` uses."""
    rng = np.random.default_rng((seed, epoch))
    order = as_policy(policy).epoch_order(
        graph.train_ids, graph.communities, rng)
    return order_mod.make_batches(order, batch_size, drop_last)
