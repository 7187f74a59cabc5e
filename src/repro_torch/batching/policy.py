"""Batch-construction policies: one protocol, one registry
(`repro/batching/policy.py:38-160`).

A `BatchPolicy` decides the (possibly constrained-random) order in which
training roots are visited each epoch, plus the intra-community sampling
weight `p` used by the biased neighbor sampler:

    rand        uniform random shuffle (baseline)
    norand      static community order (no shuffle)
    comm_rand   block shuffle with the MIX knob (paper §4.1)

(`clustergcn` and `labor` are not ported yet.) Orders are plain numpy and
equal the reference's for the same Generator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Protocol, Tuple, runtime_checkable

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
