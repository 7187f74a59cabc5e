"""NeighborSampler protocol + registry (`repro/sampling/base.py`).

Registered names:

    biased    two-phase intra/inter draw, weight `p` (paper §4.2; default)
    uniform   one uniform draw over the whole adjacency row
    full      deterministic enumeration of the first `fanout` neighbors
    labor     shared-randomness top-k by hash(epoch words, source node id)

Policies bind samplers through `BatchPolicy.sampler_spec()`, a plain
`(name, kwargs)` pair that `for_policy` resolves.

The reference draws its uniforms inside `sample` from a threefry key. The
port splits the two: `draw(gen, M, fanout)` takes the uniforms from a
`torch.Generator` (two tensors for biased, one for uniform, none for full
and labor), and `sample(g, nodes, fanout, *u, ranks=None)` is a pure
function of them — so a test can hand `sample` the very uniforms the
reference drew and compare batches element for element.

A sampler with `shared_randomness` (LABOR) draws nothing per batch: its
`epoch_ctx(words, g)` hashes every node id with two uint32 epoch words
into a rank once per epoch, and `sample` takes those `ranks`. Given the
reference's epoch key words, the ranks and picks are the reference's.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Protocol, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class NeighborSampler(Protocol):
    """Protocol every registered sampler satisfies.

    `sample` is the device path; `sample_level_np` is the numpy mirror used
    by cap calibration. `shared_randomness` tells the batch builder to
    hand `sample` the epoch's `ranks` (`epoch_ctx`) instead of per-batch
    uniforms."""

    shared_randomness: bool

    @property
    def name(self) -> str: ...

    def draw(self, gen, M: int, fanout: int) -> Tuple:
        """The uniforms `sample` consumes for M rows, from `gen` (a tuple
        of any length)."""
        ...

    def sample(self, g, nodes, fanout: int, *u, ranks=None):
        """nodes: (M,) int32, sentinel `g.num_nodes` for padding.
        Returns (srcs (M, fanout) int32, mask (M, fanout) bool)."""
        ...

    def sample_level_np(self, rng, graph, level, fanout: int,
                        ctx: dict) -> List:
        """Numpy mirror: list of picked-neighbor arrays for `level` nodes.
        `ctx` is a per-epoch dict for shared state (LABOR's ranks)."""
        ...

    def describe(self) -> str: ...


_REGISTRY: Dict[str, Callable[..., "NeighborSampler"]] = {}


def register_sampler(name: str):
    """Register a sampler factory under `name` (used by `make_sampler`)."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def make_sampler(name: str, **kwargs) -> "NeighborSampler":
    """Instantiate a registered sampler: `make_sampler("biased", p=1.0)`."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown sampler {name!r}; registered: {available_samplers()}")
    return _REGISTRY[name](**kwargs)


def available_samplers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def as_sampler(obj) -> "NeighborSampler":
    """Normalize a sampler name / (name, kwargs) spec / instance."""
    if isinstance(obj, str):
        return make_sampler(obj)
    if isinstance(obj, (tuple, list)) and len(obj) == 2 \
            and isinstance(obj[0], str):
        return make_sampler(obj[0], **dict(obj[1]))
    if hasattr(obj, "sample") and hasattr(obj, "draw"):
        return obj
    raise TypeError(f"not a neighbor sampler: {obj!r}")


def resolve(sampler, fallback=None) -> "NeighborSampler":
    """The precedence rule for every entry point: an explicit sampler
    wins; a bare number is the legacy float-p signature (biased draw);
    otherwise `fallback` (a sampler or zero-arg factory)."""
    if sampler is not None:
        if isinstance(sampler, bool):
            raise TypeError(f"not a neighbor sampler: {sampler!r}")
        if isinstance(sampler, (int, float, np.floating)):
            return make_sampler("biased", p=float(sampler))
        return as_sampler(sampler)
    return fallback() if callable(fallback) else as_sampler(fallback)


def for_policy(policy) -> "NeighborSampler":
    """The sampler a `BatchPolicy` binds: its `sampler_spec()`."""
    spec = getattr(policy, "sampler_spec", None)
    if callable(spec):
        return as_sampler(spec())
    p = getattr(policy, "p", None)
    if p is not None:
        return make_sampler("biased", p=float(p))
    raise TypeError(f"cannot derive a sampler from policy {policy!r}")
