"""NeighborSampler protocol + registry (`repro/sampling/base.py`).

Registered names in the port:

    biased    two-phase intra/inter draw, weight `p` (paper §4.2; default)

(`uniform`, `full` and `labor` are not ported yet.) Policies bind samplers
through `BatchPolicy.sampler_spec()`, a plain `(name, kwargs)` pair that
`for_policy` resolves.

The reference draws its uniforms inside `sample` from a threefry key. The
port splits the two: `draw(gen, M, fanout)` takes the uniforms from a
`torch.Generator`, and `sample(g, nodes, fanout, u_class, u_off)` is a
pure function of them — so a test can hand `sample` the very uniforms the
reference drew and compare batches element for element.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Protocol, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class NeighborSampler(Protocol):
    """Protocol every registered sampler satisfies.

    `sample` is the device path; `sample_level_np` is the numpy mirror used
    by cap calibration."""

    @property
    def name(self) -> str: ...

    def draw(self, gen, M: int, fanout: int):
        """The uniforms `sample` consumes for M rows, from `gen`."""
        ...

    def sample(self, g, nodes, fanout: int, u_class, u_off):
        """nodes: (M,) int32, sentinel `g.num_nodes` for padding.
        Returns (srcs (M, fanout) int32, mask (M, fanout) bool)."""
        ...

    def sample_level_np(self, rng, graph, level, fanout: int,
                        ctx: dict) -> List:
        """Numpy mirror: list of picked-neighbor arrays for `level` nodes."""
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
