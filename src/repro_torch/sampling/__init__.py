"""Pluggable neighbor sampling (paper §4.2 as an API).

    from repro_torch import sampling

    s = sampling.make_sampler("biased", p=1.0)
    u_class, u_off = s.draw(gen, nodes.shape[0], 10)
    srcs, mask = s.sample(device_graph, nodes, 10, u_class, u_off)

Importing the package registers the built-in samplers.
"""
from repro_torch.sampling.base import (NeighborSampler, as_sampler,  # noqa: F401
                                       available_samplers, for_policy,
                                       make_sampler, register_sampler,
                                       resolve)
from repro_torch.sampling.device import BiasedTwoPhaseSampler  # noqa: F401

__all__ = [
    "BiasedTwoPhaseSampler", "NeighborSampler", "as_sampler",
    "available_samplers", "for_policy", "make_sampler", "register_sampler",
    "resolve",
]
