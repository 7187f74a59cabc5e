"""Pluggable neighbor sampling (paper §4.2 / §6.3 as an API).

    from repro_torch import sampling

    s = sampling.make_sampler("biased", p=1.0)   # or uniform / full
    u = s.draw(gen, nodes.shape[0], 10)
    srcs, mask = s.sample(device_graph, nodes, 10, *u)

    lab = sampling.make_sampler("labor")
    ranks = lab.epoch_ctx(words, device_graph)   # once per epoch
    srcs, mask = lab.sample(device_graph, nodes, 10, ranks=ranks)

Importing the package registers the built-in samplers.
"""
from repro_torch.sampling.base import (NeighborSampler, as_sampler,  # noqa: F401
                                       available_samplers, for_policy,
                                       make_sampler, register_sampler,
                                       resolve)
from repro_torch.sampling.device import (  # noqa: F401
    BiasedTwoPhaseSampler, FullNeighborhoodSampler, LaborSampler,
    UniformSampler)

__all__ = [
    "BiasedTwoPhaseSampler", "FullNeighborhoodSampler", "LaborSampler",
    "NeighborSampler", "UniformSampler", "as_sampler",
    "available_samplers", "for_policy", "make_sampler", "register_sampler",
    "resolve",
]
