"""Policy-driven mini-batch construction (the paper's contribution as an
API).

    from repro_torch import batching

    pol = batching.make_policy("comm_rand", mix=0.125, p=1.0)
    stream = batching.BatchStream(g, pol, 1024, (10, 10, 10), caps)
    for batch in stream.epoch(): ...
"""
from repro_torch.batching.calibrate import (CapsCalibrator,  # noqa: F401
                                            graph_fingerprint)
from repro_torch.batching.order import block_shuffle, make_batches  # noqa: F401
from repro_torch.batching.policy import (BatchPolicy,  # noqa: F401
                                         ClusterGCNPolicy, CommRandPolicy,
                                         LaborPolicy, as_policy,
                                         available_policies, make_policy,
                                         register, root_batches)
from repro_torch.batching.stream import (BatchStream, Cursor,  # noqa: F401
                                         eval_batches)

__all__ = [
    "BatchPolicy", "BatchStream", "CapsCalibrator", "ClusterGCNPolicy",
    "CommRandPolicy", "Cursor", "LaborPolicy", "as_policy",
    "available_policies", "block_shuffle", "eval_batches",
    "graph_fingerprint", "make_batches", "make_policy", "register",
    "root_batches",
]
