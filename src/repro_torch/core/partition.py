"""Root-node partitioning per epoch (`repro/core/partition.py:29-46`):
the policy's epoch order, cut into fixed-size root batches."""
from __future__ import annotations

import numpy as np

from repro_torch.batching.order import make_batches
from repro_torch.batching.policy import as_policy


def epoch_order(train_ids: np.ndarray, communities: np.ndarray,
                policy, rng: np.random.Generator) -> np.ndarray:
    """The (possibly constrained-random) permutation of the training set for
    one epoch. `policy` may be a policy object or a registered name."""
    return as_policy(policy).epoch_order(train_ids, communities, rng)


def batches_for_epoch(train_ids, communities, policy, batch_size, rng,
                      drop_last: bool = False) -> np.ndarray:
    return make_batches(
        epoch_order(train_ids, communities, policy, rng), batch_size,
        drop_last)
