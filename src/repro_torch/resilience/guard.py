"""Guard policy for the GNN train step (skip budget + rollback budget),
as `repro/resilience/guard.py` defines it.

The detection itself lives inside the train step
(`repro_torch.train.gnn_loop.GNNTrainer.train_step`): the loss and every
grad are checked for finiteness on the device, a non-finite step applies
NO update (a `torch.where` select keeps the old params and optimizer
state), and a device-resident consecutive-skip counter rides through the
step. None of that costs a host sync. What this module configures is the
HOST side: how often the trainer reads that one counter, how many
consecutive skips it tolerates before escalating, and how many
rollback-to-checkpoint escalations it will attempt before giving up
(`train.monitor.StepFailure`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class GuardConfig:
    """Guarded-execution knobs for `GNNTrainer(guard=...)`.

    max_consecutive_skips  skip budget: more consecutive non-finite
                           steps than this escalates to a rollback
    check_every            sync the device skip counter every N steps
                           (1 = every step — exact but one scalar sync
                           per step; 0 = only at flush points: epoch
                           end, end of `train_steps`, and checkpoint
                           boundaries — sync-free steady state, but a
                           skip burst is detected up to a flush late)
    max_rollbacks          lifetime rollback budget before the trainer
                           raises `StepFailure` instead of retrying
    """
    max_consecutive_skips: int = 3
    check_every: int = 0
    max_rollbacks: int = 4

    def __post_init__(self):
        if self.max_consecutive_skips < 0 or self.check_every < 0 \
                or self.max_rollbacks < 0:
            raise ValueError(f"negative guard knob: {self}")


def as_guard(obj) -> Optional[GuardConfig]:
    """Normalize `GNNTrainer(guard=)`: None/False -> off, True -> the
    default `GuardConfig`, a `GuardConfig` passes through."""
    if obj is None or obj is False:
        return None
    if obj is True:
        return GuardConfig()
    if isinstance(obj, GuardConfig):
        return obj
    raise TypeError(f"guard must be None/bool/GuardConfig, got {obj!r}")
