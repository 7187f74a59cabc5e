"""`repro_torch.resilience` — deterministic fault injection and guarded
execution (`repro/resilience/__init__.py`), the parts the port has so far.

  faults    seeded `FaultPlan` arming named sites; the port wires
            `step_nonfinite` (the GNN train step), `ckpt_truncate`
            (`train.checkpoint.save`) and `cache_corrupt`
            (`featcache.dynamic.refill`) — every chaos run replays exactly
  guard     `GuardConfig` for the guarded train step: on-device
            non-finite detection + skip (no host sync), a consecutive-skip
            budget, rollback-to-checkpoint escalation, all metered by
            `train.monitor.ResilienceMeter`

Recovery is bit-exact because batches, dropout generators and cache
state are pure functions of the checkpointed cursor: `restore_latest`
falls back past corrupt checkpoints to the newest valid one; a
non-finite step applies no update and escalates to rollback after the
skip budget; a cache failing its residency integrity check is dropped
for the uncached gather (cache rows are bit-copies, so the loss
trajectory is unaffected). The chaos soak (`repro/resilience/soak.py`)
waits for the async pipeline.
"""
from repro_torch.resilience.faults import (FAULT_SITES,  # noqa: F401
                                           FaultPlan, FaultSpec,
                                           InjectedFault, active,
                                           corrupt_checkpoint,
                                           corrupt_file, fire, inject,
                                           install, maybe_raise)
from repro_torch.resilience.guard import GuardConfig, as_guard  # noqa: F401

__all__ = [
    "FAULT_SITES", "FaultPlan", "FaultSpec", "GuardConfig",
    "InjectedFault", "active", "as_guard", "corrupt_checkpoint",
    "corrupt_file", "fire", "inject", "install", "maybe_raise",
]
