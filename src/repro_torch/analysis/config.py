"""Scoping configuration for the port's analysis pass
(`repro/analysis/config.py`, with the port's own scopes).

The lint rules are scope-sensitive: wall-clock reads are fine in a
benchmark script but not in the deterministic batch pipeline; `float()`
on a tensor is fine at an epoch boundary but not inside a function every
train step runs. `AnalysisConfig` carries those scopes as explicit
module-prefix lists and a per-module hot-function map (paths relative to
`src/`, posix separators), so a violation is always attributable to a
named policy decision rather than a heuristic. The defaults live here
only; nothing is read from `pyproject.toml`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

# Modules whose behaviour must be a pure function of (seed, cursor):
# wall-clock reads and the torch global generator are contract violations
# here unless explicitly waived (e.g. the prefetch watchdog's liveness
# heartbeats, which never influence delivered data).
DETERMINISTIC_PREFIXES: Tuple[str, ...] = (
    "repro_torch/batching/",
    "repro_torch/pipeline/",
    "repro_torch/sampling/",
    "repro_torch/featcache/",
    "repro_torch/kernels/",
)

_KERNEL_PACKAGES = ("clock_refill", "flash_attention", "gather_agg",
                    "gather_cached", "gather_mean", "moe_gmm", "rwkv6_chunk")

# module -> hot-path function names (bare names, class-agnostic; a nested
# def is its own name). A host-sync idiom inside one of these stalls the
# host until the device drains, per call. "*" marks every function of the
# module (kernel wrappers and their ops). The sync path builds its batches
# in Python (`batching/stream.py`), so its build functions are hot too.
HOT_FUNCTIONS: Dict[str, Tuple[str, ...]] = {
    "repro_torch/train/gnn_loop.py": ("train_step", "_train_one",
                                      "train_steps", "run_epoch",
                                      "_guard_check", "evaluate",
                                      "_evaluate", "_dropout_gens"),
    "repro_torch/batching/stream.py": ("build", "build_at", "draw",
                                       "_take", "epoch", "batch_roots",
                                       "eval_batches"),
    "repro_torch/core/minibatch.py": ("_build_batch_impl", "_positions",
                                      "_unique_capped"),
    "repro_torch/core/hash32.py": ("hash_u32", "mul_u32"),
    "repro_torch/sampling/device.py": ("draw", "sample", "_row_meta",
                                       "_cand", "_finish", "epoch_ctx",
                                       "_hash_rank01", "_k_lowest"),
    "repro_torch/pipeline/builder.py": ("build", "epoch_roots",
                                        "_epoch_roots_fresh",
                                        "epoch_ranks", "_follow_stream"),
    "repro_torch/pipeline/device_order.py": ("device_epoch_order",
                                             "_order_perm",
                                             "_order_comm_rand",
                                             "_order_clustergcn",
                                             "_stable_argsort"),
    "repro_torch/pipeline/prefetch.py": ("_produce", "_produce_loop",
                                         "_take", "_handoff"),
    "repro_torch/featcache/dynamic.py": ("ref_updates", "with_refs"),
    # the tracer is sold as zero-device-impact: every function a traced
    # step calls per span must itself never sync
    "repro_torch/obs/trace.py": ("span", "instant", "note", "flush",
                                 "_emit", "__enter__", "__exit__"),
    "repro_torch/optim/adamw.py": ("update", "tree_leaves",
                                   "tree_unflatten"),
    "repro_torch/train/losses.py": ("gnn_softmax_ce", "accuracy",
                                    "_picked"),
    # the forward functions only: `params_to_jax` exports parameters
    "repro_torch/models/gnn/models.py": ("sage_layer", "gcn_layer",
                                         "gat_layer", "apply_gnn"),
    "repro_torch/models/gnn/fullgraph.py": ("sage_subgraph_apply",),
    # the MoE layer every LM train step runs, forward and backward: its
    # routing, its dispatch / combine Functions and their gathers
    "repro_torch/models/lm/moe.py": ("moe_ffn", "route", "forward",
                                     "backward"),
    **{f"repro_torch/kernels/{k}/{m}.py": ("*",)
       for k in _KERNEL_PACKAGES for m in ("ops", "kernel")},
}

# Modules that build device tensors: float64 here doubles feature-path
# memory traffic and runs at a fraction of the card's float32 rate.
DEVICE_PREFIXES: Tuple[str, ...] = (
    "repro_torch/kernels/",
    "repro_torch/models/",
    "repro_torch/sampling/device.py",
    "repro_torch/pipeline/",
    "repro_torch/featcache/dynamic.py",
    "repro_torch/featcache/plan.py",
    "repro_torch/train/gnn_loop.py",
    "repro_torch/train/losses.py",
    "repro_torch/optim/adamw.py",
    "repro_torch/batching/stream.py",
    "repro_torch/core/minibatch.py",
    "repro_torch/core/hash32.py",
)

# Host-side analytics that legitimately compute in float64 (modularity
# math, cache-simulator scores) and cast to float32 at the device
# boundary.
F64_HOST_EXEMPT: Tuple[str, ...] = (
    "repro_torch/core/community.py",
    "repro_torch/featcache/sim.py",
    "repro_torch/featcache/plan.py",
)

# The port has no deprecation shims.
DEPRECATED_MODULES: Dict[str, str] = {}


@dataclass(frozen=True)
class AnalysisConfig:
    """Resolved scoping config consumed by `lint.py`."""
    deterministic_prefixes: Tuple[str, ...] = DETERMINISTIC_PREFIXES
    hot_functions: Dict[str, Tuple[str, ...]] = field(
        default_factory=lambda: dict(HOT_FUNCTIONS))
    device_prefixes: Tuple[str, ...] = DEVICE_PREFIXES
    f64_host_exempt: Tuple[str, ...] = F64_HOST_EXEMPT
    deprecated_modules: Dict[str, str] = field(
        default_factory=lambda: dict(DEPRECATED_MODULES))

    # -- scope predicates (paths are relative to src/, posix separators)
    def in_deterministic(self, relpath: str) -> bool:
        return relpath.startswith(self.deterministic_prefixes)

    def in_device(self, relpath: str) -> bool:
        return (relpath.startswith(self.device_prefixes)
                and relpath not in self.f64_host_exempt)

    def hot_names(self, relpath: str) -> Tuple[str, ...]:
        return self.hot_functions.get(relpath, ())
