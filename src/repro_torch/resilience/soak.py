"""Chaos soak (`repro/resilience/soak.py`): every fault class, one guarded
run, bit-exact recovery.

Inject one fault of every class (`faults.FAULT_SITES`) into a comm_rand x
LABOR + dynamic-cache training run: the run must (a) recover through the
matching mechanism and (b) land on a loss trajectory AND parameter digest
bit-identical to a fault-free run. That holds because the whole stack is
deterministic in the checkpointed `Cursor`: batches, dropout generators
and cache state replay exactly, so every recovery path (producer restart,
skip + rollback, checkpoint fallback, cache degradation) converges back
onto the reference trajectory.

Per-scenario recovery mechanism asserted (`EXPECT_METER`):

  batch_build     producer thread dies mid-build -> watchdog restart
  producer_hang   producer stops heartbeating    -> watchdog restart
  step_nonfinite  NaN loss burst past the skip budget -> rollback+replay
  ckpt_truncate   newest checkpoint corrupted    -> restore falls back
  cache_corrupt   residency invariants broken    -> degrade to uncached

Loss comparison is exact float equality (`==`), never allclose: a
poisoned step the recovery failed to replay leaves a NaN behind, and
NaN != NaN fails the bit-match. The trainer runs on `device` (the card
unless given); the constants equal the reference's.
"""
from __future__ import annotations

import hashlib
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.batching.policy import CommRandPolicy
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.devices import DeviceLike
from repro_torch.models.gnn.models import param_tree
from repro_torch.resilience import faults
from repro_torch.resilience.guard import GuardConfig
from repro_torch.train.checkpoint import flatten_with_paths
from repro_torch.train.gnn_loop import GNNTrainer

BATCH = 128
FANOUTS = (5, 5)
CAPS = (512, 1024)
SEED = 3                # trainer / stream seed
CKPT_EVERY = 4
N_STEPS = 20
GUARD = GuardConfig(max_consecutive_skips=2, check_every=1,
                    max_rollbacks=4)
STALL_S = 1.0           # post-`prime()` watchdog timeout (hang recovery)

# seeded trigger windows per site: inclusive (lo, hi) INVOCATION range
# the fault's start is drawn from (`FaultPlan.seeded`)
WINDOWS: Dict[str, Tuple[int, int]] = {
    "batch_build": (6, 14),      # a mid-run producer build
    "producer_hang": (6, 14),    # a mid-run producer loop turn
    "step_nonfinite": (6, 12),   # a burst starting after the 1st ckpt
    "ckpt_truncate": (1, 1),     # the 2nd save (step 8) gets damaged
    "cache_corrupt": (0, 1),     # an early epoch-boundary refill
}

# the ResilienceMeter counter each fault class must have engaged
EXPECT_METER = {
    "batch_build": "producer_restarts",
    "producer_hang": "producer_restarts",
    "step_nonfinite": "rollbacks",
    "ckpt_truncate": "ckpt_fallbacks",
    "cache_corrupt": "cache_degradations",
}


class CommRandLaborPolicy(CommRandPolicy):
    """comm_rand root ordering x LABOR shared-randomness sampler."""

    def sampler_spec(self):
        return ("labor", {})


def make_trainer(graph, *, pipeline: str = "async", ckpt_dir=None,
                 ckpt_every: int = CKPT_EVERY, guard=GUARD,
                 seed: int = SEED, device: DeviceLike = None) -> GNNTrainer:
    """The soak's fixed configuration: 2-layer SAGE (hidden 16),
    comm_rand x LABOR, dynamic degree_hot cache, guarded, async pipeline
    by default."""
    cfg = GNNConfig("sage-soak", "sage", 2, 16, graph.feat_dim,
                    graph.num_classes, fanout=FANOUTS)
    tcfg = TrainConfig(batch_size=BATCH, max_epochs=4)
    return GNNTrainer(graph, cfg, tcfg,
                      CommRandLaborPolicy("comm_rand", 0.125, 1.0),
                      caps=CAPS, eval_caps=CAPS, seed=seed,
                      cache="dynamic:degree_hot", pipeline=pipeline,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      guard=guard, device=device)


def params_digest(params) -> str:
    """sha1 over the raw bytes of every leaf of the trainer's `params`
    module, in `param_tree`'s (the reference's) leaf order: digest
    equality is bit equality of the final weights."""
    h = hashlib.sha1()
    leaves, _ = flatten_with_paths(
        param_tree(params, list(params.parameters())))
    for leaf in leaves:
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_steps_tracked(tr: GNNTrainer, n: int) -> Dict[int, float]:
    """Advance `tr` to global step `n`, recording the FINAL loss each step
    settled on: a rollback rewinds `global_step` and the replayed steps
    overwrite their poisoned entries, so the returned dict is the
    trajectory the run converged to, comparable `==` against a fault-free
    run."""
    losses: Dict[int, float] = {}
    iters, budget = 0, 8 * n + 16
    while tr.global_step < n:
        prev = tr.global_step
        (loss,) = tr.train_steps(1)
        if tr.global_step == prev + 1:
            losses[tr.global_step] = loss
        iters += 1
        if iters > budget:
            raise RuntimeError(
                f"soak stuck: step {tr.global_step}/{n} after "
                f"{iters} iterations")
    return losses


@dataclass
class SoakResult:
    """One scenario's verdict (JSON-able via `summary()`)."""
    scenario: str
    n_steps: int
    fired: int                  # armed fires of the scenario's site
    bitmatch: bool              # loss trajectory == fault-free reference
    digest_match: bool          # final params sha1 == reference
    recovered: bool             # expected recovery mechanism engaged
    meter: Dict[str, int]       # summed ResilienceMeter counts
    events: List[dict]          # the plan's fire log

    @property
    def ok(self) -> bool:
        """The fault fired, the expected recovery ran, and the run is
        bit-identical to fault-free: all three, or the scenario fails."""
        return bool(self.fired > 0 and self.recovered and self.bitmatch
                    and self.digest_match)

    def summary(self) -> dict:
        return {"scenario": self.scenario, "ok": self.ok,
                "n_steps": self.n_steps, "fired": self.fired,
                "bitmatch": self.bitmatch,
                "digest_match": self.digest_match,
                "recovered": self.recovered, "meter": dict(self.meter)}


def run_reference(graph, n: int = N_STEPS, device: DeviceLike = None):
    """The fault-free reference: the SYNC pipeline (so the comparison also
    cross-checks async == sync), the same guard (a bitwise no-op when no
    step is poisoned), no checkpoints. Returns (losses, digest)."""
    tr = make_trainer(graph, pipeline="sync", ckpt_dir=None, ckpt_every=0,
                      device=device)
    losses = run_steps_tracked(tr, n)
    return losses, params_digest(tr.params)


def _primed(graph, ckpt_dir, device) -> GNNTrainer:
    """An async soak trainer whose first build (on the card, the kernel
    libraries' load) ran before the watchdog drops to `STALL_S`."""
    tr = make_trainer(graph, pipeline="async", ckpt_dir=ckpt_dir,
                      device=device)
    tr.stream.prime()
    tr.stream.stall_timeout_s = STALL_S
    return tr


def run_scenario(graph, site: str, *, n: int = N_STEPS, seed: int = 11,
                 ref=None, device: DeviceLike = None) -> SoakResult:
    """Inject one seeded fault of class `site` into a guarded async run
    and score the recovery against the fault-free reference."""
    if site not in faults.FAULT_SITES:
        raise ValueError(f"unknown scenario {site!r}; "
                         f"known: {faults.FAULT_SITES}")
    if ref is None:
        ref = run_reference(graph, n, device=device)
    ref_losses, ref_digest = ref
    # step_nonfinite must BURST past the skip budget or it never
    # escalates (and the skipped batches would never be replayed)
    counts = {site: GUARD.max_consecutive_skips + 1} \
        if site == "step_nonfinite" else None
    plan = faults.FaultPlan.seeded(seed, {site: WINDOWS[site]}, counts)
    meters = []

    with tempfile.TemporaryDirectory() as d:
        tr = _primed(graph, d, device)
        try:
            with faults.inject(plan):
                if site == "ckpt_truncate":
                    # drive past the corrupted save (invocation 1, the
                    # step-2*CKPT_EVERY save), then simulate a process
                    # crash while it is still the newest checkpoint: the
                    # next trainer must resume by falling back past it
                    crash = 2 * CKPT_EVERY + 2
                    if n <= crash:
                        raise ValueError(
                            f"ckpt_truncate scenario needs n > {crash}")
                    losses = run_steps_tracked(tr, crash)
                    meters.append(tr.guard_meter)
                    tr.stream.close()
                    tr = _primed(graph, d, device)
                    losses.update(run_steps_tracked(tr, n))
                else:
                    losses = run_steps_tracked(tr, n)
            meters.append(tr.guard_meter)
            digest = params_digest(tr.params)
        finally:
            tr.stream.close()

    meter = {k: sum(m.counts()[k] for m in meters)
             for k in meters[0]._KINDS}
    return SoakResult(
        scenario=site, n_steps=n, fired=len(plan.fired(site)),
        bitmatch=(losses == ref_losses),
        digest_match=(digest == ref_digest),
        recovered=meter[EXPECT_METER[site]] > 0,
        meter=meter, events=list(plan.events))


def run_all(graph, *, n: int = N_STEPS, sites=faults.FAULT_SITES,
            seed: int = 11, verbose: bool = False,
            device: DeviceLike = None) -> List[SoakResult]:
    """One scenario per fault class against a shared reference run."""
    ref = run_reference(graph, n, device=device)
    out = []
    for site in sites:
        res = run_scenario(graph, site, n=n, seed=seed, ref=ref,
                           device=device)
        if verbose:
            print(f"  {site:15s} ok={res.ok} fired={res.fired} "
                  f"bitmatch={res.bitmatch} digest={res.digest_match} "
                  f"meter={ {k: v for k, v in res.meter.items() if v} }")
        out.append(res)
    return out
