"""GNN mini-batch training loop (`repro/train/gnn_loop.py`) — the paper's
methodology (§5): AdamW(lr=1e-3, wd=5e-4), batch 1024, fanout 10 per hop,
up to 100 epochs, early stopping on val loss (patience 6),
ReduceLROnPlateau (patience 3); metrics: final val acc, per-epoch time,
epochs-to-converge, total time, and the Fig-6 working-set metric (mean
unique input nodes / feature bytes).

Batches come from a `BatchStream` whose `Cursor(epoch, pos)` fixes every
draw; dropout generators derive from the same (seed, epoch, pos). The
cursor is saved in every checkpoint (`ckpt_dir=`, `ckpt_every=`;
`train.checkpoint`, the reference's on-disk format) beside the weights,
AdamW's state, `fit()`'s scheduler state (lr, plateau / early-stop
counters, best-so-far weights) and the dynamic cache's state, so an
interrupted run resumes — at construction — onto a bit-identical
trajectory. Caps come from a `CapsCalibrator` (`calibrator=`; by default
one without a disk cache, seeded like the reference's).

Guarded step: the step checks the loss and every grad for finiteness ON
DEVICE and applies no update on a non-finite step (a `torch.where` select
of params and optimizer state — no host sync); a device-resident
consecutive-skip counter (`skips`) counts such steps. With
`guard=GuardConfig(...)` the trainer reads that counter every
`check_every` steps and always at flush and checkpoint boundaries, and
past `max_consecutive_skips` escalates: `resilient_step` restores the
newest VALID checkpoint (`restore_latest` falls back across corrupt ones)
and replays. Skips, rollbacks, checkpoint fallbacks and cache
degradations are metered in a `ResilienceMeter` (`guard_meter`).

Feature cache: `cache=` (a `CachePlan`, a `DynamicCacheState`, a static
admission name, or `"dynamic[:admission]"`, built here against this
trainer's policy, batch size, fanouts and seed) routes every layer-0
feature read through the device-resident cache (`gather_cached`). Cache
rows are exact copies, so the loss trajectory is bit-identical with the
cache on and off. Each batch's (hits, misses) stay on the device until the
host read the loop makes anyway, and feed `cache_meter`: the paper's §6.5
cache-locality claim as a measured hit rate per epoch and per run. With
DYNAMIC admission every train step folds its reads into the CLOCK
reference bits and candidate frequencies on the device
(`dynamic.ref_updates`), and at every epoch boundary — in `run_epoch` and
when `train_steps` crosses epochs — `dynamic.refill` swaps cold slots for
hot missed rows (the hand-written CUDA walk on the card) and checks the
residency invariants; a failed check drops to the uncached gather.
Evaluation reads through the cache but never feeds the counters.

Host reads: once per `train_steps` call or epoch (`_drain`: the losses,
the cache counters and the guard's flags in one copy). The only others
are the guard's skip-counter read, the refill's admitted count and
integrity bool, and a checkpoint's copy to the host.

Pipeline: `pipeline="sync"` (the default) builds each batch on the
trainer's thread from the numpy epoch order; `pipeline="async"` takes
them from `repro_torch.pipeline.AsyncBatchStream` (a producer thread
building on a CUDA side stream from a device-resident order) — the same
batches, so the same losses bit for bit; its watchdog restarts are metered
in `guard_meter`. Close it with `trainer.stream.close()`.

Observability (`repro_torch.obs`): the three meters mirror into one
`MetricsHub` (`hub`; `hub.mark_epoch` at every epoch's end), and the
reference's spans are emitted at its sites when a tracer is installed:
`train_step`, `epoch`, `epoch_flush` / `steps_flush` (the `_drain` that
ends an epoch / a `train_steps` call — it also carries the cache counters
and guard flags, which the reference reads in a `stats_flush` of their
own), `stats_flush` (the drain before a rollback), `guard_sync` (a real
read of the skip counter), `ckpt_rollback`, `cache_refill`, `eval`, and
`ckpt_save` / `ckpt_restore` / `clock_refill` in the modules that do
them. `DeviceStepTimer` closes its window after each drain. Tracing
changes no batch, draw or loss.

Not ported yet: sharded training.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import featcache, sampling
from repro_torch.batching import (BatchStream, CapsCalibrator, Cursor,
                                  as_policy, make_policy)
from repro_torch.batching.stream import (SALT_DROPOUT, cursor_generator,
                                         eval_batches)
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core import minibatch as mb
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.featcache import dynamic
from repro_torch.featcache.dynamic import DynamicCacheState
from repro_torch.graphs.csr import DeviceGraph, Graph
from repro_torch.kernels.gather_cached.ops import cache_stats
from repro_torch.models.gnn.models import (apply_gnn, init_gnn, param_tree,
                                           tree_tensors)
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsHub
from repro_torch.optim import adamw
from repro_torch.optim.schedule import EarlyStopping, ReduceLROnPlateau
from repro_torch.resilience import faults
from repro_torch.resilience.guard import as_guard
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.losses import accuracy, gnn_softmax_ce
from repro_torch.train.monitor import (HitRateMeter, ResilienceMeter,
                                       StepFailure, StragglerMonitor,
                                       resilient_step)


@dataclass
class EpochMetrics:
    epoch: int
    train_loss: float
    val_loss: float
    val_acc: float
    epoch_time_s: float
    mean_unique_nodes: float
    cache_hit_rate: float = 0.0     # measured; 0 = no cache
    cache_refills: int = 0          # dynamic-CLOCK rows admitted (churn)
    straggler_fraction: float = 0.0  # slow-step fraction of THIS epoch


@dataclass
class TrainResult:
    policy: str
    val_acc: float                  # at best epoch
    test_acc: float
    epochs_to_converge: int
    per_epoch_time_s: float
    total_time_s: float
    mean_unique_nodes: float
    feature_bytes_per_batch: float
    caps: tuple
    history: List[EpochMetrics] = field(default_factory=list)
    cache: str = ""                 # cache describe(), "" = uncached
    cache_hit_rate: float = 0.0     # measured over the whole run
    cache_refills: int = 0          # total dynamic-CLOCK churn of the run
    straggler_fraction: float = 0.0  # slow-step fraction of the whole run


class GNNTrainer:
    """One (graph, model, policy) training run over a `BatchStream`, on
    `device` — the CUDA device unless the caller passes another.
    `cfg.model` is any of sage, gcn and gat."""

    def __init__(self, graph: Graph, cfg: GNNConfig, tcfg: TrainConfig,
                 policy, caps=None, eval_caps=None, seed: int = 0,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 calibrator: Optional[CapsCalibrator] = None,
                 cache=None, cache_capacity: Optional[int] = None,
                 cache_frac: float = 0.2, pipeline: str = "sync",
                 guard=None, device: DeviceLike = None):
        if pipeline not in ("sync", "async"):
            raise ValueError(
                f"pipeline must be 'sync' or 'async', got {pipeline!r}")
        self.device = resolve_device(device)
        self.graph = graph
        self.cfg = cfg
        self.tcfg = tcfg
        self.policy = as_policy(policy)
        self.seed = seed
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.g = DeviceGraph.from_graph(graph, self.device)
        self.feats = torch.as_tensor(graph.features,
                                     dtype=torch.float32).to(self.device)
        self.labels = torch.as_tensor(graph.labels,
                                      dtype=torch.int32).to(self.device)
        self.fanouts = tuple(cfg.fanout[:cfg.num_layers])
        # caps are calibrated — and disk-cached when the calibrator has a
        # path — per (policy, sampler) pair with the copied numpy probe,
        # so they equal the reference's for the same seed
        # the policy binds its neighbor sampler (repro_torch.sampling)
        self.sampler = sampling.for_policy(self.policy)
        cal = calibrator or CapsCalibrator(seed=seed)
        self.caps = tuple(caps or cal.caps_for(
            graph, self.policy, tcfg.batch_size, self.fanouts))
        # eval always uses the uniform policy (identical across compared
        # policies)
        self.eval_policy = make_policy("rand")
        self.eval_sampler = sampling.for_policy(self.eval_policy)
        eval_cal = calibrator or CapsCalibrator(seed=seed + 1)
        self.eval_caps = tuple(eval_caps or eval_cal.caps_for(
            graph, self.eval_policy, tcfg.batch_size, self.fanouts))
        self.params = init_gnn(cfg, torch.Generator().manual_seed(seed),
                               self.device)
        self.opt_state = adamw.init(list(self.params.parameters()))
        self.skips = torch.zeros((), dtype=torch.int32, device=self.device)
        self.cache = featcache.as_cache(
            cache, graph, capacity=cache_capacity, frac=cache_frac,
            policy=self.policy, batch_size=tcfg.batch_size,
            fanouts=self.fanouts, seed=seed, device=self.device)
        # one metrics registry for the run (repro_torch.obs): the three
        # meters mirror every mutation into it
        self.hub = MetricsHub()
        self.cache_meter = HitRateMeter(hub=self.hub)
        self._pending_stats: List[torch.Tensor] = []   # (2,) int32 each
        # host wall clock of each step's dispatch (no sync)
        self.straggler = StragglerMonitor(hub=self.hub)
        # per-step dispatch timestamps, closed into one "device_steps"
        # span after each drain (never a read of its own)
        self._dev_timer = obs_trace.DeviceStepTimer()
        # guarded execution: None/False = never read or escalated (the
        # on-device guard still runs), True = GuardConfig() defaults
        self.guard = as_guard(guard)
        self.guard_meter = ResilienceMeter(hub=self.hub)
        self._skips_host = 0          # last value read (guard checks)
        self._pending_ok: List[tuple] = []   # (ok, step) device flags
        stream_kw = {}
        if pipeline == "async":
            from repro_torch.pipeline import AsyncBatchStream
            stream_cls = AsyncBatchStream
            # watchdog restarts surface in THIS trainer's resilience meter
            stream_kw["meter"] = self.guard_meter
        else:
            stream_cls = BatchStream
        self.pipeline = pipeline
        self.stream = stream_cls(
            graph, self.policy, tcfg.batch_size, self.fanouts, self.caps,
            seed=seed, device_graph=self.g, labels=self.labels,
            cache=self.cache, device=self.device, **stream_kw)
        # epoch whose boundary refill is still pending (dynamic cache);
        # travels in checkpoint `extra` so resume never double-refills
        self._cache_epoch = self.stream.cursor.epoch
        self.global_step = 0
        self._best_params: Optional[List[torch.Tensor]] = None
        self._fit_state: Optional[dict] = None   # lr / plateau / stopper
        if ckpt_dir:
            self._try_resume()

    # -- checkpoint/resume (cursor + fit state travel with the weights) -----
    def _state(self) -> Dict:
        """The checkpointed state, in the reference's tree layout."""
        params = list(self.params.parameters())
        best = self._best_params if self._best_params is not None \
            else params
        opt = self.opt_state
        state = {"params": param_tree(self.params, params),
                 "opt": {"m": param_tree(self.params, opt["m"]),
                         "v": param_tree(self.params, opt["v"]),
                         "count": opt["count"]},
                 "best": param_tree(self.params, best)}
        if isinstance(self.cache, DynamicCacheState):
            # the evolving CLOCK state is training state: rows, residency,
            # reference bits, accumulators and hand all resume bit-exactly
            state["cache"] = self.cache
        return state

    def save(self) -> None:
        if not self.ckpt_dir:
            return
        ckpt.save(self.ckpt_dir, self.global_step, self._state(),
                  extra={"cursor": self.stream.cursor.state(),
                         "fit": self._fit_state,
                         "cache_epoch": self._cache_epoch})

    def _on_corrupt_ckpt(self, step: int, err: Exception) -> None:
        """`restore_latest` fallback hook: meter each corrupt/partial
        checkpoint skipped on the way to the newest valid one."""
        self.guard_meter.note("ckpt_fallbacks", ckpt_step=step,
                              error=str(err))

    def _apply_restored(self, step: int, tree, extra) -> None:
        """Install a restored checkpoint as the live training state
        (shared by startup resume and guard rollback)."""
        with torch.no_grad():
            for p, t in zip(self.params.parameters(),
                            tree_tensors(tree["params"])):
                p.copy_(t)
        opt = tree["opt"]
        self.opt_state = {"m": tree_tensors(opt["m"]),
                          "v": tree_tensors(opt["v"]),
                          "count": opt["count"]}
        self._best_params = tree_tensors(tree["best"])
        self.global_step = step
        self.stream.cursor = Cursor.from_state(extra["cursor"])
        self.stream._order_cache = (-1, None)
        self._fit_state = extra.get("fit")
        if "cache" in tree:
            self._set_cache(tree["cache"])
        self._cache_epoch = int(extra.get("cache_epoch",
                                          self.stream.cursor.epoch))

    def _restore_latest(self):
        return ckpt.restore_latest(self.ckpt_dir, self._state(),
                                   on_corrupt=self._on_corrupt_ckpt)

    def _try_resume(self) -> None:
        step, tree, extra = self._restore_latest()
        if step is not None:
            self._apply_restored(step, tree, extra)

    # -- one guarded step ---------------------------------------------------
    def train_step(self, batch: mb.MiniBatch, lr: float,
                   dropout_gens: Optional[List[torch.Generator]] = None,
                   poison: float = 1.0):
        """Forward, backward and a guarded AdamW update on `batch`.
        `poison` multiplies the loss (1.0 is a bitwise no-op; NaN makes the
        loss and every grad non-finite, which the guard must catch).
        Returns the (device) loss and the (device) ok flag."""
        params = list(self.params.parameters())
        logits = apply_gnn(self.cfg, self.params, batch, self.feats,
                           self.g.degrees, train=True,
                           dropout_gens=dropout_gens, feats_global=True,
                           cache=self.cache)
        loss = gnn_softmax_ce(logits, batch.labels,
                              batch.label_mask.to(torch.float32)) * poison
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            ok = torch.isfinite(loss)
            for g in grads:
                ok = ok & torch.isfinite(g).all()
            new_p, new_opt = adamw.update(
                grads, self.opt_state, params, lr=lr,
                weight_decay=self.tcfg.weight_decay)
            for p, n in zip(params, new_p):
                p.copy_(torch.where(ok, n, p))
            old = self.opt_state
            self.opt_state = {
                "m": [torch.where(ok, n, o)
                      for n, o in zip(new_opt["m"], old["m"])],
                "v": [torch.where(ok, n, o)
                      for n, o in zip(new_opt["v"], old["v"])],
                "count": torch.where(ok, new_opt["count"], old["count"])}
            self.skips = torch.where(ok, 0, self.skips + 1).to(torch.int32)
        return loss.detach(), ok

    def _dropout_gens(self) -> Optional[List[torch.Generator]]:
        """Per-layer dropout generators of the batch the stream just
        yielded (cursor already advanced): a pure function of the cursor."""
        if self.cfg.dropout <= 0:
            return None
        c = self.stream.cursor
        return [cursor_generator(self.device, self.seed, c.epoch, c.pos - 1,
                                 i, SALT_DROPOUT)
                for i in range(self.cfg.num_layers - 1)]

    def _set_cache(self, cache) -> None:
        """Replace the carried cache state (and keep the stream's view of
        it current)."""
        self.cache = cache
        self.stream.cache = cache

    def _train_one(self, batch: mb.MiniBatch, lr: float) -> torch.Tensor:
        t0 = time.perf_counter()
        step0 = self.global_step
        with obs_trace.span("train_step", cat="step", step=step0):
            poison = 1.0
            if faults.fire("step_nonfinite", step=step0) is not None:
                poison = float("nan")   # chaos site: NaN loss and grads
            loss, ok = self.train_step(batch, lr, self._dropout_gens(),
                                       poison)
            self._dev_timer.note(loss)
            if self.cache is not None:
                # the counters stay on the device until `_drain`
                self._pending_stats.append(torch.stack(cache_stats(
                    self.cache.pos, batch.node_ids, self.graph.num_nodes)))
            if self.guard is not None:
                self._pending_ok.append((ok, step0))
            if isinstance(self.cache, DynamicCacheState):
                # fold this batch's reads into the reference bits /
                # candidate frequencies on the device (the (C, F) rows are
                # not copied). Not gated on `ok`: a skipped batch still
                # touched its rows, and replayed reads after a rollback
                # refold identically.
                self._set_cache(dynamic.with_refs(
                    self.cache,
                    dynamic.ref_updates(self.cache, batch.node_ids)))
            self.global_step += 1
            # a checkpoint due at this step forces a guard read first: never
            # checkpoint mid-skip-burst, or a later rollback to that
            # checkpoint would lose the skipped batches for good
            due_ckpt = bool(self.ckpt_dir and self.ckpt_every and
                            self.global_step % self.ckpt_every == 0)
            rolled = self._guard_check(force=due_ckpt)
            # refill BEFORE any checkpoint at this step: a boundary
            # checkpoint then carries the post-refill state and the advanced
            # `_cache_epoch`, so a resumed run neither skips nor repeats it
            self._maybe_refill()
            if due_ckpt and not rolled and self._skips_host == 0:
                self.save()
        # host dispatch time (never a device sync)
        self.straggler.observe(time.perf_counter() - t0, step0)
        return loss

    # -- the dynamic cache's epoch boundary ----------------------------------
    def _maybe_refill(self) -> None:
        """Epoch-boundary CLOCK eviction/refill (dynamic cache only).

        Called after every consumed batch, in `run_epoch` AND
        `train_steps`: the cursor reaching the end of epoch `_cache_epoch`
        triggers exactly one refill per boundary — the one point where
        residency may change, outside all differentiated code."""
        if not isinstance(self.cache, DynamicCacheState):
            return
        c = self.stream.cursor
        at_end = c.pos >= self.stream.num_batches(c.epoch)
        if c.epoch > self._cache_epoch or (c.epoch == self._cache_epoch
                                           and at_end):
            # cat="sync": the churn count and the integrity check are read
            # on the host, inside the epoch's last train step
            with obs_trace.span("cache_refill", cat="sync", epoch=c.epoch):
                self._refill_now(c, at_end)

    def _refill_now(self, c: Cursor, at_end: bool) -> None:
        state, admitted = dynamic.refill(self.cache, self.feats)
        if not dynamic.integrity_ok(state):
            # graceful degradation: residency invariants broken (the
            # cache_corrupt chaos site, or a real bug) — drop to the
            # uncached gather, detected here BEFORE any read goes through
            # the new state, so every loss ever computed came from intact
            # bit-copies of the global rows
            self.guard_meter.note("cache_degradations",
                                  step=self.global_step, epoch=c.epoch)
            self.cache_meter.note_degraded(self.global_step)
            self._pending_stats = []    # counters of the dropped state
            self._set_cache(None)
            return
        self._set_cache(state)
        self.cache_meter.observe_refill(admitted)
        self._cache_epoch = c.epoch + 1 if at_end else c.epoch

    # -- host reads ---------------------------------------------------------
    def _drain(self, losses: Sequence[torch.Tensor] = (),
               ints: Sequence[torch.Tensor] = ()):
        """The one host read after a run of steps (it drains the device):
        the float32 losses, the 0-d integer metrics `ints`, the pending
        guard flags and the pending cache counters in one copy, the
        integers bit-cast to float32 for it. The flags feed `guard_meter`,
        the counters `cache_meter`. Returns the losses and `ints` as numpy
        arrays."""
        stats, self._pending_stats = self._pending_stats, []
        oks, self._pending_ok = self._pending_ok, []
        n, k = len(losses), len(ints)
        words = [*ints, *(ok for ok, _ in oks), *stats]
        parts = [torch.stack(list(losses))] if n else []
        if words:
            parts.append(torch.cat([t.reshape(-1).to(torch.int32)
                                    for t in words]).view(torch.float32))
        if not parts:
            return np.zeros(0, np.float32), np.zeros(0, np.int32)
        host = torch.cat(parts).cpu().numpy()
        rest = host[n:].view(np.int32)
        for (_, step), flag in zip(oks, rest[k:k + len(oks)]):
            if not flag:
                self.guard_meter.note("skipped_steps", step=step)
        for hits, misses in rest[k + len(oks):].reshape(-1, 2):
            self.cache_meter.observe(hits, misses)
        return host[:n], rest[:k]

    # -- guarded execution (repro_torch.resilience) -------------------------
    def _guard_check(self, force: bool = False,
                     skips: Optional[int] = None) -> bool:
        """Read the device skip counter when due (`check_every` cadence,
        or forced at flush/checkpoint boundaries; `skips` is a value a
        drain already read) and escalate past the consecutive-skip
        budget. Returns True if it rolled back."""
        g = self.guard
        if g is None:
            return False
        if not (force or (g.check_every > 0 and
                          self.global_step % g.check_every == 0)):
            return False
        if skips is None:
            with obs_trace.span("guard_sync", cat="sync",
                                step=self.global_step):
                self._skips_host = int(self.skips)
        else:                           # read by a drain already
            self._skips_host = int(skips)
        if self._skips_host <= g.max_consecutive_skips:
            return False
        self._escalate()
        return True

    def _escalate(self) -> None:
        """Consecutive-skip budget blown: roll back to the newest VALID
        checkpoint and replay. Replay is clean for transient causes (an
        armed fault window is behind the invocation counter by the time
        the replayed steps re-fire) and bit-exact because batches, dropout
        generators and cache state are pure functions of the restored
        cursor. Persistent causes re-escalate until `max_rollbacks`, then
        raise StepFailure."""
        with obs_trace.span("stats_flush", cat="sync",
                            n=len(self._pending_stats) +
                            len(self._pending_ok)):
            self._drain()               # meter the skips we're erasing
        self.guard_meter.note("rollbacks", step=self.global_step,
                              skips=self._skips_host)
        if self.guard_meter.rollbacks > self.guard.max_rollbacks:
            raise StepFailure(
                f"non-finite steps persisted through "
                f"{self.guard.max_rollbacks} rollbacks "
                f"(step {self.global_step})")
        if not self.ckpt_dir:
            raise StepFailure(
                f"{self._skips_host} consecutive non-finite steps at step "
                f"{self.global_step} and no ckpt_dir to roll back to")

        def _restore():
            step, tree, extra = self._restore_latest()
            if step is None:
                raise StepFailure(
                    f"rollback found no valid checkpoint in "
                    f"{self.ckpt_dir}")
            return step, tree, extra

        with obs_trace.span("ckpt_rollback", cat="ckpt",
                            step=self.global_step, skips=self._skips_host):
            (step, tree, extra), _ = resilient_step(
                _restore, max_retries=1, backoff_s=0.05)
            self._apply_restored(step, tree, extra)
        self.skips = torch.zeros((), dtype=torch.int32, device=self.device)
        self._skips_host = 0
        self._pending_stats = []
        self._pending_ok = []

    # -- loops --------------------------------------------------------------
    def _guard_ints(self) -> List[torch.Tensor]:
        return [self.skips] if self.guard is not None else []

    def run_epoch(self, lr: float) -> Dict:
        """Consume the remainder of the stream's current epoch (the
        epoch-boundary refill fires inside `_train_one` at the last
        batch, so the dynamic cache is already post-refill on return)."""
        t0 = time.perf_counter()
        e0 = self.stream.cursor.epoch
        mark = self.cache_meter.mark()
        smark = self.straggler.mark()
        losses, uniq = [], []
        # the epoch envelope the trace analyzer's mid-epoch sync gate
        # anchors on
        with obs_trace.span("epoch", cat="loop", epoch=e0):
            for batch in self.stream.epoch():
                losses.append(self._train_one(batch, lr))
                uniq.append(batch.num_unique)
            with obs_trace.span("epoch_flush", cat="sync", epoch=e0,
                                n_steps=len(losses)):
                loss_h, ints_h = self._drain(losses,
                                             uniq + self._guard_ints())
            # the window closes only AFTER the drain: the timer never reads
            self._dev_timer.flush("epoch")
            dt = time.perf_counter() - t0
            if self.guard is not None:  # epoch boundary: exact skips
                self._guard_check(force=True, skips=ints_h[-1])
        self.hub.mark_epoch(e0)
        if not losses:          # resumed exactly on an epoch boundary
            return {"loss": 0.0, "time": dt, "uniq": 0.0,
                    "cache_hit": 0.0, "cache_refill": 0, "straggler": 0.0}
        ep = self.cache_meter.note_epoch(mark) if self.cache is not None \
            else {"hit_rate": 0.0, "refills": 0}
        return {"loss": float(np.mean(loss_h)), "time": dt,
                "uniq": float(np.mean(ints_h[:len(uniq)])),
                "cache_hit": ep["hit_rate"], "cache_refill": ep["refills"],
                "straggler": self.straggler.fraction_since(smark)}

    def train_steps(self, n: int, lr: Optional[float] = None) -> List[float]:
        """Consume exactly `n` batches (crossing epoch boundaries)."""
        lr = self.tcfg.learning_rate if lr is None else lr
        it = iter(self.stream)
        losses = [self._train_one(next(it), lr) for _ in range(n)]
        with obs_trace.span("steps_flush", cat="sync", n=n):
            loss_h, ints_h = self._drain(losses, self._guard_ints())
        self._dev_timer.flush("train_steps")
        if self.guard is not None:
            self._guard_check(force=True, skips=ints_h[-1])
        return loss_h.tolist()

    def evaluate(self, ids: np.ndarray) -> Dict:
        with obs_trace.span("eval", cat="eval", n_ids=len(ids)):
            return self._evaluate(ids)

    @torch.no_grad()
    def _evaluate(self, ids: np.ndarray) -> Dict:
        tot_l = torch.zeros((), dtype=torch.float32, device=self.device)
        tot_a = torch.zeros_like(tot_l)
        tot_n = torch.zeros_like(tot_l)
        for batch in eval_batches(
                self.graph, ids, self.tcfg.batch_size, self.fanouts,
                self.eval_caps, sampler=self.eval_sampler,
                seed=self.seed + 17, device_graph=self.g,
                labels=self.labels, device=self.device):
            logits = apply_gnn(self.cfg, self.params, batch, self.feats,
                               self.g.degrees, train=False,
                               feats_global=True, cache=self.cache)
            m = batch.label_mask.to(torch.float32)
            n = m.sum()
            tot_l += gnn_softmax_ce(logits, batch.labels, m) * n
            tot_a += accuracy(logits, batch.labels, m) * n
            tot_n += n
        l, a, n = torch.stack([tot_l, tot_a, tot_n]).tolist()
        return {"loss": l / max(n, 1), "acc": a / max(n, 1)}

    def _snapshot(self) -> List[torch.Tensor]:
        """A copy (never an alias) of the live parameters."""
        return [p.detach().clone() for p in self.params.parameters()]

    def fit(self, verbose: bool = False) -> TrainResult:
        stopper = EarlyStopping(self.tcfg.early_stop_patience)
        plateau = ReduceLROnPlateau(self.tcfg.learning_rate,
                                    self.tcfg.plateau_factor,
                                    self.tcfg.plateau_patience)
        history: List[EpochMetrics] = []
        best_val_acc = 0.0
        best_params = self._best_params if self._best_params is not None \
            else self._snapshot()
        lr = self.tcfg.learning_rate
        start_epoch = 0
        if self._fit_state:                   # resumed mid-training
            fs = self._fit_state
            lr, start_epoch = fs["lr"], fs["epoch"]
            best_val_acc = fs["best_val_acc"]
            plateau.lr, plateau.best, plateau.bad = fs["plateau"]
            stopper.best, stopper.bad, stopper.best_epoch = fs["stopper"]
        if stopper.bad >= stopper.patience:
            # the checkpoint came from an already finished (early-stopped)
            # run: don't train further from best_params
            start_epoch = self.tcfg.max_epochs
        t_start = time.perf_counter()
        for epoch in range(start_epoch, self.tcfg.max_epochs):
            em = self.run_epoch(lr)
            ev = self.evaluate(self.graph.val_ids)
            history.append(EpochMetrics(epoch, em["loss"], ev["loss"],
                                        ev["acc"], em["time"], em["uniq"],
                                        em["cache_hit"], em["cache_refill"],
                                        em["straggler"]))
            if verbose:
                print(f"  epoch {epoch:3d} loss={em['loss']:.4f} "
                      f"val={ev['acc']:.4f} t={em['time']:.2f}s "
                      f"uniq={em['uniq']:.0f} "
                      f"cache_hit={em['cache_hit']:.3f} "
                      f"refill={em['cache_refill']}")
            if ev["acc"] > best_val_acc:
                best_val_acc = ev["acc"]
                best_params = self._snapshot()
            lr = plateau.step(ev["loss"])
            stop = stopper.update(ev["loss"], epoch)
            self._best_params = best_params
            self._fit_state = {
                "lr": lr, "epoch": epoch + 1, "best_val_acc": best_val_acc,
                "plateau": [plateau.lr, plateau.best, plateau.bad],
                "stopper": [stopper.best, stopper.bad, stopper.best_epoch],
            }
            if stop:
                break
        total = time.perf_counter() - t_start
        with torch.no_grad():
            for p, b in zip(self.params.parameters(), best_params):
                p.copy_(b)
        if self.ckpt_dir:
            self.save()
        test = self.evaluate(self.graph.test_ids)

        def _mean(xs):                # empty when resuming a finished run
            return float(np.mean(xs)) if xs else 0.0

        uniq = _mean([h.mean_unique_nodes for h in history])
        return TrainResult(
            policy=self.policy.describe(),
            val_acc=best_val_acc,
            test_acc=test["acc"],
            epochs_to_converge=stopper.best_epoch + 1
            if stopper.best_epoch >= 0 else len(history),
            per_epoch_time_s=_mean([h.epoch_time_s for h in history]),
            total_time_s=total,
            mean_unique_nodes=uniq,
            feature_bytes_per_batch=uniq * self.graph.feat_dim * 4,
            caps=self.caps,
            history=history,
            cache=self.cache.describe() if self.cache is not None else "",
            cache_hit_rate=self.cache_meter.hit_rate,
            cache_refills=self.cache_meter.refills,
            straggler_fraction=self.straggler.straggler_fraction,
        )


def train_once(graph: Graph, cfg: GNNConfig, policy,
               tcfg: Optional[TrainConfig] = None, seed: int = 0,
               verbose: bool = False,
               calibrator: Optional[CapsCalibrator] = None,
               cache=None, pipeline: str = "sync", guard=None,
               device: DeviceLike = None) -> TrainResult:
    tcfg = tcfg or TrainConfig()
    tr = GNNTrainer(graph, cfg, tcfg, policy, seed=seed,
                    calibrator=calibrator, cache=cache, pipeline=pipeline,
                    guard=guard, device=device)
    try:
        return tr.fit(verbose)
    finally:
        if pipeline == "async":
            tr.stream.close()
