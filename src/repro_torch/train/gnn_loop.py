"""GNN mini-batch training loop (`repro/train/gnn_loop.py:84-178,
450-509,631-811`) — the paper's methodology (§5): AdamW(lr=1e-3,
wd=5e-4), batch 1024, fanout 10 per hop, up to 100 epochs, early stopping
on val loss (patience 6), ReduceLROnPlateau (patience 3); metrics: final
val acc, per-epoch time, epochs-to-converge, total time, and the Fig-6
working-set metric (mean unique input nodes / feature bytes).

Batches come from a `BatchStream` whose `Cursor(epoch, pos)` fixes every
draw; dropout generators derive from the same (seed, epoch, pos).

Guarded step: the step checks the loss and every grad for finiteness ON
DEVICE and applies no update on a non-finite step (a `torch.where` select
of params and optimizer state — no host sync); a device-resident
consecutive-skip counter (`skips`) counts such steps. The host reads
losses once per `train_steps` call or epoch, never per step.

Feature cache: `cache=` (a `repro_torch.featcache.CachePlan` or a static
admission name, built here against this trainer's policy, batch size,
fanouts and seed) routes every layer-0 feature read through the
device-resident cache (`gather_cached`). Cache rows are exact copies, so
the loss trajectory is bit-identical with the cache on and off. Each
batch's (hits, misses) stay on the device until the host read the loop
makes anyway, and feed `cache_meter`: the paper's §6.5 cache-locality
claim as a measured hit rate per epoch and per run. Evaluation reads
through the cache but never feeds the counters.

Not ported yet: checkpoints and resume, dynamic cache admission, the async
pipeline, guard escalation and rollback, tracing, sharded training.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import featcache, sampling
from repro_torch.batching import BatchStream, as_policy, make_policy
from repro_torch.batching.stream import (SALT_DROPOUT, cursor_generator,
                                         eval_batches)
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core import minibatch as mb
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.graphs.csr import DeviceGraph, Graph
from repro_torch.kernels.gather_cached.ops import cache_stats
from repro_torch.models.gnn.models import apply_gnn, init_gnn
from repro_torch.optim import adamw
from repro_torch.optim.schedule import EarlyStopping, ReduceLROnPlateau
from repro_torch.train.losses import accuracy, gnn_softmax_ce
from repro_torch.train.monitor import HitRateMeter


@dataclass
class EpochMetrics:
    epoch: int
    train_loss: float
    val_loss: float
    val_acc: float
    epoch_time_s: float
    mean_unique_nodes: float
    cache_hit_rate: float = 0.0     # measured; 0 = no cache


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


class GNNTrainer:
    """One (graph, model, policy) training run over a `BatchStream`, on
    `device` — the CUDA device unless the caller passes another.
    `cfg.model` is any of sage, gcn and gat."""

    def __init__(self, graph: Graph, cfg: GNNConfig, tcfg: TrainConfig,
                 policy, caps=None, eval_caps=None, seed: int = 0,
                 cache=None, cache_capacity: Optional[int] = None,
                 cache_frac: float = 0.2, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.graph = graph
        self.cfg = cfg
        self.tcfg = tcfg
        self.policy = as_policy(policy)
        self.seed = seed
        self.g = DeviceGraph.from_graph(graph, self.device)
        self.feats = torch.as_tensor(graph.features,
                                     dtype=torch.float32).to(self.device)
        self.labels = torch.as_tensor(graph.labels,
                                      dtype=torch.int32).to(self.device)
        self.fanouts = tuple(cfg.fanout[:cfg.num_layers])
        # caps are calibrated per (policy, sampler) with the copied numpy
        # probe, so they equal the reference's for the same seed
        self.caps = tuple(caps or mb.calibrate_caps(
            graph, self.policy, tcfg.batch_size, self.fanouts, seed=seed))
        # eval always uses the uniform policy (identical across compared
        # policies)
        self.eval_policy = make_policy("rand")
        self.eval_sampler = sampling.for_policy(self.eval_policy)
        self.eval_caps = tuple(eval_caps or mb.calibrate_caps(
            graph, self.eval_policy, tcfg.batch_size, self.fanouts,
            seed=seed + 1))
        self.params = init_gnn(cfg, torch.Generator().manual_seed(seed),
                               self.device)
        self.opt_state = adamw.init(list(self.params.parameters()))
        self.skips = torch.zeros((), dtype=torch.int32, device=self.device)
        self.cache = featcache.as_cache(
            cache, graph, capacity=cache_capacity, frac=cache_frac,
            policy=self.policy, batch_size=tcfg.batch_size,
            fanouts=self.fanouts, seed=seed, device=self.device)
        self.cache_meter = HitRateMeter()
        self._pending_stats: List[torch.Tensor] = []   # (2,) int32 each
        self.stream = BatchStream(
            graph, self.policy, tcfg.batch_size, self.fanouts, self.caps,
            seed=seed, device_graph=self.g, labels=self.labels,
            cache=self.cache, device=self.device)
        self.global_step = 0

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

    def _train_one(self, batch: mb.MiniBatch, lr: float) -> torch.Tensor:
        loss, _ = self.train_step(batch, lr, self._dropout_gens())
        if self.cache is not None:
            # the counters stay on the device until `_drain`
            self._pending_stats.append(torch.stack(cache_stats(
                self.cache.pos, batch.node_ids, self.graph.num_nodes)))
        self.global_step += 1
        return loss

    def _drain(self, losses: List[torch.Tensor],
               ints: Sequence[torch.Tensor] = ()):
        """The one host read after a run of steps (it drains the device):
        the float32 losses, the 0-d integer metrics `ints` and the pending
        cache counters in one copy, the integers bit-cast to float32 for
        it. The counters feed `cache_meter`. Returns the losses and `ints`
        as numpy arrays."""
        stats, self._pending_stats = self._pending_stats, []
        n, k = len(losses), len(ints)
        parts = [torch.stack(losses)]
        if k or stats:
            parts.append(torch.cat([t.reshape(-1).to(torch.int32)
                                    for t in (*ints, *stats)])
                         .view(torch.float32))
        host = torch.cat(parts).cpu().numpy()
        rest = host[n:].view(np.int32)
        for hits, misses in rest[k:].reshape(-1, 2):
            self.cache_meter.observe(hits, misses)
        return host[:n], rest[:k]

    # -- loops --------------------------------------------------------------
    def run_epoch(self, lr: float) -> Dict:
        """Consume the remainder of the stream's current epoch."""
        t0 = time.perf_counter()
        mark = self.cache_meter.mark()
        losses, uniq = [], []
        for batch in self.stream.epoch():
            losses.append(self._train_one(batch, lr))
            uniq.append(batch.num_unique)
        if not losses:          # resumed exactly on an epoch boundary
            return {"loss": 0.0, "time": time.perf_counter() - t0,
                    "uniq": 0.0, "cache_hit": 0.0}
        loss_h, uniq_h = self._drain(losses, uniq)
        hit = self.cache_meter.note_epoch(mark)["hit_rate"] \
            if self.cache is not None else 0.0
        return {"loss": float(np.mean(loss_h)),
                "time": time.perf_counter() - t0,
                "uniq": float(np.mean(uniq_h)), "cache_hit": hit}

    def train_steps(self, n: int, lr: Optional[float] = None) -> List[float]:
        """Consume exactly `n` batches (crossing epoch boundaries)."""
        lr = self.tcfg.learning_rate if lr is None else lr
        it = iter(self.stream)
        losses = [self._train_one(next(it), lr) for _ in range(n)]
        return self._drain(losses)[0].tolist() if losses else []

    @torch.no_grad()
    def evaluate(self, ids: np.ndarray) -> Dict:
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

    def _snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone()
                for k, v in self.params.state_dict().items()}

    def fit(self, verbose: bool = False) -> TrainResult:
        stopper = EarlyStopping(self.tcfg.early_stop_patience)
        plateau = ReduceLROnPlateau(self.tcfg.learning_rate,
                                    self.tcfg.plateau_factor,
                                    self.tcfg.plateau_patience)
        history: List[EpochMetrics] = []
        best_val_acc = 0.0
        best_params = self._snapshot()
        lr = self.tcfg.learning_rate
        t_start = time.perf_counter()
        for epoch in range(self.tcfg.max_epochs):
            em = self.run_epoch(lr)
            ev = self.evaluate(self.graph.val_ids)
            history.append(EpochMetrics(epoch, em["loss"], ev["loss"],
                                        ev["acc"], em["time"], em["uniq"],
                                        em["cache_hit"]))
            if verbose:
                print(f"  epoch {epoch:3d} loss={em['loss']:.4f} "
                      f"val={ev['acc']:.4f} t={em['time']:.2f}s "
                      f"uniq={em['uniq']:.0f}")
            if ev["acc"] > best_val_acc:
                best_val_acc = ev["acc"]
                best_params = self._snapshot()
            lr = plateau.step(ev["loss"])
            if stopper.update(ev["loss"], epoch):
                break
        total = time.perf_counter() - t_start
        self.params.load_state_dict(best_params)
        test = self.evaluate(self.graph.test_ids)

        def _mean(xs):
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
        )


def train_once(graph: Graph, cfg: GNNConfig, policy,
               tcfg: Optional[TrainConfig] = None, seed: int = 0,
               verbose: bool = False,
               device: DeviceLike = None) -> TrainResult:
    tcfg = tcfg or TrainConfig()
    return GNNTrainer(graph, cfg, tcfg, policy, seed=seed,
                      device=device).fit(verbose)
