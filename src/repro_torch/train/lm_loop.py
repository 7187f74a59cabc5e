"""Fault-tolerant LM training loop (`repro/train/lm_loop.py:28-122`):
checkpoint / resume, retry, straggler monitoring, optional int8 gradient
compression with error feedback.

`LMTrainer` trains on `device` (the card unless given); its parameters
are drawn on a CPU generator, so a CPU and a CUDA trainer start equal.
Checkpoints hold the reference's state `{"params", "opt", "err"}` with the
stream's cursor in `extra`, in the reference's on-disk format
(`train/checkpoint.py`). A mesh (the reference's `mesh=` and
`elastic_reshard`) waits for the port's distributed slice: a mesh raises.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from repro_torch.configs import ModelConfig, TrainConfig
from repro_torch.data.pipeline import Cursor, LMStream
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models.lm import transformer
from repro_torch.optim import adamw
from repro_torch.optim.compression import (compress_decompress,
                                           init_error_feedback)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.monitor import StragglerMonitor, resilient_step
from repro_torch.train.train_step import value_and_grad


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: sharded LM training waits for the "
            "port's distributed slice")


def make_ft_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """step(params, opt, err, batch, lr) -> (params, opt, err, metrics):
    the train step with optional error-feedback gradient compression.
    Like the reference's, it takes the whole batch at once (no
    microbatches)."""
    _no_mesh(mesh)

    def step(params, opt_state, err, batch, lr):
        loss, (ce, _), grads = value_and_grad(cfg, params, batch, tcfg.remat)
        if tcfg.grad_compression:
            grads, err = compress_decompress(grads, err)
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip)
        params, opt_state = adamw.update(grads, opt_state, params, lr=lr,
                                         weight_decay=tcfg.weight_decay)
        return params, opt_state, err, {"loss": loss, "ce": ce,
                                        "grad_norm": gnorm}
    return step


class LMTrainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, stream: LMStream,
                 ckpt_dir: Optional[str] = None, mesh=None,
                 ckpt_every: int = 50, seed: int = 0,
                 device: DeviceLike = None):
        _no_mesh(mesh)
        self.device = resolve_device(device)
        self.cfg, self.tcfg, self.stream = cfg, tcfg, stream
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.step_fn = make_ft_train_step(cfg, tcfg)
        self.params = transformer.init(
            cfg, torch.Generator().manual_seed(seed), device=self.device)
        self.opt = adamw.init(self.params)
        self.err = init_error_feedback(self.params) \
            if tcfg.grad_compression else \
            {"_": torch.zeros((1,), device=self.device)}
        self.step = 0
        self.monitor = StragglerMonitor()
        self.history = []
        if ckpt_dir:
            self._try_resume()

    # -- checkpoint / resume ----------------------------------------------
    def _state(self):
        return {"params": self.params, "opt": self.opt, "err": self.err}

    def _try_resume(self):
        step, tree, extra = ckpt.restore_latest(self.ckpt_dir, self._state())
        if step is None:
            return
        self.params, self.opt, self.err = (tree["params"], tree["opt"],
                                           tree["err"])
        self.step = step
        self.stream.cursor = Cursor.from_state(extra["cursor"])

    def save(self):
        if not self.ckpt_dir:
            return
        ckpt.save(self.ckpt_dir, self.step, self._state(),
                  extra={"cursor": self.stream.cursor.state()})

    # -- run ----------------------------------------------------------------
    def run(self, num_steps: int, lr: Optional[float] = None,
            fail_hook=None) -> Dict:
        """`num_steps` steps; each reads its loss on the host (the
        straggler monitor times the step through that read). Returns the
        reference's keys."""
        lr = lr if lr is not None else self.tcfg.learning_rate
        it = iter(self.stream)
        losses = []
        target = self.step + num_steps
        while self.step < target:
            toks, labels = next(it)
            batch = {"tokens": torch.from_numpy(toks).to(self.device),
                     "labels": torch.from_numpy(labels).to(self.device)}
            t0 = time.perf_counter()

            def do_step():
                if fail_hook is not None:
                    fail_hook(self.step)
                return self.step_fn(self.params, self.opt, self.err, batch,
                                    lr)

            (self.params, self.opt, self.err, m), _ = resilient_step(
                do_step, max_retries=2, on_give_up=self.save)
            losses.append(float(m["loss"]))
            self.monitor.observe(time.perf_counter() - t0, self.step)
            self.step += 1
            if self.ckpt_dir and self.step % self.ckpt_every == 0:
                self.save()
        if self.ckpt_dir:
            self.save()
        self.history.extend(losses)
        return {"loss_first": losses[0], "loss_last": losses[-1],
                "losses": losses,
                "straggler_fraction": self.monitor.straggler_fraction}
