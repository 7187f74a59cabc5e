"""LM train / eval / serve step factories
(`repro/train/train_step.py:33-116`): closures over the config. The
reference jit-compiles them; PyTorch runs eagerly.

`make_train_step` builds the full step: forward (remat, chunked CE) ->
backward -> global-norm clip -> AdamW -> new params / opt. Parameters are
the transformer's dict tree of float32 masters; the step returns new
trees and never writes the old ones. With `microbatches` > 1 the batch is
split on dim 0 and each part's loss / n runs its own backward (the
gradients add up in the masters' `.grad`, as the reference's gradient of
the summed loss does), so that activations do not pile up. The serve
steps run under `torch.no_grad()`. There is no mesh in the port yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs import ModelConfig, TrainConfig
from repro_torch.models.lm import transformer
from repro_torch.optim import adamw
from repro_torch.train.losses import chunked_cross_entropy


def loss_fn(cfg: ModelConfig, params, batch, remat=True):
    """(ce + aux, (ce, aux)); the head is the tied embedding's transpose
    (or `head`) cast to the hidden dtype, as the reference casts it."""
    hidden, aux = transformer.apply(cfg, params, batch, remat=remat)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    ce = chunked_cross_entropy(hidden, head.to(hidden.dtype),
                               batch["labels"], batch.get("mask"))
    return ce + aux, (ce, aux)


def value_and_grad(cfg: ModelConfig, params, batch, remat=True,
                   microbatches: int = 1) -> Tuple[torch.Tensor, Tuple, Dict]:
    """(loss, (ce, aux), grads): the loss averaged over `microbatches`
    equal parts of dim 0 (the first part's ce and aux, as the reference
    returns), grads in the params' structure, float32."""
    transformer.check_trainable(cfg)
    live = adamw.tree_map(lambda t: t.detach().requires_grad_(True), params)
    if microbatches <= 1:
        loss, (ce, aux) = loss_fn(cfg, live, batch, remat)
        loss.backward()
    else:
        parts = {k: v.reshape(microbatches, -1, *v.shape[1:])
                 for k, v in batch.items()}
        loss = None
        for i in range(microbatches):
            sub = {k: v[i] for k, v in parts.items()}
            li, extra = loss_fn(cfg, live, sub, remat)
            (li / microbatches).backward()
            if i == 0:
                loss, (ce, aux) = li.detach(), extra
            else:
                loss = loss + li.detach()
        loss = loss / microbatches
    grads = adamw.tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, live)
    return loss.detach(), (ce.detach(), aux.detach()), grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, lr: float = None):
    """step(params, opt, batch) -> (params, opt, metrics {"loss", "ce",
    "aux", "grad_norm"}), metrics as 0-d tensors on the device (no read on
    the host)."""
    base_lr = lr if lr is not None else tcfg.learning_rate

    def step(params, opt_state, batch):
        loss, (ce, aux), grads = value_and_grad(
            cfg, params, batch, tcfg.remat, tcfg.microbatches)
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip)
        new_params, new_opt = adamw.update(
            grads, opt_state, params, lr=base_lr,
            weight_decay=tcfg.weight_decay)
        return new_params, new_opt, {"loss": loss, "ce": ce, "aux": aux,
                                     "grad_norm": gnorm}
    return step


def make_eval_step(cfg: ModelConfig):
    def step(params, batch):
        with torch.no_grad():
            loss, (ce, _) = loss_fn(cfg, params, batch, remat=False)
        return {"loss": loss, "ce": ce}
    return step


def make_prefill_step(cfg: ModelConfig):
    def step(params, batch):
        with torch.no_grad():
            return transformer.prefill(cfg, params, batch)
    return step


def make_decode_step(cfg: ModelConfig):
    def step(params, cache, tokens, pos):
        with torch.no_grad():
            return transformer.decode_step(cfg, params, cache, tokens, pos)
    return step
