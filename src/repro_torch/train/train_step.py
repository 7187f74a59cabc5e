"""LM serve step factories (`repro/train/train_step.py:102-116`): thin
closures over the config. The reference jit-compiles them; PyTorch runs
eagerly, under `torch.no_grad()` (the serving path is forward only). The
LM train step is a later slice."""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.lm import transformer


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
