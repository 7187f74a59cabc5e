"""Host-side LR schedule and early stopping
(`repro/optim/schedule.py:17-58`): `ReduceLROnPlateau` mirrors the paper's
training methodology (PyTorch defaults, patience=3)."""
from __future__ import annotations

import math


class ReduceLROnPlateau:
    """Host-side plateau scheduler (paper §5: factor=0.1, patience=3)."""

    def __init__(self, base_lr: float, factor: float = 0.1,
                 patience: int = 3, min_lr: float = 1e-6):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = math.inf
        self.bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best - 1e-6:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad = 0
        return self.lr


class EarlyStopping:
    """Stop when val loss hasn't improved for `patience` epochs (paper: 6)."""

    def __init__(self, patience: int = 6):
        self.patience = patience
        self.best = math.inf
        self.bad = 0
        self.best_epoch = -1

    def update(self, metric: float, epoch: int) -> bool:
        """Returns True if training should stop."""
        if metric < self.best - 1e-6:
            self.best = metric
            self.bad = 0
            self.best_epoch = epoch
            return False
        self.bad += 1
        return self.bad >= self.patience
