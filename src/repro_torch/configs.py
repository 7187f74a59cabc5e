"""GNN and training configs (`repro/configs/base.py:162-212`) and the
paper's GraphSAGE config (`repro/configs/graphsage.py`).

`GNNConfig` drops the reference's `agg_impl` knob: the port dispatches the
gather-aggregate by the tensor's device (the hand-written kernel on CUDA,
the plain PyTorch version on the CPU). `TrainConfig` keeps the GNN
trainer's fields; the LM trainer's extras are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class GNNConfig:
    name: str
    model: str = "sage"              # sage (gcn | gat: not ported yet)
    num_layers: int = 3
    hidden_dim: int = 256
    in_dim: int = 602
    num_classes: int = 41
    fanout: Tuple[int, ...] = (10, 10, 10)
    gat_heads: int = 4
    dropout: float = 0.5
    dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 1024
    learning_rate: float = 1e-3
    weight_decay: float = 5e-4
    max_epochs: int = 100
    early_stop_patience: int = 6
    plateau_patience: int = 3
    plateau_factor: float = 0.1
    seed: int = 0


# Paper §5: DGL reference defaults (batch=1024, fanout=10, lr=1e-3,
# weight_decay=5e-4, hidden=256) — the paper's primary model.
CONFIG = GNNConfig(
    name="graphsage",
    model="sage",
    num_layers=3,
    hidden_dim=256,
    in_dim=602,                   # reddit-like
    num_classes=41,
    fanout=(10, 10, 10),
)
