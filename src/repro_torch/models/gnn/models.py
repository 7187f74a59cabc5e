"""GraphSAGE on static-shape mini-batch towers
(`repro/models/gnn/models.py:39-90,150-224`).

Every layer consumes a `Block` (dense (n_dst, fanout) source-position
gather + self position), so aggregation is a per-edge-weighted reduce over
the fanout axis — the shape of the fused `gather_agg` op. SAGE's masked
mean is weights `mask / count` over one `gather_agg` call.

`apply_gnn(..., feats_global=True)` composes layer-0 source positions with
`batch.node_ids` and gathers input features straight from the global
(N, F) feature matrix: no (cap_L, F) copy is made, and the per-batch
feature reads are the paper's Fig-6 working set.

Parameters keep the reference's layout — weights `(din, dout)` for
`x @ W` — so `params_from_jax` / `params_to_jax` carry them across without
transposes. GCN and GAT are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.configs import GNNConfig
from repro_torch.core.minibatch import MiniBatch
from repro_torch.kernels.gather_agg.ops import gather_agg


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32) -> torch.Tensor:
    """LeCun-normal (`repro/models/lm/common.py:11`), drawn from `gen` on
    the CPU."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    return torch.randn(shape, generator=gen, dtype=dtype) \
        * (1.0 / np.sqrt(fan_in))


class SageLayer(nn.Module):
    def __init__(self, w_self: torch.Tensor, w_neigh: torch.Tensor,
                 b: torch.Tensor):
        super().__init__()
        self.w_self = nn.Parameter(w_self)
        self.w_neigh = nn.Parameter(w_neigh)
        self.b = nn.Parameter(b)


class GNN(nn.Module):
    """The parameters of a GraphSAGE stack; `apply_gnn` is the forward."""

    def __init__(self, layers: Sequence[SageLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def init_gnn(cfg: GNNConfig, gen: torch.Generator,
             device=None) -> GNN:
    """Fresh parameters drawn from the CPU generator `gen` (so a CPU and a
    CUDA model built from one seed start equal), then moved to `device`.
    The draws are the port's own, not the reference's threefry bits."""
    if cfg.model != "sage":
        raise ValueError(f"model {cfg.model!r} is not ported yet")
    dims = [cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) \
        + [cfg.num_classes]
    layers = []
    for i in range(cfg.num_layers):
        din, dout = dims[i], dims[i + 1]
        layers.append(SageLayer(dense_init(gen, (din, dout)),
                                dense_init(gen, (din, dout)),
                                torch.zeros((dout,))))
    return GNN(layers).to(device)


def params_from_jax(tree: Dict, device=None) -> GNN:
    """The reference's `init_gnn` tree `{"layers": [{"w_self", "w_neigh",
    "b"}, ...]}` (numpy leaves) -> the port's model, same values."""
    def t(a):
        return torch.as_tensor(np.array(a, np.float32))

    return GNN([SageLayer(t(p["w_self"]), t(p["w_neigh"]), t(p["b"]))
                for p in tree["layers"]]).to(device)


def params_to_jax(model: GNN) -> Dict:
    """The inverse of `params_from_jax`: numpy leaves in the reference's
    tree layout."""
    return {"layers": [{k: getattr(layer, k).detach().cpu().numpy()
                        for k in ("w_self", "w_neigh", "b")}
                       for layer in model.layers]}


def _masked_mean(x_tab, src_idx, edge_mask):
    """(n_dst, r)-indexed mean over valid neighbor slots -> (n_dst, F)."""
    m = edge_mask.to(torch.float32)
    w = m / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    return gather_agg(x_tab, src_idx, w).to(x_tab.dtype)


def sage_layer(p: SageLayer, x_tab, src_idx, self_idx, edge_mask):
    h_self = x_tab[self_idx]
    h_nbr = _masked_mean(x_tab, src_idx, edge_mask)
    return h_self @ p.w_self + h_nbr @ p.w_neigh + p.b


def apply_gnn(cfg: GNNConfig, params: GNN, batch: MiniBatch, x, *,
              train: bool = False,
              dropout_gens: Optional[List[torch.Generator]] = None,
              feats_global: bool = False):
    """Returns logits aligned with batch.roots order.

    x: with feats_global=False, the pre-gathered (cap_L, in_dim) input
    level; with feats_global=True, the FULL (N, in_dim) feature matrix,
    read by layer 0 through composed `node_ids[src_pos]` indices.
    `dropout_gens[i]` draws layer i's dropout mask (training only).
    """
    if cfg.model != "sage":
        raise ValueError(f"model {cfg.model!r} is not ported yet")
    if not feats_global:
        x = x * batch.node_mask[:, None].to(x.dtype)
    L = len(batch.blocks)
    for i, block in enumerate(batch.blocks):
        if i == 0 and feats_global:
            gid = torch.clamp(batch.node_ids, max=x.shape[0] - 1)
            src_idx = gid[block.src_pos]
            self_idx = gid[block.self_pos]
        else:
            src_idx, self_idx = block.src_pos, block.self_pos
        x = sage_layer(params.layers[i], x, src_idx, self_idx,
                       block.edge_mask)
        x = x * block.dst_mask[:, None].to(x.dtype)
        if i < L - 1:
            x = torch.relu(x)
            if train and cfg.dropout > 0 and dropout_gens is not None:
                keep = 1.0 - cfg.dropout
                u = torch.rand(x.shape, generator=dropout_gens[i],
                               device=x.device)
                x = torch.where(u < keep, x / keep, 0.0)
    return x
