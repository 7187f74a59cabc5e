"""GNN model zoo on static-shape mini-batch towers
(`repro/models/gnn/models.py`): GraphSAGE (the paper's primary model),
GCN and GAT (paper §6.4).

Every layer consumes a `Block` (dense (n_dst, fanout) source-position
gather + self position), and expresses its aggregation as scalar per-edge
weights over one `gather_agg` call — SAGE: mask / count; GCN: the folded
degree normalisers; GAT: the attention alphas, with the heads folded into
the row axis so that alpha's gradient flows through the dw kernel. The
(n_dst, fanout, F) gather never materialises on CUDA, forward or backward.

`apply_gnn(..., feats_global=True)` composes layer-0 source positions with
`batch.node_ids` and gathers input features straight from the global
(N, F) feature matrix: no (cap_L, F) copy is made, and the per-batch
feature reads are the paper's Fig-6 working set. GAT projects every unique
source row before it gathers, so it materialises the input level once.
With a feature cache (`cache=`), the input level is materialised once per
batch through the two-level `gather_cached` kernel instead.

Parameters keep the reference's layout — weights `(din, dout)` for
`x @ W` — so `params_from_jax` / `params_to_jax` carry them across without
transposes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs import GNNConfig
from repro_torch.core.minibatch import MiniBatch
from repro_torch.kernels.gather_agg.ops import (DxPlan, gather_agg,
                                                gather_rows,
                                                gather_sorted_rows)
from repro_torch.kernels.gather_cached.ops import gather_cached
from repro_torch.kernels.gather_mean.ops import gather_mean
from repro_torch.models.lm.common import dense_init


class SageLayer(nn.Module):
    def __init__(self, w_self: torch.Tensor, w_neigh: torch.Tensor,
                 b: torch.Tensor):
        super().__init__()
        self.w_self = nn.Parameter(w_self)
        self.w_neigh = nn.Parameter(w_neigh)
        self.b = nn.Parameter(b)


class GcnLayer(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class GatLayer(nn.Module):
    """`w` (din, H*dh), `a_src`/`a_dst` (H, dh), `b` (H*dh,), and `w_out`
    (H*dh, dout) where H*dh != dout, else None."""

    def __init__(self, w: torch.Tensor, a_src: torch.Tensor,
                 a_dst: torch.Tensor, b: torch.Tensor,
                 w_out: Optional[torch.Tensor]):
        super().__init__()
        self.w = nn.Parameter(w)
        self.a_src = nn.Parameter(a_src)
        self.a_dst = nn.Parameter(a_dst)
        self.b = nn.Parameter(b)
        self.w_out = None if w_out is None else nn.Parameter(w_out)


Layer = Union[SageLayer, GcnLayer, GatLayer]
MODELS = ("sage", "gcn", "gat")
# each layer type's parameters, in the reference's key order
_KEYS = {SageLayer: ("w_self", "w_neigh", "b"), GcnLayer: ("w", "b"),
         GatLayer: ("w", "a_src", "a_dst", "b", "w_out")}


class GNN(nn.Module):
    """The parameters of a SAGE, GCN or GAT stack; `apply_gnn` is the
    forward."""

    def __init__(self, layers: Sequence[Layer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def init_gnn(cfg: GNNConfig, gen: torch.Generator,
             device=None) -> GNN:
    """Fresh parameters drawn from the CPU generator `gen` (so a CPU and a
    CUDA model built from one seed start equal), then moved to `device`.
    The draws are the port's own, not the reference's threefry bits."""
    dims = [cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) \
        + [cfg.num_classes]
    layers: List[Layer] = []
    for i in range(cfg.num_layers):
        din, dout = dims[i], dims[i + 1]
        if cfg.model == "sage":
            layers.append(SageLayer(dense_init(gen, (din, dout)),
                                    dense_init(gen, (din, dout)),
                                    torch.zeros((dout,))))
        elif cfg.model == "gcn":
            layers.append(GcnLayer(dense_init(gen, (din, dout)),
                                   torch.zeros((dout,))))
        elif cfg.model == "gat":
            H = cfg.gat_heads
            dh = max(dout // H, 1)
            layers.append(GatLayer(
                dense_init(gen, (din, H * dh)),
                dense_init(gen, (H, dh)) * 0.1,
                dense_init(gen, (H, dh)) * 0.1,
                torch.zeros((H * dh,)),
                dense_init(gen, (H * dh, dout)) if H * dh != dout else None))
        else:
            raise ValueError(f"unknown model {cfg.model!r}")
    return GNN(layers).to(device)


def params_from_jax(tree: Dict, device=None) -> GNN:
    """The reference's `init_gnn` tree `{"layers": [{...}, ...]}` (numpy
    leaves; GAT's `w_out` may be None) -> the port's model, same values.
    Each layer's type follows from its keys."""
    def t(a):
        return None if a is None else torch.as_tensor(np.array(a, np.float32))

    layers: List[Layer] = []
    for p in tree["layers"]:
        cls = SageLayer if "w_self" in p else \
            GatLayer if "a_src" in p else GcnLayer
        layers.append(cls(*(t(p.get(k)) for k in _KEYS[cls])))
    return GNN(layers).to(device)


def params_to_jax(model: GNN) -> Dict:
    """The inverse of `params_from_jax`: numpy leaves (None for a missing
    `w_out`) in the reference's tree layout."""
    def a(v):
        return None if v is None else v.detach().cpu().numpy()

    return {"layers": [{k: a(getattr(layer, k)) for k in _KEYS[type(layer)]}
                       for layer in model.layers]}


def param_tree(model: GNN, tensors: Sequence[torch.Tensor]) -> Dict:
    """`tensors`, one per parameter in `model.parameters()` order (the
    parameters themselves, or AdamW's moments), in the reference's tree
    layout `{"layers": [{key: tensor}, ...]}`; GAT's missing `w_out` is
    None. The checkpoint walk takes leaves and paths from this tree."""
    it = iter(tensors)
    return {"layers": [{k: None if getattr(layer, k) is None else next(it)
                        for k in _KEYS[type(layer)]}
                       for layer in model.layers]}


def tree_tensors(tree: Dict) -> List[torch.Tensor]:
    """The inverse of `param_tree`: the leaves in `parameters()` order."""
    return [v for layer in tree["layers"] for v in layer.values()
            if v is not None]


def sage_layer(p: SageLayer, x_tab, src_idx, self_idx, edge_mask,
               plan: Optional[DxPlan] = None):
    """`plan`: the `DxPlan` of src_idx, if the caller shares it. self_idx
    must be non-decreasing (a block's self positions are)."""
    h_self = gather_sorted_rows(x_tab, self_idx)
    h_nbr = gather_mean(x_tab, src_idx, edge_mask, plan).to(x_tab.dtype)
    return h_self @ p.w_self + h_nbr @ p.w_neigh + p.b


def gcn_layer(p: GcnLayer, x_tab, src_idx, self_idx, edge_mask,
              deg_src_edge, deg_dst, plan: Optional[DxPlan] = None):
    """Symmetric-normalised aggregation with self loops (global degrees).

    All normalisers fold into the per-edge weight: mask * rsqrt(deg_src+1)
    * (deg_dst / sampled_count) * rsqrt(deg_dst+1) — deg_dst/count
    compensates fanout subsampling."""
    m = edge_mask.to(torch.float32)
    cnt = torch.clamp(edge_mask.sum(dim=1, keepdim=True, dtype=torch.int32),
                      min=1)
    c_src = torch.rsqrt(deg_src_edge.to(torch.float32) + 1.0)
    c_dst = torch.rsqrt(deg_dst.to(torch.float32) + 1.0)
    w = m * c_src * (deg_dst[:, None] / cnt) * c_dst[:, None]
    agg = gather_agg(x_tab, src_idx, w, plan).to(x_tab.dtype)
    h_self = gather_sorted_rows(x_tab, self_idx) \
        * (c_dst * c_dst)[:, None].to(x_tab.dtype)
    return (agg + h_self) @ p.w + p.b


def gat_layer(p: GatLayer, x_tab, src_idx, self_idx, edge_mask,
              plan: Optional[DxPlan] = None):
    """The reference's head-folded path (`impl == "pallas"`): row s*H + h
    of `zf` is head h of source s, so one `gather_agg` call reduces all
    heads, and alpha's gradient flows through the dw kernel. `plan` (the
    `DxPlan` of src_idx) serves both backwards over src_idx: e_src's and,
    folded to H heads, the aggregate's."""
    H, dh = p.a_src.shape
    n_dst, r = src_idx.shape
    z = (x_tab @ p.w).reshape(-1, H, dh)              # (n_src, H, dh)
    # per-source attention logits: scores are linear in z, so gather the
    # (n_src, H) scalars instead of (n_dst, r, H, dh) projected rows
    s_src = (z * p.a_src).sum(dim=-1)
    z_self = gather_sorted_rows(z, self_idx)          # (n_dst, H, dh)
    e_src = gather_rows(s_src, src_idx, plan)         # (n_dst, r, H)
    e_dst = (z_self * p.a_dst).sum(dim=-1)
    e_self = (z_self * p.a_src).sum(dim=-1) + e_dst
    e = nn.functional.leaky_relu(e_src + e_dst[:, None], 0.2)
    e = torch.where(edge_mask[..., None], e, -1e30)
    e_all = torch.cat(
        [e, nn.functional.leaky_relu(e_self, 0.2)[:, None]], dim=1)
    alpha = torch.softmax(e_all, dim=1)               # (n_dst, r+1, H)
    a_nbr, a_self = alpha[:, :r], alpha[:, r]
    zf = z.reshape(-1, dh)
    heads = torch.arange(H, dtype=src_idx.dtype, device=src_idx.device)
    idx2 = src_idx[:, None, :] * H + heads[None, :, None]
    w2 = a_nbr.transpose(1, 2)                        # (n_dst, H, r)
    out = gather_agg(zf, idx2.reshape(n_dst * H, r),
                     w2.reshape(n_dst * H, r),
                     None if plan is None else plan.folded(H)
                     ).reshape(n_dst, H, dh)
    out = out + a_self[..., None] * z_self
    out = out.reshape(n_dst, H * dh) + p.b
    if p.w_out is not None:
        out = out @ p.w_out
    return out


def apply_gnn(cfg: GNNConfig, params: GNN, batch: MiniBatch, x,
              degrees: Optional[torch.Tensor] = None, *,
              train: bool = False,
              dropout_gens: Optional[List[torch.Generator]] = None,
              feats_global: bool = False, cache=None):
    """Returns logits aligned with batch.roots order.

    x: with feats_global=False, the pre-gathered (cap_L, in_dim) input
    level; with feats_global=True, the FULL (N, in_dim) feature matrix,
    read by layer 0 through composed `node_ids[src_pos]` indices (GAT
    materialises the input level from it once). `degrees`: the global
    (N,) degree array, which GCN needs. `dropout_gens[i]` draws layer i's
    dropout mask (training only).

    cache: an optional `repro_torch.featcache.CachePlan` (anything with
    `.cache` (C, in_dim) rows and `.pos` (N,) map; requires
    feats_global=True). Layer 0 then reads the input level, assembled once
    per batch by `gather_cached` from the cache on hit and the global
    matrix on miss. Cache rows are exact copies, so the outputs equal the
    uncached path's bit for bit.
    """
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.model == "gcn" and degrees is None:
        raise ValueError("gcn needs the global degree array (degrees=)")
    if cache is not None:
        if not feats_global:
            raise ValueError("cache= requires feats_global=True "
                             "(x must be the full (N, F) feature matrix)")
        x = gather_cached(cache.cache, x, cache.pos, batch.node_ids)[0] \
            * batch.node_mask[:, None].to(x.dtype)
        feats_global = False
    elif not feats_global:
        x = x * batch.node_mask[:, None].to(x.dtype)
    elif cfg.model == "gat":
        # GAT projects every unique source row before gathering (projecting
        # per edge would multiply the matmul flops by the fanout), so the
        # input level is materialised once here
        x = x[torch.clamp(batch.node_ids, max=x.shape[0] - 1)] \
            * batch.node_mask[:, None].to(x.dtype)
        feats_global = False
    L = len(batch.blocks)
    for i, block in enumerate(batch.blocks):
        p = params.layers[i]
        if i == 0 and feats_global:
            gid = torch.clamp(batch.node_ids, max=x.shape[0] - 1)
            src_idx = gid[block.src_pos]
            self_idx = gid[block.self_pos]
        else:
            src_idx, self_idx = block.src_pos, block.self_pos
        # one backward sort of src_idx per layer, shared by its ops
        plan = DxPlan(src_idx, x.shape[0])
        if cfg.model == "sage":
            x = sage_layer(p, x, src_idx, self_idx, block.edge_mask, plan)
        elif cfg.model == "gcn":
            # per-level degrees gathered from the global degree array;
            # blocks[i] maps level (L-i) -> (L-i-1)
            n = degrees.shape[0]
            d_src = degrees[torch.clamp(batch.levels[L - i], max=n - 1)]
            deg_dst = degrees[torch.clamp(batch.levels[L - i - 1],
                                          max=n - 1)]
            x = gcn_layer(p, x, src_idx, self_idx, block.edge_mask,
                          d_src[block.src_pos], deg_dst, plan)
        else:
            x = gat_layer(p, x, src_idx, self_idx, block.edge_mask, plan)
        x = x * block.dst_mask[:, None].to(x.dtype)
        if i < L - 1:
            x = torch.relu(x)
            if train and cfg.dropout > 0 and dropout_gens is not None:
                keep = 1.0 - cfg.dropout
                u = torch.rand(x.shape, generator=dropout_gens[i],
                               device=x.device)
                x = torch.where(u < keep, x / keep, 0.0)
    return x
