"""AdamW over a list or a dict tree of tensors (`repro/optim/adamw.py`): the
same decoupled-decay formula (`adamw.py:43`), float32 state, a float32
`b ** count` bias correction, and the LM trainer's global-norm clipping
(`adamw.py:18-29`).

A tree is a tensor, a list / tuple of trees or a dict of trees; its leaves
are taken in JAX's order (dict keys sorted, list items by index), so the
moments of a dict tree are dicts of the same shape and a checkpoint of
them names its leaves as the reference's does. The GNN trainer passes a
list (its `parameters()`), the LM trainer the transformer's dict tree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of `tree` in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """`like`'s structure with its leaves taken in order from `leaves`;
    lists and tuples come back as lists."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(t) for t in node]
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """`fn` over the leaves of `tree` (and the matching leaves of `rest`)."""
    return tree_unflatten(tree, [fn(*xs) for xs in zip(
        tree_leaves(tree), *(tree_leaves(r) for r in rest))])


def init(params) -> Dict:
    """m, v: float32 zeros like each parameter, in the params' structure;
    count: int32 scalar."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return {"m": zeros, "v": tree_map(torch.clone, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in order, of each leaf's float32 sum
    of squares; a 0-d tensor on the leaves' device."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm) -> Tuple[Any, torch.Tensor]:
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)), norm), with no
    read of the norm on the host."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def update(grads, state: Dict, params, *, lr, b1=0.9, b2=0.999, eps=1e-8,
           weight_decay=0.0):
    """Returns (new params, new state) as new tensors in the params'
    structure; nothing is updated in place, so a caller can still select
    the old values."""
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=c.device), c)
    new_p: List[torch.Tensor] = []
    new_m: List[torch.Tensor] = []
    new_v: List[torch.Tensor] = []
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), tree_leaves(params)):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + eps) \
            + weight_decay * p.to(torch.float32)
        new_p.append((p - lr * step).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return tree_unflatten(params, new_p), {
        "m": tree_unflatten(params, new_m), "v": tree_unflatten(params, new_v),
        "count": count}
