"""int8 gradient compression with error feedback
(`repro/optim/compression.py:19-66`), in plain PyTorch as the reference
runs it (outside any kernel).

Per-leaf blockwise symmetric quantization: g ~ scale * int8 over blocks of
`BLOCK` values. The residual (g - dequant) is carried in an error-feedback
buffer and added to the next step's gradient, so compression error does
not bias convergence (EF-SGD). Trees are those of `optim.adamw` (leaves in
JAX's order).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

BLOCK = 256


def _quant_leaf(g: torch.Tensor):
    flat = g.to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    # torch.round and jnp.round both round half to even
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:torch.Size(shape).numel()].reshape(shape)


def init_error_feedback(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_decompress(grads: Any, err: Any) -> Tuple[Any, Any]:
    """Returns (dequantized grads as would arrive after the all-reduce, new
    error buffers), both in the grads' structure."""
    deq, new_err = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        g32 = g.to(torch.float32) + e
        q, scale = _quant_leaf(g32)
        d = _dequant_leaf(q, scale, g.shape)
        deq.append(d.to(g.dtype))
        new_err.append(g32 - d)
    return tree_unflatten(grads, deq), tree_unflatten(grads, new_err)


def compressed_bytes(grads: Any) -> int:
    """Payload model: int8 + one float32 scale per BLOCK."""
    return sum(g.numel() + 4 * ((g.numel() + BLOCK - 1) // BLOCK)
               for g in tree_leaves(grads))
