"""uint32 murmur-style mixing on int64 tensors, the torch twin of
`batching.order.hash_u32`.

PyTorch's uint32 lacks most operations, so the wraparound arithmetic runs
in int64: every step is masked back to 32 bits, and each multiply by a
32-bit constant is split into its 16-bit halves so that no intermediate
passes 2^63. The epoch order programs (`pipeline.device_order`) and
LABOR's per-node ranks (`sampling.device`) both hash with it.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
# the murmur3-finalizer multipliers of `batching.order` (this module
# imports nothing of the package, so that any module may import it)
MIX_A = 0x85EBCA6B
MIX_B = 0xC2B2AE35


def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 `x` in [0, 2^32) and a 32-bit constant
    `c`: the products with c's 16-bit halves stay below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def hash_u32(idx: torch.Tensor, words, salt: int) -> torch.Tensor:
    """Twin of `batching.order.hash_u32` on int64 tensors holding uint32
    values: the same xor, multiply and shift steps, each reduced mod
    2^32. `words` are two integers (numpy uint32 or Python ints)."""
    x = idx.to(torch.int64) & M32
    for w in ((int(words[0]) ^ salt) & M32, int(words[1]) & M32):
        x = x ^ w
        x = mul_u32(x, MIX_A)
        x = x ^ (x >> 13)
        x = mul_u32(x, MIX_B)
        x = x ^ (x >> 16)
    return x
