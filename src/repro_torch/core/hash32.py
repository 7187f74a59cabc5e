"""uint32 murmur-style mixing on int64 tensors, the torch twin of
`batching.order.hash_u32`.

PyTorch's uint32 lacks most operations, so the wraparound arithmetic runs
in int64: every step is masked back to 32 bits, and each multiply by a
32-bit constant is split into its 16-bit halves so that no intermediate
passes 2^63. The epoch order programs (`pipeline.device_order`) and
LABOR's per-node ranks (`sampling.device`) both hash with it.

The two words ride into the hash as a (2,) int64 tensor on the hashed
ids' device (`word_tensor`: one copy that does not wait), not as Python
integers: an op's integer argument would make every epoch's ops differ,
where now only the words' values do.
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


def word_tensor(words, device) -> torch.Tensor:
    """Two uint32 words (numpy uint32, Python ints, or a (2,) int64
    tensor already on `device`) as a (2,) int64 tensor on `device`."""
    if isinstance(words, torch.Tensor) and words.device == device and \
            words.dtype == torch.int64:
        return words
    # 16 bytes from pageable memory: staged at once, no wait (as
    # `batching.stream.batch_roots`' position)
    return torch.tensor([int(words[0]) & M32, int(words[1]) & M32],
                        dtype=torch.int64).to(device, non_blocking=True)


def hash_u32(idx: torch.Tensor, words, salt: int) -> torch.Tensor:
    """Twin of `batching.order.hash_u32` on int64 tensors holding uint32
    values: the same xor, multiply and shift steps, each reduced mod
    2^32. `words`: the two words, as `word_tensor` takes them."""
    x = idx.to(torch.int64) & M32
    wt = word_tensor(words, idx.device)
    for w in ((wt[0] ^ salt) & M32, wt[1]):
        x = x ^ w
        x = mul_u32(x, MIX_A)
        x = x ^ (x >> 13)
        x = mul_u32(x, MIX_B)
        x = x ^ (x >> 16)
    return x
