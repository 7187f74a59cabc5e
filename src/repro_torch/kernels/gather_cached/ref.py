"""Plain PyTorch version of the two-level cached gather
(`repro/kernels/gather_cached/ref.py`). The CPU path runs it, and
`chip_smoke.py` holds the CUDA kernel against it on the card. It reads
both candidate rows of every id and selects; the kernel reads one."""
import torch


def gather_cached_ref(cache, feats, pos, ids):
    """out[k] = cache[pos[ids[k]]] if pos[ids[k]] >= 0 else feats[ids[k]].

    cache: (C, F) float32 (exact copies of admitted rows); feats: (N, F);
    pos: (N,) int32 position map (-1 = miss); ids: (M,) int global row
    ids, entries outside [0, N) are padding and served from the clipped
    global row (callers mask them). Returns (M, F) float32.
    """
    N = feats.shape[0]
    ids = ids.long()
    gid = torch.clamp(ids, 0, N - 1)
    sel = pos[gid].long()
    hit = (sel >= 0) & (ids >= 0) & (ids < N)
    return torch.where(hit[:, None],
                       cache[torch.clamp(sel, min=0)].to(torch.float32),
                       feats[gid].to(torch.float32))
