"""Plain PyTorch version of the masked mean (`repro/kernels/gather_mean/
ref.py`): materialises the (D, r, F) gather that `gather_mean` avoids."""
import torch


def gather_mean_ref(x, idx, mask):
    """Masked mean of the rows `x[idx[i, j]]` over the slots where
    `mask[i, j]` holds -> (D, F) float32 (all-masked rows are zero)."""
    g = x[torch.clamp(idx.long(), 0, x.shape[0] - 1)].to(torch.float32)
    m = mask.to(torch.float32)[..., None]
    s = (g * m).sum(dim=1)
    cnt = torch.clamp(m.sum(dim=1), min=1.0)
    return s / cnt
