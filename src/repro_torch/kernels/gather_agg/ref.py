"""Plain PyTorch versions of the gather-aggregate kernels
(`repro/kernels/gather_agg/ref.py`). The CPU path runs them, and
`chip_smoke.py` holds each CUDA kernel against them on the card.
`gather_agg_ref` materialises the (n_dst, r, F) gather the kernel avoids."""
import torch


def gather_agg_ref(x, idx, w):
    """out[i] = sum_j w[i, j] * x[idx[i, j]].

    x: (n_src, F) float; idx: (n_dst, r) int (clipped to valid rows);
    w: (n_dst, r) float per-edge weights (0 for masked slots).
    Returns (n_dst, F) float32.
    """
    g = x[torch.clamp(idx.long(), 0, x.shape[0] - 1)].to(torch.float32)
    return (g * w.to(torch.float32)[..., None]).sum(dim=1)


def gather_agg_bwd_dx_ref(idx, w, g, n_src: int):
    """dx[idx[i, j]] += w[i, j] * g[i], into zeros of shape (n_src, F).
    On the CPU `index_add_` adds in edge order, which is the reference's
    stable by-source order within every row; on CUDA it uses atomics."""
    F = g.shape[1]
    contrib = (w.to(torch.float32)[..., None]
               * g.to(torch.float32)[:, None, :]).reshape(-1, F)
    dx = torch.zeros((n_src, F), dtype=torch.float32, device=g.device)
    return dx.index_add_(0, idx.reshape(-1).long(), contrib)


def gather_agg_bwd_dw_ref(x, idx, g):
    """dw[i, j] = <g[i], x[idx[i, j]]> -> (n_dst, r) float32."""
    rows = x[idx.long()].to(torch.float32)
    return (rows * g.to(torch.float32)[:, None, :]).sum(dim=-1)
