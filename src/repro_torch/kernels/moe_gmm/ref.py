"""Plain PyTorch versions of the grouped expert matmul
(`repro/kernels/moe_gmm/ref.py`), of its gated epilogue and of the three
backward functions: einsums over float32 casts of the inputs, rounded to
the output dtype where the kernels round. The CPU path runs them, and
`chip_smoke.py` holds the CUDA kernels against them on the card. The
forward ones do not take `rows` (rows it names as zero give zero products
anyway); the backward ones do, and treat the rows past `rows[e, g]` as
zero, as the kernels do."""
import torch
import torch.nn.functional as F


def moe_gmm_ref(x, w, out_dtype=torch.float32):
    """x (E, C, d) @ w (E, d, f) per expert, in float32 -> (E, C, f) in
    `out_dtype`."""
    return torch.einsum("ecd,edf->ecf", x.to(torch.float32),
                        w.to(torch.float32)).to(out_dtype)


def moe_gmm_gated_ref(x, wg, wu):
    """silu(x @ wg) * (x @ wu) per expert, in x's dtype: each product
    rounded to it first, as the MoE layer's composite rounds them."""
    dt = x.dtype
    return F.silu(moe_gmm_ref(x, wg, dt)) * moe_gmm_ref(x, wu, dt)


def row_mask(rows, E: int, C: int):
    """(E, C, 1) bool: row c of expert e is occupied (`rows` (E, G): group
    g holds rows g * C / G .. + rows[e, g] - 1), or None without `rows`."""
    if rows is None:
        return None
    G = rows.shape[1]
    c = torch.arange(C, device=rows.device)
    return ((c % (C // G))[None, :] < rows.long()[:, c // (C // G)])[..., None]


def _masked(t, mask):
    return t if mask is None else torch.where(mask, t, torch.zeros_like(t))


def moe_gmm_bwd_dx_ref(dy, w, dy2=None, w2=None, rows=None):
    """dy (E, C, n) @ w (E, m, n)^T per expert [+ dy2 @ w2^T], summed in
    float32 and rounded once to dy's dtype -> (E, C, m); rows past `rows`
    are zero."""
    acc = torch.einsum("ecn,emn->ecm", dy.to(torch.float32),
                       w.to(torch.float32))
    if dy2 is not None:
        acc = acc + torch.einsum("ecn,emn->ecm", dy2.to(torch.float32),
                                 w2.to(torch.float32))
    return _masked(acc, row_mask(rows, *dy.shape[:2])).to(dy.dtype)


def moe_gmm_bwd_dw_ref(x, dy, rows=None):
    """x (E, C, m)^T @ dy (E, C, n) per expert over the rows `rows` names
    as occupied, in float32 -> (E, m, n) in x's dtype."""
    xm = _masked(x.to(torch.float32), row_mask(rows, *x.shape[:2]))
    return torch.einsum("ecm,ecn->emn", xm, dy.to(torch.float32)).to(x.dtype)


def moe_gmm_gated_bwd_ref(x, wg, wu, dh, rows=None):
    """(dg, du) of h = silu(x wg) * (x wu) for the gradient dh, in x's
    dtype: g and u rounded to it as the forward rounds them, s = silu(g)
    rounded, du = dh s and dg = dh u silu'(g), each computed in float32 and
    rounded once; rows past `rows` are zero."""
    dt = x.dtype
    g = moe_gmm_ref(x, wg, dt).to(torch.float32)
    u = moe_gmm_ref(x, wu, dt).to(torch.float32)
    den = 1 + torch.exp(-g)
    s = (g / den).to(dt).to(torch.float32)
    sig = 1 / den
    dhf = dh.to(torch.float32)
    mask = row_mask(rows, *x.shape[:2])
    du = _masked(dhf * s, mask).to(dt)
    dg = _masked(dhf * u * (sig * (1 + g * (1 - sig))), mask).to(dt)
    return dg, du
