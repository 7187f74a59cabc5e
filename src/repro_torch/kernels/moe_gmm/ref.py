"""Plain PyTorch versions of the grouped expert matmul
(`repro/kernels/moe_gmm/ref.py`) and of its gated epilogue: einsums over
float32 casts of both inputs. The CPU path runs them, and `chip_smoke.py`
holds the CUDA kernels against them on the card. Neither takes `rows`:
rows it names as zero give zero products anyway."""
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
