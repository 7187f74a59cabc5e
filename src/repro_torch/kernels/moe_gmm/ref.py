"""Plain PyTorch version of the grouped expert matmul
(`repro/kernels/moe_gmm/ref.py`): an einsum over float32 casts of both
inputs. The CPU path runs it, and `chip_smoke.py` holds the CUDA kernel
against it on the card."""
import torch


def moe_gmm_ref(x, w):
    """x (E, C, d) @ w (E, d, f) per expert -> (E, C, f) float32."""
    return torch.einsum("ecd,edf->ecf", x.to(torch.float32),
                        w.to(torch.float32))
