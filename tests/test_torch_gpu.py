"""Tests that need a CUDA device: the hand-written kernels have no CPU
mode. They skip without a card. This file imports no JAX, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic
from repro_torch.kernels.gather_agg import kernel, ref
from repro_torch.train.gnn_loop import GNNTrainer

pytestmark = pytest.mark.gpu

# (n_src, n_dst, r, F): odd and even widths, a width that is not a multiple
# of 4 (the reddit feature width), and many edges on few rows
SHAPES = [(7, 12, 5, 8), (25, 8, 3, 6), (40, 17, 10, 10), (50, 6, 10, 602),
          (300, 1000, 10, 256), (3, 400, 10, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_versions(cuda, shape):
    """Each kernel against its plain version on the card (sums in another
    order: rtol = atol = 1e-5, more for dx rows that sum many edges);
    bwd_dx bit-identical across launches."""
    n_src, n_dst, r, f = shape
    rng = np.random.default_rng((n_src, n_dst))
    x = torch.as_tensor(rng.normal(size=(n_src, f)), dtype=torch.float32,
                        device=cuda)
    idx = torch.as_tensor(rng.integers(0, n_src, (n_dst, r)),
                          dtype=torch.int32, device=cuda)
    w = torch.as_tensor(rng.random((n_dst, r)), dtype=torch.float32,
                        device=cuda)
    w[0] = 0.0                                # an all-masked row
    g = torch.as_tensor(rng.normal(size=(n_dst, f)), dtype=torch.float32,
                        device=cuda)
    before = dict(kernel.LAUNCHES)
    out = kernel.gather_agg_fwd(x, idx, w)
    torch.testing.assert_close(out, ref.gather_agg_ref(x, idx, w),
                               rtol=1e-5, atol=1e-5)
    dx = kernel.gather_agg_bwd_dx(idx, w, g, n_src)
    # a dx row sums one product per weighted edge into it, in another
    # order than index_add_'s atomics: rounding grows with that count
    terms = int(torch.bincount(idx[w != 0].long()).max())
    tol = max(1e-5, 1e-7 * terms)
    torch.testing.assert_close(dx, ref.gather_agg_bwd_dx_ref(idx, w, g,
                                                             n_src),
                               rtol=tol, atol=tol)
    assert torch.equal(dx, kernel.gather_agg_bwd_dx(idx, w, g, n_src))
    assert kernel.LAUNCHES["gather_agg_fwd"] == before["gather_agg_fwd"] + 1
    assert kernel.LAUNCHES["gather_agg_bwd_dx"] == \
        before["gather_agg_bwd_dx"] + 2


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 8), device=cuda)
    idx = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    w = torch.zeros((2, 3), device=cuda)
    with pytest.raises(TypeError):
        kernel.gather_agg_fwd(x.double(), idx, w)
    with pytest.raises(TypeError):
        kernel.gather_agg_fwd(x, idx.long(), w)
    with pytest.raises(ValueError):
        kernel.gather_agg_fwd(x.t(), idx, w)
    with pytest.raises(ValueError):
        kernel.gather_agg_fwd(x, idx, w.cpu())


def test_card_and_cpu_steps_agree(cuda):
    """Same parameters, same batches: five guarded steps on the card and on
    the CPU agree within rtol = 1e-4."""
    g = prepare(synthetic.load("tiny"), oracle=True)
    cfg = GNNConfig("t", "sage", 2, 32, g.feat_dim, g.num_classes,
                    fanout=(5, 5), dropout=0.0)
    tcfg = TrainConfig(batch_size=256)
    cpu = GNNTrainer(g, cfg, tcfg, "comm_rand", device="cpu")
    gpu = GNNTrainer(g, cfg, tcfg, "comm_rand", caps=cpu.caps,
                     eval_caps=cpu.eval_caps, device=cuda)
    it = iter(cpu.stream)
    for _ in range(5):
        b = next(it)
        lc, _ = cpu.train_step(b, tcfg.learning_rate)
        lg, _ = gpu.train_step(b.to(cuda), tcfg.learning_rate)
        np.testing.assert_allclose(float(lg), float(lc), rtol=1e-4)
