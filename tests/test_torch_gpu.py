"""Tests that need a CUDA device: the hand-written kernels have no CPU
mode. They skip without a card. This file imports no JAX, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from repro_torch.batching import BatchStream, make_policy
from repro_torch.configs import LM_CONFIGS, GNNConfig, TrainConfig
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic
from repro_torch.featcache import gather_cached
from repro_torch.featcache import dynamic
from repro_torch.featcache.dynamic import DynamicCacheState
from repro_torch.kernels.clock_refill import kernel as walk_kernel
from repro_torch.kernels.clock_refill.ref import (clock_refill_ref,
                                                  clock_state,
                                                  clock_walk_windows,
                                                  walk_args)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention_bwd_ref)
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.gather_agg import kernel, ref
from repro_torch.kernels.gather_cached import kernel as cached_kernel
from repro_torch.kernels.gather_cached.ref import gather_cached_ref
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.kernels.rwkv6_chunk import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_chunk.ref import wkv6_fwd_ref
from repro_torch.launch.serve import generate
from repro_torch.models.lm import moe as moe_module
from repro_torch.models.lm import transformer
from repro_torch.obs import report, trace
from repro_torch.pipeline import AsyncBatchStream
from repro_torch.pipeline.prefetch import batch_tensors
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
    """Each kernel against its plain version on the card: fwd bit for bit
    against the plain version that adds in its order; bwd_dx (sums in
    another order) within rtol = atol = 1e-5, more for dx rows that sum
    many edges, and bit-identical across launches."""
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
    assert torch.equal(out, ref.gather_agg_ref_ordered(x, idx, w))
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


# (n_src, n_dst, r, F): GAT's folded widths (dh = 10 at the class layer,
# 64 in the hidden layers) and the reddit feature width, which the lanes
# stride over in ten float2 steps
DW_SHAPES = [(40, 300, 10, 10), (64, 500, 10, 64), (50, 60, 10, 602)]


@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dw_kernel_matches_plain_version(cuda, shape):
    """dw[i, j] = <g[i], x[idx[i, j]]> against its plain version, with
    repeated indices and the padding pattern of a batch (whole rows on the
    last, sentinel source row); bit-identical relaunch; one count per
    launch. Each entry is an F-term dot summed in another order: the two
    differ by at most 2 * F * eps * sum_k |g[i, k] * x[idx[i, j], k]|."""
    n_src, n_dst, r, f = shape
    rng = np.random.default_rng((n_src, f))
    x = torch.as_tensor(rng.normal(size=(n_src, f)), dtype=torch.float32,
                        device=cuda)
    idx_h = rng.integers(0, n_src, (n_dst, r))
    idx_h[:, :3] = 1                          # repeated rows
    idx_h[n_dst // 2:] = n_src - 1            # padded destination rows
    idx = torch.as_tensor(idx_h, dtype=torch.int32, device=cuda)
    g = torch.as_tensor(rng.normal(size=(n_dst, f)), dtype=torch.float32,
                        device=cuda)
    before = kernel.LAUNCHES["gather_agg_bwd_dw"]
    dw = kernel.gather_agg_bwd_dw(x, idx, g)
    assert kernel.LAUNCHES["gather_agg_bwd_dw"] == before + 1
    want = ref.gather_agg_bwd_dw_ref(x, idx, g)
    scale = ref.gather_agg_bwd_dw_ref(x.abs(), idx, g.abs())
    bound = 2 * f * torch.finfo(torch.float32).eps * scale
    assert dw.shape == (n_dst, r) and dw.dtype == torch.float32
    assert ((dw - want).abs() <= bound).all(), \
        float(((dw - want).abs() / bound).max())
    assert torch.equal(dw, kernel.gather_agg_bwd_dw(x, idx, g))
    assert kernel.LAUNCHES["gather_agg_bwd_dw"] == before + 2


# fwd / dw at every lane-group width (F 1 and 4: one lane a row; 10: four;
# 33 and 64: sixteen; 256 and 602: a warp, 602 in five column tiles), r
# below, at and above the kernels' batches of 5 edges, from one row to
# many blocks
GRID = [(f, r, n) for f in (1, 4, 10, 33, 64, 256, 602)
        for r in (1, 3, 10, 25) for n in (1, 7, 5000)]


def _grid_case(f, r, n_dst, offset, device):
    """(x, idx, w, g): x a contiguous view `offset` floats into a fresh
    buffer (0: 16-byte aligned; 1: only 4-byte; 2: only 8-byte), so that
    the kernels take every vector width; row 0 of w all masked; row 1's
    edges all on one source row with their own weights, and the last
    quarter of the rows padded as a batch pads them (every edge on the last
    source row, weight 0): the kernels load such a row once per batch."""
    rng = np.random.default_rng((f, r, n_dst, offset))
    n_src = max(3, n_dst // 4)
    buf = torch.as_tensor(rng.normal(size=n_src * f + 2),
                          dtype=torch.float32, device=device)
    x = buf[offset:offset + n_src * f].view(n_src, f)
    assert x.data_ptr() % 16 == 4 * offset
    idx = torch.as_tensor(rng.integers(0, n_src, (n_dst, r)),
                          dtype=torch.int32, device=device)
    w = torch.as_tensor(rng.random((n_dst, r)), dtype=torch.float32,
                        device=device)
    w[0] = 0.0
    if n_dst > 1:
        idx[1] = 1
    idx[n_dst - n_dst // 4:] = n_src - 1
    w[n_dst - n_dst // 4:] = 0.0
    g = torch.as_tensor(rng.normal(size=(n_dst, f)), dtype=torch.float32,
                        device=device)
    return x, idx, w, g


@pytest.mark.parametrize("f,r,n_dst", GRID)
def test_fwd_is_bit_equal_to_the_ordered_plain_version(cuda, f, r, n_dst):
    """fwd sums each row from 0 in j order, multiply then add: bit-equal to
    `gather_agg_ref_ordered` at every base alignment, relaunched
    bit-identically, one count per launch."""
    for offset in (0, 1, 2):
        x, idx, w, _ = _grid_case(f, r, n_dst, offset, cuda)
        before = kernel.LAUNCHES["gather_agg_fwd"]
        out = kernel.gather_agg_fwd(x, idx, w)
        assert kernel.LAUNCHES["gather_agg_fwd"] == before + 1
        assert torch.equal(out, ref.gather_agg_ref_ordered(x, idx, w)), \
            (offset, float((out - ref.gather_agg_ref_ordered(x, idx, w))
                           .abs().max()))
        assert torch.equal(out, kernel.gather_agg_fwd(x, idx, w))


@pytest.mark.parametrize("f,r,n_dst", GRID)
def test_dw_is_within_its_bound_on_the_grid(cuda, f, r, n_dst):
    """dw against its plain version within 2 F eps sum_k |g x| (as
    `chip_smoke.py` holds it) at every base alignment, relaunched
    bit-identically, one count per launch."""
    eps = torch.finfo(torch.float32).eps
    for offset in (0, 1, 2):
        x, idx, _, g = _grid_case(f, r, n_dst, offset, cuda)
        before = kernel.LAUNCHES["gather_agg_bwd_dw"]
        dw = kernel.gather_agg_bwd_dw(x, idx, g)
        assert kernel.LAUNCHES["gather_agg_bwd_dw"] == before + 1
        want = ref.gather_agg_bwd_dw_ref(x, idx, g)
        bound = 2 * f * eps * ref.gather_agg_bwd_dw_ref(x.abs(), idx,
                                                        g.abs())
        assert dw.shape == (n_dst, r)
        assert ((dw - want).abs() <= bound).all(), offset
        assert torch.equal(dw, kernel.gather_agg_bwd_dw(x, idx, g))


@pytest.mark.parametrize("f", [10, 64, 602])
def test_nan_in_a_masked_source_row_propagates(cuda, f):
    """Masked edges (w = 0) are read and summed: a NaN in a source row that
    only a masked edge names makes that destination row NaN in fwd (0 * NaN)
    and that edge's dw NaN, as in the plain versions, and nothing else; a
    NaN in the row that padded rows name reaches every padded row."""
    x, idx, w, g = _grid_case(f, 10, 40, 0, cuda)
    bad = x.shape[0] - 1
    x = x.clone()
    x[bad] = float("nan")
    idx = torch.where(idx == bad, torch.zeros_like(idx), idx)
    idx[5, 3], w[5, 3] = bad, 0.0
    out = kernel.gather_agg_fwd(x, idx, w)
    torch.testing.assert_close(out, ref.gather_agg_ref_ordered(x, idx, w),
                               rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(out[5]).all() and int(torch.isnan(out).sum()) == f
    dw = kernel.gather_agg_bwd_dw(x, idx, g)
    assert torch.isnan(dw[5, 3]) and int(torch.isnan(dw).sum()) == 1
    # padded rows 30..39 name row 0 only: a NaN there reaches all of them
    x[0] = float("nan")
    out = kernel.gather_agg_fwd(x, idx, w)
    torch.testing.assert_close(out, ref.gather_agg_ref_ordered(x, idx, w),
                               rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(out[30:]).all()
    dw = kernel.gather_agg_bwd_dw(x, idx, g)
    want = ref.gather_agg_bwd_dw_ref(x, idx, g)
    assert torch.equal(torch.isnan(dw), torch.isnan(want))
    assert torch.isnan(dw[30:]).all()


def test_empty_calls_launch_nothing(cuda):
    """No destination rows: empty outputs of the right shapes, no launch."""
    x = torch.randn((5, 8), device=cuda)
    idx = torch.zeros((0, 10), dtype=torch.int32, device=cuda)
    before = dict(kernel.LAUNCHES)
    out = kernel.gather_agg_fwd(x, idx, torch.zeros((0, 10), device=cuda))
    dw = kernel.gather_agg_bwd_dw(x, idx, torch.zeros((0, 8), device=cuda))
    assert out.shape == (0, 8) and dw.shape == (0, 10)
    assert kernel.LAUNCHES == before


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
    g = torch.zeros((2, 8), device=cuda)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(TypeError):
        kernel.gather_agg_bwd_dw(x.double(), idx, g)
    with pytest.raises(TypeError):
        kernel.gather_agg_bwd_dw(x, idx.long(), g)
    with pytest.raises(ValueError):
        kernel.gather_agg_bwd_dw(x, idx.reshape(-1), g)
    with pytest.raises(ValueError):
        kernel.gather_agg_bwd_dw(x.cpu(), idx, g)
    with pytest.raises(ValueError):
        kernel.gather_agg_bwd_dw(torch.zeros((8, 4), device=cuda).t(), idx,
                                 g)
    with pytest.raises(ValueError):
        kernel.gather_agg_bwd_dw(x, idx, torch.zeros((3, 8), device=cuda))
    assert kernel.LAUNCHES == before


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


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_gcn_gat_card_and_cpu_steps_agree(cuda, model):
    """GCN and GAT: five guarded steps on the card and on the CPU from the
    same parameters on the same batches agree within rtol = 1e-4; on the
    card GAT's attention gradient goes through the dw kernel (one launch
    per layer and step), GCN's never does."""
    g = prepare(synthetic.load("tiny"), oracle=True)
    cfg = GNNConfig("t", model, 2, 32, g.feat_dim, g.num_classes,
                    fanout=(5, 5), dropout=0.0)
    tcfg = TrainConfig(batch_size=256)
    cpu = GNNTrainer(g, cfg, tcfg, "comm_rand", device="cpu")
    gpu = GNNTrainer(g, cfg, tcfg, "comm_rand", caps=cpu.caps,
                     eval_caps=cpu.eval_caps, device=cuda)
    it = iter(cpu.stream)
    kernel.reset_launches()
    for _ in range(5):
        b = next(it)
        lc, _ = cpu.train_step(b, tcfg.learning_rate)
        lg, _ = gpu.train_step(b.to(cuda), tcfg.learning_rate)
        np.testing.assert_allclose(float(lg), float(lc), rtol=1e-4)
    assert kernel.LAUNCHES["gather_agg_bwd_dw"] == \
        (10 if model == "gat" else 0)
    # bwd_dx per step: GCN the aggregate and the self gather of layer 1;
    # GAT the aggregate, z_self and e_src at both layers
    assert kernel.LAUNCHES["gather_agg_bwd_dx"] == \
        5 * (6 if model == "gat" else 2)


# (n_src, idx shape, trailing shape): SAGE's self gather, GAT's z_self and
# e_src, and a run of a hundred thousand indices on the padding row
ROW_SHAPES = [(300, (1000,), (256,)), (200, (500,), (4, 64)),
              (200, (500, 10), (4,)), (1000, (100_000,), (32,))]


@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_gather_rows_on_the_card_matches_the_cpu(cuda, shape):
    """gather_rows on the card: the forward equal to the CPU's, the
    gradient within rtol 1e-5 of the CPU's (fixed-order segmented sums
    against index_add_'s edge order), bit-identical over two backwards,
    and exactly one gather_agg_bwd_dx launch per backward."""
    from repro_torch.kernels.gather_agg.ops import gather_rows
    n_src, idx_shape, tail = shape
    rng = np.random.default_rng((n_src, len(idx_shape)))
    x = rng.normal(size=(n_src, *tail)).astype(np.float32)
    idx = rng.integers(0, n_src, idx_shape)
    flat = idx.reshape(-1)
    flat[: flat.size // 2] = n_src - 1       # the batch's padding slots
    g = rng.normal(size=(*idx_shape, *tail)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        xt = torch.as_tensor(x, device=dev).requires_grad_(True)
        it = torch.as_tensor(idx, device=dev)
        gt = torch.as_tensor(g, device=dev)
        out = gather_rows(xt, it)
        before = kernel.LAUNCHES["gather_agg_bwd_dx"]
        (dx,) = torch.autograd.grad(out, xt, gt)
        (dx2,) = torch.autograd.grad(gather_rows(xt, it), xt, gt)
        launched = kernel.LAUNCHES["gather_agg_bwd_dx"] - before
        assert launched == (0 if dev == "cpu" else 2)
        assert torch.equal(dx, dx2)
        grads[str(dev)] = (out.detach().cpu(), dx.cpu())
    (oc, dc), (og, dg) = grads["cpu"], grads[str(cuda)]
    assert torch.equal(oc, og)
    # a row of dx sums one cotangent row per index on it, in another order
    # on each device: the two sums differ by at most 2 n eps sum |g|
    xa = torch.as_tensor(x).requires_grad_(True)
    (scale,) = torch.autograd.grad(gather_rows(xa, torch.as_tensor(idx)),
                                   xa, torch.as_tensor(np.abs(g)))
    n = int(np.bincount(idx.reshape(-1)).max())
    bound = 2 * n * torch.finfo(torch.float32).eps * scale
    assert bool(((dg - dc).abs() <= bound).all()), \
        float(((dg - dc).abs() / bound.clamp(min=1e-30)).max())


def _dx_case(n_src, n_dst, r, f, seed, sorted_idx=False):
    """A bwd_dx input with the shapes of a batch: empty source rows, rows
    of one to 64 edges, a row of exactly 64 and one of 65, and the padding
    row (the last) owning every edge of the second half of the destination
    rows (thousands: more than 64 windows of 64), with zero weights on
    some edges."""
    rng = np.random.default_rng((seed, f))
    idx = rng.integers(0, n_src // 2, (n_dst, r))
    flat = idx.reshape(-1)
    flat[:64] = n_src // 2                    # 64 edges on one row
    flat[64:129] = n_src // 2 + 1             # 65 edges: two windows
    idx[n_dst // 2:] = n_src - 1              # the padding row
    if sorted_idx:
        idx = np.sort(idx.reshape(-1)).reshape(n_dst, r)
    w = rng.random((n_dst, r)).astype(np.float32)
    w[rng.random((n_dst, r)) < 0.2] = 0.0
    g = rng.normal(size=(n_dst, f)).astype(np.float32)
    return idx.astype(np.int32), w, g


def _check_dx_against_cpu(dx, idx, w, g, n_src):
    """Rows of at most 64 edges equal the CPU plain version (index_add_ in
    edge order) bit for bit; longer ones within check_dx's tolerance."""
    want = ref.gather_agg_bwd_dx_ref(torch.as_tensor(idx),
                                     None if w is None else
                                     torch.as_tensor(w),
                                     torch.as_tensor(g), n_src)
    got = dx.cpu()
    count = np.bincount(idx.reshape(-1), minlength=n_src)
    short = torch.as_tensor(count <= 64)
    assert short.sum() < n_src and (~short).sum() >= 2
    assert torch.equal(got[short], want[short])
    tol = max(1e-5, 1e-7 * int(count.max()))
    torch.testing.assert_close(got[~short], want[~short], rtol=tol, atol=tol)


# F: GAT's e_src (4 heads), its last layer's head width (10), its hidden
# head width (64), SAGE's hidden width (256), the reddit feature width
# (602, float2) and an odd width (scalar loads)
DX_WIDTHS = [4, 10, 64, 256, 602, 33]


@pytest.mark.parametrize("n_dst", [1200, 3000])
@pytest.mark.parametrize("f", DX_WIDTHS)
def test_bwd_dx_is_bit_equal_to_the_cpu_on_short_rows(cuda, f, n_dst):
    """The redesigned bwd_dx against the CPU plain version: bit-equal on
    every row of at most 64 edges (empty rows zero), within tolerance on
    the long ones; a relaunch bit-identical; one count per call, with a
    plan built once and passed in, or built by the call. 12,000 edges run
    as one cooperative launch, 30,000 as three."""
    n_src, r = 300, 10
    idx, w, g = _dx_case(n_src, n_dst, r, f, 0)
    it, wt, gt = (torch.as_tensor(a, device=cuda) for a in (idx, w, g))
    before = kernel.LAUNCHES["gather_agg_bwd_dx"]
    plans = kernel.PLANS["gather_agg_bwd_dx"]
    dx = kernel.gather_agg_bwd_dx(it, wt, gt, n_src)
    plan = kernel.bwd_dx_plan(it, n_src)
    again = kernel.gather_agg_bwd_dx(it, wt, gt, n_src, plan)
    assert kernel.LAUNCHES["gather_agg_bwd_dx"] == before + 2
    assert kernel.PLANS["gather_agg_bwd_dx"] == plans + 2
    assert dx.shape == (n_src, f) and dx.dtype == torch.float32
    assert torch.equal(dx, again)
    _check_dx_against_cpu(dx, idx, w, g, n_src)


@pytest.mark.parametrize("H", [1, 4])
def test_folded_plan_on_the_card_matches_the_cpu(cuda, H):
    """GAT's head-folded aggregate through the plan of src_pos folded to H
    heads equals the CPU plain version over idx2 = src * H + h (bit for
    bit on short rows), and e_src's fanout-1 backward through the same
    plan equals the CPU's too."""
    n_src, n_dst, r, dh = 200, 800, 10, 64
    src, w, _ = _dx_case(n_src, n_dst, r, 1, 1)
    heads = np.arange(H, dtype=np.int32)
    idx2 = (src[:, None, :] * H + heads[None, :, None]).reshape(n_dst * H, r)
    rng = np.random.default_rng((2, H))
    w2 = rng.random((n_dst * H, r)).astype(np.float32)
    g2 = rng.normal(size=(n_dst * H, dh)).astype(np.float32)
    plan = kernel.bwd_dx_plan(torch.as_tensor(src, device=cuda), n_src)
    dx = kernel.gather_agg_bwd_dx(
        torch.as_tensor(idx2, device=cuda), torch.as_tensor(w2, device=cuda),
        torch.as_tensor(g2, device=cuda), n_src * H, plan.folded(H))
    _check_dx_against_cpu(dx, idx2, w2, g2, n_src * H)
    ge = rng.normal(size=(n_dst * r, H)).astype(np.float32)
    flat = src.reshape(-1, 1)
    de = kernel.gather_agg_bwd_dx(torch.as_tensor(flat, device=cuda), None,
                                  torch.as_tensor(ge, device=cuda), n_src,
                                  plan)
    _check_dx_against_cpu(de, flat, None, ge, n_src)
    with pytest.raises(ValueError):            # a plan of another index
        kernel.gather_agg_bwd_dx(torch.as_tensor(idx2, device=cuda),
                                 torch.as_tensor(w2, device=cuda),
                                 torch.as_tensor(g2, device=cuda),
                                 n_src * H, plan.folded(H + 1))


@pytest.mark.parametrize("n_dst", [10_000, 40_000])
@pytest.mark.parametrize("f", DX_WIDTHS)
def test_sorted_path_equals_the_general_path(cuda, f, n_dst):
    """A non-decreasing index through the sort-free path equals the
    general path (a stable sort of sorted keys is the identity, so every
    sum runs in the same order), bit for bit, with unit weights and with
    weights; both against the CPU; relaunch bit-identical; one cooperative
    launch (10,000 edges) and three (40,000)."""
    n_src, r = 300, 1
    idx, w, g = _dx_case(n_src, n_dst, r, f, 3, sorted_idx=True)
    it, wt, gt = (torch.as_tensor(a, device=cuda) for a in (idx, w, g))
    plans = kernel.PLANS["gather_agg_bwd_dx"]
    for weights, w_np in ((None, None), (wt, w)):
        fast = kernel.gather_agg_bwd_dx_sorted(it, weights, gt, n_src)
        assert torch.equal(fast, kernel.gather_agg_bwd_dx_sorted(
            it, weights, gt, n_src))
        assert torch.equal(fast, kernel.gather_agg_bwd_dx(it, weights, gt,
                                                          n_src))
        _check_dx_against_cpu(fast, idx, w_np, g, n_src)
    assert kernel.PLANS["gather_agg_bwd_dx"] == plans + 2  # general only


UNSORTED = """
import sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels.gather_agg import kernel
idx = torch.tensor([[0], [3], [1], [2]], dtype=torch.int32, device="cuda")
g = torch.ones((4, 8), device="cuda")
dx = kernel.gather_agg_bwd_dx_sorted(idx, None, g, 4)
torch.cuda.synchronize()
print("no error", dx.sum().item())
"""


def test_an_unsorted_index_on_the_sorted_path_fails_loudly(cuda):
    """The sorted path traps on keys out of order: the launch fails (in a
    child process, since a trap poisons its CUDA context), and no dx comes
    back."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", UNSORTED], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0, proc.stdout
    assert "no error" not in proc.stdout
    assert "error" in proc.stderr.lower(), proc.stderr[-2000:]


@pytest.mark.parametrize("model,plans,dx", [("sage", 2, 4), ("gcn", 2, 4),
                                            ("gat", 3, 9)])
def test_a_step_builds_one_plan_per_layer_with_dx(cuda, model, plans, dx):
    """One train step of a 3-layer model sorts each index its backward
    needs once: SAGE and GCN 2 plans (layer 0's input needs no dx), GAT 3
    (its aggregate and e_src share the layer's plan); the self rows sort
    nothing. bwd_dx launches stay 4 and 9 a step."""
    g = prepare(synthetic.load("tiny"), oracle=True)
    cfg = GNNConfig("t", model, 3, 32, g.feat_dim, g.num_classes,
                    fanout=(5, 5, 5), dropout=0.0)
    tr = GNNTrainer(g, cfg, TrainConfig(batch_size=256), "comm_rand",
                    device=cuda)
    tr.train_steps(1)
    kernel.reset_launches()
    tr.train_steps(2)
    assert kernel.PLANS["gather_agg_bwd_dx"] == 2 * plans
    assert kernel.LAUNCHES["gather_agg_bwd_dx"] == 2 * dx


# (N, C, M, F, kind): the reddit feature width (float2), a multiple of 4
# (float4), an odd width (float), more ids than rows; every id a hit or a
# miss
CACHED_SHAPES = [(50, 12, 40, 24, "random"), (300, 60, 1000, 602, "random"),
                 (20, 5, 33, 7, "random"), (40, 40, 64, 16, "all_hit"),
                 (40, 1, 64, 16, "all_miss")]


def _cached_case(device, N, C, M, F, kind):
    rng = np.random.default_rng((N, M, F))
    feats = rng.normal(size=(N, F)).astype(np.float32)
    rows = np.arange(N) if kind == "all_hit" else \
        np.zeros(0, np.int64) if kind == "all_miss" else \
        np.sort(rng.choice(N, size=C, replace=False))
    pos = np.full(N, -1, np.int32)
    pos[rows] = np.arange(len(rows), dtype=np.int32)
    ids = rng.integers(0, N, M).astype(np.int32)
    if kind == "random":                      # padding: the sentinel, -1
        u = rng.random(M)
        ids[u < 0.15] = N
        ids[u > 0.92] = -1
    cache = feats[rows] if len(rows) else feats[:1]
    return tuple(torch.as_tensor(a, device=device)
                 for a in (cache, feats, pos, ids))


@pytest.mark.parametrize("shape", CACHED_SHAPES)
def test_gather_cached_kernel_matches_plain_version(cuda, shape):
    """A copy: bit-equal to the plain version, bit-identical relaunch, one
    count per launch."""
    cache, feats, pos, ids = _cached_case(cuda, *shape)
    before = cached_kernel.LAUNCHES["gather_cached_fwd"]
    out = cached_kernel.gather_cached_fwd(cache, feats, pos, ids)
    assert torch.equal(out, gather_cached_ref(cache, feats, pos, ids))
    assert torch.equal(out, cached_kernel.gather_cached_fwd(cache, feats,
                                                            pos, ids))
    assert cached_kernel.LAUNCHES["gather_cached_fwd"] == before + 2


@pytest.mark.parametrize("shape", CACHED_SHAPES)
def test_gather_cached_backward_matches_plain_version(cuda, shape):
    """d_cache and d_feats through the autograd op (the forward kernel and
    two bwd_dx launches) against autograd of the plain version; a row sums
    one cotangent per id that lands on it (padding ids all land on the
    clipped row), so the tolerance is the bwd_dx one."""
    cache, feats, pos, ids = _cached_case(cuda, *shape)
    g = torch.randn((ids.shape[0], feats.shape[1]), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    grads = []
    for fn in (lambda c, f: gather_cached(c, f, pos, ids)[0],
               lambda c, f: gather_cached_ref(c, f, pos, ids)):
        c = cache.clone().requires_grad_()
        f = feats.clone().requires_grad_()
        (fn(c, f) * g).sum().backward()
        grads.append((c.grad, f.grad))
    N = feats.shape[0]
    terms = int(torch.bincount(ids.long().clamp(0, N - 1)).max())
    tol = max(1e-5, 1e-7 * terms)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_gather_cached_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    cache, feats, pos, ids = _cached_case(cuda, 20, 5, 8, 6, "random")
    before = dict(cached_kernel.LAUNCHES)
    bad = [(cache.double(), feats, pos, ids, TypeError),
           (cache, feats, pos.long(), ids, TypeError),
           (cache, feats, pos, ids.long(), TypeError),
           (cache, feats.t().contiguous().t(), pos, ids, ValueError),
           (cache, feats, pos, ids.cpu(), ValueError),
           (cache[:, :5].contiguous(), feats, pos, ids, ValueError),
           (cache, feats, pos[:-1].contiguous(), ids, ValueError)]
    for *args, err in bad:
        with pytest.raises(err):
            cached_kernel.gather_cached_fwd(*args)
    assert cached_kernel.LAUNCHES == before


def test_cached_card_and_cpu_steps_agree(cuda):
    """The cached trainer: five guarded steps on the card and on the CPU,
    same plan, parameters and batches, agree within rtol = 1e-4; each card
    step launches the cached gather once."""
    g = prepare(synthetic.load("tiny"), oracle=True)
    cfg = GNNConfig("t", "sage", 2, 32, g.feat_dim, g.num_classes,
                    fanout=(5, 5), dropout=0.0)
    tcfg = TrainConfig(batch_size=256)
    cpu = GNNTrainer(g, cfg, tcfg, "comm_rand", device="cpu",
                     cache="presampled_freq")
    gpu = GNNTrainer(g, cfg, tcfg, "comm_rand", caps=cpu.caps,
                     eval_caps=cpu.eval_caps, device=cuda,
                     cache="presampled_freq")
    assert torch.equal(gpu.cache.pos.cpu(), cpu.cache.pos)
    it = iter(cpu.stream)
    before = cached_kernel.LAUNCHES["gather_cached_fwd"]
    for _ in range(5):
        b = next(it)
        lc, _ = cpu.train_step(b, tcfg.learning_rate)
        lg, _ = gpu.train_step(b.to(cuda), tcfg.learning_rate)
        np.testing.assert_allclose(float(lg), float(lc), rtol=1e-4)
    assert cached_kernel.LAUNCHES["gather_cached_fwd"] == before + 5


# (B, Sq, Skv, H, KH, D, causal, window, is_global, q_offset): the reduced
# and the full head dim (16, 256) and one between, GQA 2:1 and 4:1, global
# and local layers, ragged lengths (tiles of 64 query rows and of 64 / 32
# keys), a window that ends inside a tile, non-causal, and queries at an
# offset into a longer key sequence
FLASH_CASES = [(2, 40, 40, 4, 2, 16, True, 16, True, 0),
               (2, 47, 47, 4, 2, 16, True, 16, False, 0),
               (1, 130, 130, 4, 2, 64, True, 50, False, 0),
               (1, 300, 300, 4, 1, 256, True, 512, True, 0),
               (2, 257, 257, 4, 1, 256, True, 100, False, 0),
               (1, 70, 70, 4, 1, 256, False, 30, False, 0),
               (1, 33, 97, 4, 1, 256, True, 40, False, 64),
               (1, 65, 65, 2, 2, 100, False, 1 << 30, True, 0),
               # the tensor-core kernel's cases (bf16 at D 64, 128, 256;
               # blocks of 128 query rows, KV tiles of 128 keys at D <= 128
               # and 64 at D 256): D 128 with the window's edge and the
               # causal diagonal inside tiles, GQA 1:1; Skv shorter than
               # one tile at an offset; queries at an offset into a longer
               # key sequence, GQA 4:1; non-causal at D 64; D 256 windowed
               # at an offset over 2 ragged query blocks; and two cases
               # where the last rows see no key (non-causal at D 128,
               # causal at D 256)
               (2, 300, 300, 4, 4, 128, True, 100, False, 0),
               (1, 200, 37, 2, 2, 128, True, 1 << 30, True, 163),
               (2, 70, 300, 8, 2, 128, True, 1 << 30, True, 230),
               (1, 150, 260, 4, 4, 64, False, 1 << 30, True, 0),
               (1, 129, 200, 4, 1, 256, True, 60, False, 50),
               (1, 150, 120, 4, 1, 128, False, 40, False, 100),
               (1, 100, 90, 2, 1, 256, True, 20, False, 100)]


def _tc_close(out, q, k, v, kw):
    """The tensor-core kernel against the plain emulation of its rounding
    points (p rounded to bf16 at the running max of each KV tile). With
    the same running maxima the two round the same float32 weights; they
    part only where the order of the float32 sums of a score puts its
    weight on the other side of a bf16 rounding boundary (that weight
    moves by one bf16 ulp, at most 2^-7 of it) and in the output's own
    rounding (one bf16 ulp, at most 2^-7 |e|): |out - e| <= 2^-7 |e| +
    2^-10 max|v|, the absolute term covering such weights up to 1/8 of a
    row's mass. Returns the largest |out - e| over that bound."""
    e = attention_ref(q, k, v, p_bf16=True,
                      kv_tile=flash_kernel.tc_kv_tile(q.shape[3]),
                      **kw).float()
    bound = 2.0 ** -7 * e.abs() + 2.0 ** -10 * float(v.float().abs().max())
    return float(((out.float() - e).abs() / bound).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain_version(cuda, case, dtype):
    """flash_attention_fwd against its plain version on the card, at the
    reference's tolerances (2e-5 float32, 2e-2 bfloat16); bf16 at D 64,
    128 and 256 takes the tensor-core route and is also held to the
    emulation of its rounding points, float32 and other head dims the SIMT
    route; bit-identical relaunch; one count per launch and route."""
    B, Sq, Skv, H, KH, D, causal, window, is_global, q_offset = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng((Sq, Skv, D))
    q, k, v = (torch.as_tensor(rng.normal(size=(B, s, n, D)), dtype=dt,
                               device=cuda)
               for s, n in ((Sq, H), (Skv, KH), (Skv, KH)))
    kw = dict(causal=causal, window=window, is_global=is_global,
              q_offset=q_offset)
    kind = "tensor_core" if dtype == "bfloat16" and D in (64, 128, 256) \
        else "simt"
    before = flash_kernel.LAUNCHES["flash_attention_fwd"]
    routes = dict(flash_kernel.ROUTES)
    out = flash_kernel.flash_attention_fwd(q, k, v, **kw)
    assert flash_kernel.ROUTES[kind] == routes[kind] + 1
    assert out.shape == q.shape and out.dtype == dt
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(),
                               attention_ref(q, k, v, **kw).float(),
                               rtol=tol, atol=tol)
    if kind == "tensor_core":
        assert _tc_close(out, q, k, v, kw) <= 1.0
    assert torch.equal(out, flash_kernel.flash_attention_fwd(q, k, v, **kw))
    assert flash_kernel.LAUNCHES["flash_attention_fwd"] == before + 2
    assert sum(flash_kernel.ROUTES.values()) == sum(routes.values()) + 2


def test_flash_bf16_takes_the_simt_route_at_other_head_dims_or_misaligned(
        cuda):
    """bf16 at D 100, and bf16 at D 128 whose q starts 2 bytes past a
    16-byte boundary (contiguous, at a storage offset of one element), go
    to the SIMT kernel, explicitly, and agree with the plain version."""
    rng = np.random.default_rng(5)

    def draw(s, n, d, offset=0):
        flat = torch.as_tensor(rng.normal(size=offset + 2 * s * n * d),
                               dtype=torch.bfloat16, device=cuda)
        return flat[offset:offset + 2 * s * n * d].view(2, s, n, d)

    kw = dict(causal=True, window=1 << 30, is_global=True, q_offset=0)
    for q, k, v in ((draw(90, 4, 100), draw(90, 2, 100), draw(90, 2, 100)),
                    (draw(90, 4, 128, 1), draw(90, 2, 128),
                     draw(90, 2, 128))):
        assert flash_kernel.route(q, k, v) == "simt"
        routes = dict(flash_kernel.ROUTES)
        out = flash_kernel.flash_attention_fwd(q, k, v, **kw)
        assert flash_kernel.ROUTES == dict(routes,
                                           simt=routes["simt"] + 1)
        torch.testing.assert_close(out.float(),
                                   attention_ref(q, k, v, **kw).float(),
                                   rtol=2e-2, atol=2e-2)


# (B, Sq, Skv, H, KH, D, causal, window, is_global, q_offset): GQA with G
# 1, 2 and 4, causal / window / global, lengths that are no multiple of a
# tile, Sq != Skv with an offset, every padded head dim, and blocks whose
# rows see no key (window 1 past the keys; a window that ends before the
# last rows). bf16 at D 64, 128 and 256 takes the tensor-core route, at D
# 16, 32, 48 and 100 the SIMT one
FLASH_BWD_CASES = [(2, 40, 40, 4, 2, 16, True, 16, False, 0),
                   (1, 130, 130, 4, 1, 256, True, 48, False, 0),
                   (1, 200, 200, 4, 1, 256, True, 1 << 30, True, 0),
                   (2, 70, 70, 2, 2, 64, True, 1 << 30, True, 0),
                   (1, 97, 161, 8, 2, 128, True, 1 << 30, True, 64),
                   (1, 65, 90, 4, 4, 100, False, 1 << 30, True, 0),
                   (1, 150, 120, 4, 1, 128, False, 40, False, 100),
                   (1, 33, 20, 2, 1, 32, True, 1, False, 30),
                   (2, 90, 75, 4, 2, 64, True, 24, False, 20),
                   (1, 300, 260, 4, 2, 256, True, 1 << 30, True, 40),
                   (1, 33, 20, 2, 1, 64, True, 1, False, 30),
                   (1, 50, 50, 4, 2, 48, True, 1 << 30, True, 0)]


def _grad_close(got, want, dtype):
    """float32 within rtol 1e-4 (atol 1e-4 of the largest |grad|), bf16
    within 2e-2 of the largest |grad|."""
    scale = float(want.float().abs().max()) + 1e-30
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2e-2 * scale, (err, scale)


def _emulation_close(got, q, k, v, out, lse, dout, kw):
    """The tensor-core backward against the float32 emulation of its
    rounding points (`pds_bf16=True` on the same bf16 values, its sums
    left in float32): within 4e-3 of the largest |grad|. The two take the
    same bf16 operands and part in the float32 sums' order (a weight on
    the other side of a bf16 rounding boundary moves by one ulp) and in
    the kernel's output rounding (half an ulp of bf16, at most 2^-8 of
    the largest value)."""
    f = [t.float() for t in (q, k, v, out)]
    emu = flash_attention_bwd_ref(*f, lse, dout.float(), pds_bf16=True,
                                  **kw)
    for g, e in zip(got, emu):
        err = float((g.float() - e).abs().max())
        assert err <= 4e-3 * float(e.abs().max()), (err, float(e.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_attention_bwd_matches_plain_version(cuda, case, dtype):
    """flash_attention_bwd against `flash_attention_bwd_ref` on the same
    out and lse (the forward kernel's), the forward's lse against
    `attention_lse_ref`, serving's output bit-identical with and without
    the lse pointer, a bit-identical relaunch, one count per launch and
    route. bf16 at D 64, 128 and 256 takes the tensor-core route and is
    also held to the emulation of its rounding points; float32 and other
    head dims the SIMT route."""
    B, Sq, Skv, H, KH, D, causal, window, is_global, q_offset = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng((Sq, Skv, D, 7))
    q, dout = (torch.as_tensor(rng.normal(size=(B, Sq, H, D)), dtype=dt,
                               device=cuda) for _ in range(2))
    k, v = (torch.as_tensor(rng.normal(size=(B, Skv, KH, D)), dtype=dt,
                            device=cuda) for _ in range(2))
    kw = dict(causal=causal, window=window, is_global=is_global,
              q_offset=q_offset)
    out, lse = flash_kernel.flash_attention_fwd(q, k, v, return_lse=True,
                                                **kw)
    assert torch.equal(out, flash_kernel.flash_attention_fwd(q, k, v, **kw))
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, attention_lse_ref(q, k, **kw),
                               rtol=1e-5, atol=1e-4)
    kind = "tensor_core" if dtype == "bfloat16" and D in (64, 128, 256) \
        else "simt"
    assert flash_kernel.bwd_route(q, k, v, out, dout) == kind
    before = dict(flash_kernel.LAUNCHES)
    routes = dict(flash_kernel.BWD_ROUTES)
    got = flash_kernel.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dt
        _grad_close(g, w, dtype)
    if kind == "tensor_core":
        _emulation_close(got, q, k, v, out, lse, dout, kw)
    again = flash_kernel.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert flash_kernel.LAUNCHES == dict(
        before, flash_attention_bwd=before["flash_attention_bwd"] + 2)
    assert flash_kernel.BWD_ROUTES == dict(routes,
                                           **{kind: routes[kind] + 2})


def test_flash_attention_op_trains_through_the_kernels(cuda):
    """With grad on, the op's forward writes lse and its backward is the
    kernel, bf16 at D 64 on the tensor-core route: q, k, v grads equal a
    direct `flash_attention_bwd` call; under no_grad it is the forward
    alone."""
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.normal(size=(2, 96, 4, 64)),
                        dtype=torch.bfloat16, device=cuda)
    k, v = (torch.as_tensor(rng.normal(size=(2, 96, 1, 64)),
                            dtype=torch.bfloat16, device=cuda)
            for _ in range(2))
    dout = torch.as_tensor(rng.normal(size=q.shape), dtype=torch.bfloat16,
                           device=cuda)
    kw = dict(causal=True, window=32, is_global=False, q_offset=0)
    before = dict(flash_kernel.LAUNCHES)
    routes = dict(flash_kernel.BWD_ROUTES)
    with torch.no_grad():
        plain_out = flash_attention_op(q, k, v, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_op(*leaves, **kw)
    out.backward(dout)
    assert torch.equal(out.detach(), plain_out)
    assert flash_kernel.LAUNCHES == dict(
        before, flash_attention_fwd=before["flash_attention_fwd"] + 2,
        flash_attention_bwd=before["flash_attention_bwd"] + 1)
    assert flash_kernel.BWD_ROUTES == dict(
        routes, tensor_core=routes["tensor_core"] + 1)
    _, lse = flash_kernel.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    want = flash_kernel.flash_attention_bwd(q, k, v, plain_out, lse, dout,
                                            **kw)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 8, 4, 16), device=cuda)
    k = torch.zeros((1, 8, 2, 16), device=cuda)
    qb = torch.zeros((1, 8, 4, 128), device=cuda, dtype=torch.bfloat16)
    kb = torch.zeros((1, 8, 2, 128), device=cuda, dtype=torch.bfloat16)
    before = dict(flash_kernel.LAUNCHES)
    routes = dict(flash_kernel.ROUTES)
    bad = [((q.double(), k.double(), k.double()), {}, TypeError),
           ((q, k.bfloat16(), k), {}, TypeError),
           ((q, k, k.cpu()), {}, ValueError),
           ((q.transpose(1, 2), k, k), {}, ValueError),
           ((q, torch.zeros((1, 8, 3, 16), device=cuda),
             torch.zeros((1, 8, 3, 16), device=cuda)), {}, ValueError),
           ((torch.zeros((1, 8, 4, 300), device=cuda),
             torch.zeros((1, 8, 2, 300), device=cuda),
             torch.zeros((1, 8, 2, 300), device=cuda)), {}, ValueError),
           ((q, k, k), {"q_offset": -1}, ValueError),
           # inputs the tensor-core route would take, refused all the same
           ((qb, kb, kb), {"q_offset": -1}, ValueError),
           ((qb, kb[:, :0], kb[:, :0]), {}, ValueError),
           ((qb, kb, kb.float()), {}, TypeError)]
    for args, kw, err in bad:
        with pytest.raises(err):
            flash_kernel.flash_attention_fwd(*args, **kw)
    assert flash_kernel.LAUNCHES == before
    assert flash_kernel.ROUTES == routes


def _serve_logits(cfg, params, tokens, steps, device):
    """Prefill, then `steps` greedy decode steps against a float32 cache:
    the logits of each token, on `device`."""
    params = transformer.cast_params(cfg, params, device)
    tokens = tokens.to(device)
    with torch.no_grad():
        logits, pcache = transformer.prefill(cfg, params, {"tokens": tokens})
        B, P = tokens.shape
        cache = transformer.fill_cache(cfg, transformer.init_cache(
            cfg, B, P + steps, torch.float32, device), pcache)
        out = [logits[:, -1]]
        for t in range(steps):
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            logits, cache = transformer.decode_step(cfg, params, cache, tok,
                                                    P + t)
            out.append(logits[:, -1])
    return [o.cpu() for o in out]


def test_generate_on_the_card_matches_the_cpu(cuda):
    """Reduced gemma3-1b in float32, same parameters and prompts: the
    prefill logits and 8 decode steps agree within rtol 1e-4 through a
    float32 cache, and `generate` gives equal greedy ids (its bf16 cache
    rounds keys that differ by a float32 ulp to neighbouring bf16 values
    now and then, so its logits are compared only through the ids); the
    card's prefill launches the kernel once per layer, its decode steps
    never."""
    cfg = LM_CONFIGS["gemma3-1b"].reduced().scaled(dtype="float32")
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    for a, b in zip(_serve_logits(cfg, params, tokens, 8, cuda),
                    _serve_logits(cfg, params, tokens, 8, "cpu")):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    cpu = generate(cfg, params, tokens, 8, device="cpu")
    flash_kernel.reset_launches()
    gpu = generate(cfg, params, tokens, 8, device=cuda)
    assert flash_kernel.LAUNCHES["flash_attention_fwd"] == cfg.num_layers
    assert torch.equal(gpu.ids.cpu(), cpu.ids)


# (E, C, d, f): the decode (8) and prefill (344 per group, 688 for two)
# capacities at one expert and at qwen2-moe's 60, narrow widths; d and f
# that no tile divides (the 16-byte path: d, f multiples of 8; the
# element path: odd widths); and qwen2-moe-a2.7b's full prefill shape
GMM_CASES = [(1, 8, 64, 32), (60, 8, 128, 64), (1, 344, 256, 136),
             (60, 344, 64, 96), (60, 688, 128, 128), (3, 344, 200, 136),
             (2, 8, 1001, 703), (4, 344, 77, 33), (1, 5, 0, 16),
             (60, 688, 2048, 1408)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GMM_CASES)
def test_moe_gmm_matches_plain_version(cuda, case, dtype):
    """moe_gmm_fwd against its plain version (float32 einsum of the same
    inputs) on the card: max error within 1e-3 * max |plain| for bf16
    inputs (products exact, float32 sums in another order on the tensor
    cores), 2e-5 * max |plain| for float32; bit-identical relaunch; one
    count per launch."""
    E, C, d, f = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(case)
    x = torch.as_tensor(rng.normal(size=(E, C, d)), dtype=dt, device=cuda)
    w = torch.as_tensor(rng.normal(size=(E, d, f)) / np.sqrt(max(d, 1)),
                        dtype=dt, device=cuda)
    before = gmm_kernel.LAUNCHES["moe_gmm_fwd"]
    out = gmm_kernel.moe_gmm_fwd(x, w)
    assert out.shape == (E, C, f) and out.dtype == torch.float32
    want = moe_gmm_ref(x, w)
    tol = (1e-3 if dtype == "bfloat16" else 2e-5) * max(
        float(want.abs().max()), 1e-30)
    assert float((out - want).abs().max()) <= tol
    assert torch.equal(out, gmm_kernel.moe_gmm_fwd(x, w))
    assert gmm_kernel.LAUNCHES["moe_gmm_fwd"] == before + 2


def test_moe_gmm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 8, 16), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((2, 16, 8), device=cuda, dtype=torch.bfloat16)
    before = dict(gmm_kernel.LAUNCHES)
    bad = [((x.double(), w.double()), TypeError),
           ((x.to(torch.int32), w.to(torch.int32)), TypeError),
           ((x, w.float()), TypeError),
           ((x, w.cpu()), ValueError),
           ((x, torch.zeros((2, 17, 8), device=cuda, dtype=x.dtype)),
            ValueError),
           ((x, torch.zeros((3, 16, 8), device=cuda, dtype=x.dtype)),
            ValueError),
           ((x[0], w[0]), ValueError),
           ((x.transpose(1, 2).contiguous().transpose(1, 2), w),
            ValueError),
           ((torch.zeros((65536, 1, 1), device=cuda, dtype=x.dtype),
             torch.zeros((65536, 1, 1), device=cuda, dtype=x.dtype)),
            ValueError)]
    for args, err in bad:
        with pytest.raises(err):
            gmm_kernel.moe_gmm_fwd(*args)
    assert gmm_kernel.LAUNCHES == before


# (E, C, G, d, f): decode's C 8 (mma_sync), C 17 (the smallest on the
# tensor-core route), 130 (a second row tile of 2 rows), 344 and two groups
# of 344 (the prefill's capacities), d 2040 / f 1400 (multiples of 8, not
# of 64: ragged k and column tiles on the tensor-core route), f 512 (its
# 256-column tiles), odd widths at C 130, and past the tensor-core
# route's limits, 257 experts and C 4104 (mma_sync)
GMM_EPI_CASES = [(5, 8, 1, 64, 128), (4, 17, 1, 72, 136),
                 (4, 130, 2, 128, 64), (4, 344, 1, 2040, 1400),
                 (4, 688, 2, 256, 264), (3, 688, 2, 192, 512),
                 (4, 130, 1, 77, 33), (257, 24, 2, 16, 16),
                 (3, 4104, 2, 16, 24)]


def _rows_and_input(E, C, G, d, rng, dt, device):
    """`rows` (E, G) with expert 0 empty, expert 1 full, expert 2 ending
    mid-tile (C / G // 2 + 3 rows, or 1 when that passes C / G), the
    others random; x zero past each group's count, as the MoE buffer is."""
    Cg = C // G
    rows = rng.integers(0, Cg + 1, (E, G))
    rows[0], rows[1], rows[2] = 0, Cg, min(Cg // 2 + 3, Cg) if Cg > 4 else 1
    x = rng.normal(size=(E, G, Cg, d))
    x[np.arange(Cg)[None, None, :] >= rows[..., None]] = 0.0
    return (torch.as_tensor(rows, dtype=torch.int32, device=device),
            torch.as_tensor(x.reshape(E, C, d), dtype=dt, device=device))


@pytest.mark.parametrize("epilogue", ["float32", "in_dtype", "gated"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GMM_EPI_CASES)
def test_moe_gmm_routes_epilogues_and_rows(cuda, case, dtype, epilogue):
    """Each route x epilogue x `rows` on the card: the route taken (simt
    for float32, tensor_core for bf16 at C > 16 with widths a multiple of
    8, mma_sync otherwise); the float32 output within 1e-3 (bf16) / 2e-5
    (float32) x max |plain|; the output in x's dtype equal, bit for bit,
    to the same route's float32 output cast; the gated one to the
    composite of the same route's two float32 outputs (`.to`, `F.silu`,
    `*` on the card); and every output with `rows` (expert 0 empty, 1
    full, 2 ending mid-tile) equal to the one without, and to a relaunch.
    One count per launch, in the one key and in the route's."""
    E, C, G, d, f = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng((*case, len(dtype)))
    rows, x = _rows_and_input(E, C, G, d, rng, dt, cuda)
    w, wu = (torch.as_tensor(rng.normal(size=(E, d, f)) / np.sqrt(d),
                             dtype=dt, device=cuda) for _ in range(2))
    kind = ("simt" if dtype == "float32" else
            "tensor_core" if 16 < C <= 4096 and E <= 256 and d % 8 == 0
            and f % 8 == 0 else "mma_sync")
    assert gmm_kernel.route(x, w, wu) == kind
    if epilogue == "gated":
        def op(rows=None):
            return gmm_kernel.moe_gmm_gated_fwd(x, w, wu, rows=rows)
    else:
        out_dtype = torch.float32 if epilogue == "float32" else dt

        def op(rows=None):
            return gmm_kernel.moe_gmm_fwd(x, w, rows=rows,
                                          out_dtype=out_dtype)
    launches, routes = gmm_kernel.LAUNCHES["moe_gmm_fwd"], dict(
        gmm_kernel.ROUTES)
    dense, skipped = op(), op(rows)
    assert gmm_kernel.LAUNCHES["moe_gmm_fwd"] == launches + 2
    assert gmm_kernel.ROUTES == dict(routes, **{kind: routes[kind] + 2})
    assert torch.equal(dense, skipped)
    assert torch.equal(skipped, op(rows))
    assert dense.shape == (E, C, f)
    assert dense.dtype == (torch.float32 if epilogue == "float32" else dt)
    g32 = gmm_kernel.moe_gmm_fwd(x, w)
    if epilogue == "float32":
        want = moe_gmm_ref(x, w)
        tol = (1e-3 if dtype == "bfloat16" else 2e-5) * float(
            want.abs().max())
        assert float((dense - want).abs().max()) <= tol
        assert bool(dense[0].eq(0).all())
    elif epilogue == "in_dtype":
        assert torch.equal(dense, g32.to(dt))
    else:
        u32 = gmm_kernel.moe_gmm_fwd(x, wu)
        assert torch.equal(dense, Fn.silu(g32.to(dt)) * u32.to(dt))


def test_moe_gmm_gated_holds_the_composite_past_the_fast_silu_range(cuda):
    """The tensor-core gated epilogue divides branch-free only where every
    value of a warp has 2^-60 <= |bf16(g)| <= 40; rows scaled so that some
    warps hold |g| up to ~150 (silu's IEEE division with its branch) and
    tiny ones (|g| < 2^-60) still equal the composite of the float32
    outputs bit for bit."""
    E, C, d, f = 3, 344, 256, 256
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.normal(size=(E, C, d)), dtype=torch.bfloat16,
                        device=cuda)
    x[:, :40] *= 60.0
    x[:, 40:60] *= 2.0 ** -70
    w, wu = (torch.as_tensor(rng.normal(size=(E, d, f)) / 16,
                             dtype=torch.bfloat16, device=cuda)
             for _ in range(2))
    assert gmm_kernel.route(x, w, wu) == "tensor_core"
    g32, u32 = gmm_kernel.moe_gmm_fwd(x, w), gmm_kernel.moe_gmm_fwd(x, wu)
    assert float(g32.abs().max()) > 40.0
    got = gmm_kernel.moe_gmm_gated_fwd(x, w, wu)
    assert torch.equal(got, Fn.silu(g32.to(x.dtype)) * u32.to(x.dtype))


def test_moe_gmm_rows_skip_whole_experts_in_decode(cuda):
    """Decode's shape (C 8, one group) with a single occupied expert: the
    output equals the dense one, the empty experts' outputs are zero even
    where their weights hold NaN (a skipped expert reads no weight)."""
    E, C, d, f = 6, 8, 256, 128
    rng = np.random.default_rng(3)
    x = torch.zeros((E, C, d), dtype=torch.bfloat16, device=cuda)
    x[4, :3] = torch.as_tensor(rng.normal(size=(3, d)), dtype=x.dtype,
                               device=cuda)
    w = torch.as_tensor(rng.normal(size=(E, d, f)) / 16, dtype=x.dtype,
                        device=cuda)
    rows = torch.tensor([[0], [0], [0], [0], [3], [0]], dtype=torch.int32,
                        device=cuda)
    dense = gmm_kernel.moe_gmm_gated_fwd(x, w, w)
    poisoned = w.clone()
    poisoned[torch.arange(E, device=cuda) != 4] = float("nan")
    got = gmm_kernel.moe_gmm_gated_fwd(x, poisoned, poisoned, rows=rows)
    assert gmm_kernel.route(x, w) == "mma_sync"
    assert torch.equal(got, dense)
    assert bool(got[torch.arange(E, device=cuda) != 4].eq(0).all())


def test_moe_gmm_refuses_rows_it_cannot_read_on_the_card(cuda):
    x = torch.zeros((4, 24, 16), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((4, 16, 8), device=cuda, dtype=torch.bfloat16)
    ok = torch.zeros((4, 2), device=cuda, dtype=torch.int32)
    before = (dict(gmm_kernel.LAUNCHES), dict(gmm_kernel.ROUTES))
    bad = [(ok.cpu(), ValueError), (ok.long(), TypeError),
           (ok[:3], ValueError), (ok[:, 0], ValueError),
           (torch.zeros((4, 5), device=cuda, dtype=torch.int32), ValueError),
           (torch.zeros((2, 4), device=cuda, dtype=torch.int32).T,
            ValueError)]
    for rows, err in bad:
        with pytest.raises(err):
            gmm_kernel.moe_gmm_fwd(x, w, rows=rows)
        with pytest.raises(err):
            gmm_kernel.moe_gmm_gated_fwd(x, w, w, rows=rows)
    with pytest.raises(TypeError):
        gmm_kernel.moe_gmm_fwd(x, w, out_dtype=torch.float16)
    assert (gmm_kernel.LAUNCHES, gmm_kernel.ROUTES) == before


def test_moe_generate_on_the_card_matches_the_cpu(cuda):
    """Reduced qwen2-moe-a2.7b in float32, same parameters and prompts:
    prefill and 8 decode steps' logits within rtol 1e-4 / atol 1e-5
    through a float32 cache, `generate`'s greedy ids equal; exactly 2
    moe_gmm_fwd launches per layer (the gated one and the down product)
    in the prefill and in every decode step, all on the simt route."""
    cfg = LM_CONFIGS["qwen2-moe-a2.7b"].reduced().scaled(dtype="float32")
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    on_card = transformer.cast_params(cfg, params, cuda)
    with torch.no_grad():
        gmm_kernel.reset_launches()
        logits, pcache = transformer.prefill(cfg, on_card,
                                             {"tokens": tokens.to(cuda)})
        assert gmm_kernel.LAUNCHES["moe_gmm_fwd"] == 2 * cfg.num_layers
        cache = transformer.init_cache(cfg, 2, 41, torch.float32, cuda)
        for key in ("k", "v"):
            cache[key][:, :, :40] = pcache[key]
        gmm_kernel.reset_launches()
        transformer.decode_step(cfg, on_card, cache, torch.argmax(
            logits[:, -1], dim=-1, keepdim=True), 40)
        assert gmm_kernel.LAUNCHES["moe_gmm_fwd"] == 2 * cfg.num_layers
    card = _serve_logits(cfg, params, tokens, 8, cuda)
    for a, b in zip(card, _serve_logits(cfg, params, tokens, 8, "cpu")):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    cpu = generate(cfg, params, tokens, 8, device="cpu")
    gmm_kernel.reset_launches()
    flash_kernel.reset_launches()
    gpu = generate(cfg, params, tokens, 8, device=cuda)
    assert gmm_kernel.LAUNCHES["moe_gmm_fwd"] == 2 * cfg.num_layers * 9
    assert gmm_kernel.ROUTES == {"tensor_core": 0, "mma_sync": 0,
                                 "simt": 2 * cfg.num_layers * 9}
    assert flash_kernel.LAUNCHES["flash_attention_fwd"] == cfg.num_layers
    assert torch.equal(gpu.ids.cpu(), cpu.ids)


class _TopkReplay:
    """Stands in for `torch` inside `models/lm/moe.py`: its first run
    records each layer's top-k expert choices, a later run takes the same
    choices (its own probabilities gathered at them) and counts the tokens
    whose own choice differs. Routing is discontinuous: two devices whose
    hidden states differ by bf16 rounding pick other experts for
    near-ties, so the logits are held on the same choices."""

    def __init__(self):
        self.seen, self.at, self.flips, self.tokens = [], None, 0, 0

    def __getattr__(self, name):
        return getattr(torch, name)

    def topk(self, probs, k, dim=-1):
        v, i = torch.topk(probs, k, dim=dim)
        if self.at is None:
            self.seen.append(i.cpu())
            return v, i
        want = self.seen[self.at].to(i.device)
        self.at += 1
        differ = (torch.sort(i, dim)[0] != torch.sort(want, dim)[0]).any(dim)
        self.flips += int(differ.sum())
        self.tokens += differ.numel()
        return torch.gather(probs, dim, want), want


def _teacher_logits(cfg, params, tokens, feed, device):
    """Prefill `tokens`, then one decode step per column of `feed` (the
    same tokens on every device, so that no argmax tie can send two
    devices down other paths) against a cache in the compute dtype: the
    last logits of the prefill and of each step, float32 on the CPU."""
    params = transformer.cast_params(cfg, params, device)
    dt = getattr(torch, cfg.dtype)
    with torch.no_grad():
        logits, pcache = transformer.prefill(
            cfg, params, {"tokens": tokens.to(device)})
        B, P = tokens.shape
        cache = transformer.fill_cache(cfg, transformer.init_cache(
            cfg, B, P + feed.shape[1], dt, device), pcache)
        out = [logits[:, -1]]
        for t in range(feed.shape[1]):
            logits, cache = transformer.decode_step(
                cfg, params, cache, feed[:, t:t + 1].to(device), P + t)
            out.append(logits[:, -1])
    return [o.float().cpu() for o in out]


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-moe-a2.7b"])
def test_bf16_serving_on_the_tensor_core_routes_matches_the_cpu(cuda, arch):
    """The reduced model in bf16 at head_dim 64, so that the prefill's
    flash launches take the tensor-core kernel, and (qwen2-moe-a2.7b) a
    prefill of 2 x 64 tokens, whose expert capacity 40 > 16 takes the
    grouped matmul's tensor-core kernel; decode's capacity of 8 takes
    mma_sync. Prefill and 8 decode steps' logits within 5e-2 x max |logit|
    of the CPU bf16 model on the same parameters, tokens and expert
    choices (`_TopkReplay`), the bound the CPU tests hold against JAX in
    bf16."""
    cfg = LM_CONFIGS[arch].reduced().scaled(head_dim=64)
    assert cfg.dtype == "bfloat16"
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    feed = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    replay = _TopkReplay()
    moe_module.torch = replay
    try:
        cpu = _teacher_logits(cfg, params, tokens, feed, "cpu")
        replay.at = 0
        flash_kernel.reset_launches()
        gmm_kernel.reset_launches()
        card = _teacher_logits(cfg, params, tokens, feed, cuda)
    finally:
        moe_module.torch = torch
    assert flash_kernel.ROUTES == {"tensor_core": cfg.num_layers,
                                   "simt": 0}
    if cfg.moe:
        assert gmm_kernel.ROUTES == {"tensor_core": 2 * cfg.num_layers,
                                     "mma_sync": 2 * cfg.num_layers * 8,
                                     "simt": 0}
    assert replay.at == len(replay.seen)
    for a, b in zip(card, cpu):
        assert bool(torch.isfinite(a).all())
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert err <= 5e-2 * scale, (err, scale)


def _wkv_inputs(B, T, H, N, dtype, state, device):
    """r, k, v unit normal in `dtype`; logw = clip(-exp(z), -5, -1e-4) as
    the model clamps it, both ends of the clip occurring; u 0.1 x normal;
    s0 normal or None."""
    rng = np.random.default_rng((B, T, H, N, int(state)))
    r, k, v = (torch.as_tensor(rng.normal(size=(B, T, H, N)), dtype=dtype,
                               device=device) for _ in range(3))
    z = rng.normal(size=(B, T, H, N)) * 4.0 - 0.6
    logw = torch.as_tensor(np.clip(-np.exp(z), -5.0, -1e-4),
                           dtype=torch.float32, device=device)
    u = torch.as_tensor(rng.normal(size=(H, N)) * 0.1, dtype=torch.float32,
                        device=device)
    s0 = torch.as_tensor(rng.normal(size=(B, H, N, N)), dtype=torch.float32,
                         device=device) if state else None
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("N", [16, 32, 48, 64])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 47, 2047, 2048])
def test_wkv6_matches_plain_version(cuda, T, N, state, dtype):
    """wkv6_fwd against its plain version (the chunked form on float32
    casts, the scan where 16 does not divide T) on the card, output and
    final state: max error within 2e-5 * max |plain| for float32 and for
    bf16 inputs alike (both sides work in float32 from the same values;
    the factored exps reach e^80, so float32 rounding scales with the
    largest values); bit-identical relaunch; one count per launch. N 32
    and 48 leave columns of the kernel's 64 empty, T 17 and 2047 a ragged
    last chunk, and B 1 x H 8 (the long sequences) far fewer blocks than
    SMs."""
    B, H = (1, 8) if T >= 2047 else (2, 3)
    dt = getattr(torch, dtype)
    r, k, v, logw, u, s0 = _wkv_inputs(B, T, H, N, dt, state, cuda)
    before = wkv_kernel.LAUNCHES["wkv6_fwd"]
    out, s_f = wkv_kernel.wkv6_fwd(r, k, v, logw, u, s0)
    assert out.shape == (B, T, H, N) and out.dtype == torch.float32
    assert s_f.shape == (B, H, N, N) and s_f.dtype == torch.float32
    want, want_s = wkv6_fwd_ref(r, k, v, logw, u, s0)
    rel = 2e-5
    for got, ref_ in ((out, want), (s_f, want_s)):
        assert bool(torch.isfinite(got).all())
        assert float((got - ref_).abs().max()) <= rel * float(
            ref_.abs().max())
    again = wkv_kernel.wkv6_fwd(r, k, v, logw, u, s0)
    assert torch.equal(out, again[0]) and torch.equal(s_f, again[1])
    assert wkv_kernel.LAUNCHES["wkv6_fwd"] == before + 2


def test_wkv6_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    r, k, v, logw, u, s0 = _wkv_inputs(1, 8, 2, 16, torch.bfloat16, True,
                                       cuda)
    wide = _wkv_inputs(1, 8, 1, 65, torch.float32, False, cuda)
    before = dict(wkv_kernel.LAUNCHES)
    bad = [((r.double(), k.double(), v.double(), logw, u), TypeError),
           ((r, k.float(), v, logw, u), TypeError),
           ((r, k, v, logw.to(torch.bfloat16), u), TypeError),
           ((r, k, v, logw, u.double()), TypeError),
           ((r, k, v, logw, u, s0.to(torch.bfloat16)), TypeError),
           ((r, k.cpu(), v, logw, u), ValueError),
           ((r, k[:, :4].contiguous(), v, logw, u), ValueError),
           ((r, k, v, logw, u[:1].contiguous()), ValueError),
           ((r, k, v, logw, u, s0[:, :1].contiguous()), ValueError),
           ((r[0], k[0], v[0], logw[0], u), ValueError),
           ((r.transpose(1, 2).contiguous().transpose(1, 2), k, v, logw,
             u), ValueError),
           ((r[:, :0], k[:, :0], v[:, :0], logw[:, :0], u), ValueError),
           (wide[:5], ValueError)]
    for args, err in bad:
        with pytest.raises(err):
            wkv_kernel.wkv6_fwd(*args)
    assert wkv_kernel.LAUNCHES == before


def test_rwkv_generate_on_the_card_matches_the_cpu(cuda):
    """Reduced rwkv6-7b in float32, same parameters and prompts: prefill
    and 8 decode steps' logits within rtol 1e-4 / atol 1e-5 through a
    float32 state, `generate`'s greedy ids equal; exactly one wkv6_fwd
    launch per layer in the prefill and none in a decode step."""
    cfg = LM_CONFIGS["rwkv6-7b"].reduced().scaled(dtype="float32")
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    card = _serve_logits(cfg, params, tokens, 8, cuda)
    for a, b in zip(card, _serve_logits(cfg, params, tokens, 8, "cpu")):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    cpu = generate(cfg, params, tokens, 8, device="cpu")
    wkv_kernel.reset_launches()
    gpu = generate(cfg, params, tokens, 8, device=cuda)
    assert wkv_kernel.LAUNCHES["wkv6_fwd"] == cfg.num_layers
    assert torch.equal(gpu.ids.cpu(), cpu.ids)


# ---------------------------------------------------------------------------
# the dynamic cache's epoch-boundary CLOCK walk
# ---------------------------------------------------------------------------
# (N, C, max_freq, kind): C words of 4 bytes stay resident in shared
# memory up to the 227 KB a block may opt into (46,593 is the reddit-602
# cache); 60,000, 100,000 and ogbn-products' 489,805 stream through the
# walk's ring. C 31, 32 and 33 sit at the window's width; "all_bits" sets
# every bit, "no_victim" leaves no slot colder than any candidate (the
# first candidate walks 2C steps and fails)
CLOCK_CASES = [(40, 1, 3, "random"), (500, 7, 4, "random"),
               (5000, 1023, 6, "random"), (5000, 1025, 2, "random"),
               (50_000, 4096, 20, "random"), (232_965, 46_593, 30, "random"),
               (232_965, 60_000, 30, "random"),
               (300_000, 100_000, 5, "random"),
               (2_449_029, 489_805, 30, "random"), (500, 31, 4, "random"),
               (500, 32, 4, "random"), (500, 33, 4, "random"),
               (5000, 1024, 6, "all_bits"), (300_000, 100_000, 5, "all_bits"),
               (5000, 1024, 6, "no_victim"),
               (300_000, 100_000, 5, "no_victim")]


@pytest.mark.parametrize("n,c,max_freq,kind", CLOCK_CASES)
def test_clock_refill_kernel_matches_plain_version(cuda, n, c, max_freq,
                                                   kind):
    """Slot for slot equal to the plain walk on a CPU copy: pos,
    slot_ids, the bits (those a failed pass clears too), slot_freq, hand,
    the admissions and the step count; a relaunch is bit-identical; the
    words live where `kernel.home` says; the warp decided as many windows
    as the numpy decomposition at the kernel's window counts."""
    st = clock_state(n, c, max_freq, 0, cuda, kind)
    args = walk_args(st)
    walk_kernel.reset_launches()
    rounds = torch.full((1,), -1, dtype=torch.int64, device=cuda)
    got = walk_kernel.clock_refill(*args, rounds=rounds)
    want = clock_refill_ref(*(a.cpu() for a in args))
    plan = clock_walk_windows(*(args[i].cpu().numpy() for i in (2, 3, 4, 6)),
                              walk_kernel.window())
    assert int(rounds) == plan.windows
    assert plan.visits == int(want.steps) + int(want.n_admitted)
    n_adm = int(want.n_admitted)
    assert int(got.n_admitted) == n_adm
    assert (n_adm == 0) == (kind == "no_victim")
    for f in ("pos", "slot_ids", "refbit", "slot_freq", "hand", "steps"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f in ("adm_slots", "adm_nodes"):
        assert torch.equal(getattr(got, f)[:n_adm].cpu(),
                           getattr(want, f)[:n_adm]), f
    again = walk_kernel.clock_refill(*args)
    for f in got._fields:
        a, b = getattr(got, f), getattr(again, f)
        if f in ("adm_slots", "adm_nodes"):
            a, b = a[:n_adm], b[:n_adm]
        assert torch.equal(a, b), f
    assert walk_kernel.LAUNCHES["clock_refill"] == 2
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert walk_kernel.SMEM[walk_kernel.home(c, optin)] == 2


def test_clock_walk_window_and_homes_come_from_the_kernel(cuda):
    """The C side's window is one the CPU tests hold the decomposition at
    (`WINDOWS` in tests/test_torch_clock_refill.py); reddit-602's 46,593
    words stay resident, ogbn-products' 489,805 stream."""
    assert walk_kernel.window() in (1, 32, 128, 256)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert walk_kernel.home(46_593, optin) == "resident"
    assert walk_kernel.home(489_805, optin) == "streamed"
    assert walk_kernel.home(optin // 4, optin) == "streamed"


UNSORTED_FS = """
import sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels.clock_refill import kernel
i32 = dict(dtype=torch.int32, device="cuda")
w = kernel.clock_refill(
    torch.tensor([0, 1, -1, -1], **i32), torch.tensor([0, 1], **i32),
    torch.tensor([0, 0], **i32), torch.tensor([0, 0], **i32),
    torch.tensor(0, **i32), torch.tensor([2, 3], **i32),
    torch.tensor([1, 2], **i32))
torch.cuda.synchronize()
print("no error", w.n_admitted.item())
"""


def test_unsorted_candidate_frequencies_fail_loudly(cuda):
    """The walk takes runs of equal frequency from candidates sorted high
    to low: out of order, the prepare stage traps (in a child process,
    since a trap poisons its CUDA context) and no walk comes back."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", UNSORTED_FS], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0, proc.stdout
    assert "no error" not in proc.stdout
    assert "error" in proc.stderr.lower(), proc.stderr[-2000:]


def test_dynamic_refill_on_the_card_equals_the_cpu(cuda):
    """`dynamic.refill` whole (candidate sort, the kernel, the row copy):
    the card's new state equals the CPU's, rows included."""
    n, c, f = 20_000, 4000, 33
    st = clock_state(n, c, 12, 2, "cpu")
    feats = torch.as_tensor(np.random.default_rng((2, 3)).normal(
        size=(n, f)), dtype=torch.float32)
    state = DynamicCacheState(cache=feats[st["slot_ids"].long()], **st,
                              capacity=c, policy="t")
    want, adm = dynamic.refill(state, feats)
    got, adm_card = dynamic.refill(state.to(cuda), feats.to(cuda))
    assert adm == adm_card > 0
    for k in DynamicCacheState.DATA_FIELDS:
        assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), k
    assert dynamic.integrity_ok(got)


def test_resume_on_the_card_is_bit_exact_with_the_dynamic_cache(
        cuda, tmp_path):
    """Tiny on the card: a run checkpointed at step 4 and resumed equals
    the uninterrupted run through the epoch-6 refill, losses, weights,
    AdamW's state and CLOCK state bit for bit; one clock_refill launch
    per epoch boundary."""
    g = prepare(synthetic.load("tiny"), oracle=True)
    cfg = GNNConfig("t", "sage", 2, 32, g.feat_dim, g.num_classes,
                    fanout=(5, 5), dropout=0.5)

    def make(d=None):
        return GNNTrainer(g, cfg, TrainConfig(batch_size=256), "comm_rand",
                          caps=(768, 1152), eval_caps=(768, 1152), seed=0,
                          cache="dynamic", cache_frac=0.3, ckpt_dir=d,
                          ckpt_every=4, device=cuda)

    walk_kernel.reset_launches()
    a = make()
    la = a.train_steps(13)
    assert walk_kernel.LAUNCHES["clock_refill"] == 2
    b = make(str(tmp_path))
    b.train_steps(7)
    b2 = make(str(tmp_path))
    assert b2.global_step == 4
    assert b2.train_steps(9) == la[4:]
    for x, y in zip(a.params.parameters(), b2.params.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(a.opt_state["m"] + a.opt_state["v"],
                    b2.opt_state["m"] + b2.opt_state["v"]):
        assert torch.equal(x, y)
    for k in DynamicCacheState.DATA_FIELDS:
        x, y = getattr(a.cache, k), getattr(b2.cache, k)
        assert x.device == y.device and torch.equal(x, y), k


# ---------------------------------------------------------------------------
# the async pipeline on the card (`repro_torch.pipeline`)
# ---------------------------------------------------------------------------
def _pipe_trainer(g, cuda, pipeline, cache=None):
    cfg = GNNConfig("t", "sage", 2, 32, g.feat_dim, g.num_classes,
                    fanout=(5, 5), dropout=0.5)
    return GNNTrainer(g, cfg, TrainConfig(batch_size=128), "comm_rand",
                      caps=(512, 1024), eval_caps=(512, 1024), seed=3,
                      cache=cache, pipeline=pipeline, device=cuda)


def test_async_equals_sync_on_the_card(cuda):
    """Tiny on the card, across two epoch boundaries with the dynamic
    cache: the async trainer's losses and CLOCK state equal the sync
    trainer's bit for bit; the builder launches no kernel of its own, so
    the step's launch counts do not change."""
    g = prepare(synthetic.load("tiny"), oracle=True)
    sync = _pipe_trainer(g, cuda, "sync", "dynamic")
    kernel.reset_launches()
    want = sync.train_steps(24)
    sync_launches = dict(kernel.LAUNCHES)
    asyn = _pipe_trainer(g, cuda, "async", "dynamic")
    kernel.reset_launches()
    try:
        got = asyn.train_steps(24)
    finally:
        asyn.stream.close()
    assert got == want
    assert dict(kernel.LAUNCHES) == sync_launches
    assert kernel.LAUNCHES["gather_agg_fwd"] == 2 * 24
    for k in DynamicCacheState.DATA_FIELDS:
        assert torch.equal(getattr(asyn.cache, k), getattr(sync.cache, k)), k
    assert asyn.guard_meter.producer_restarts == 0


def test_side_stream_handoff_survives_a_slow_consumer(cuda):
    """The consumer's stream sleeps before it reads each batch, so the
    producer runs ahead and its next builds allocate while the batch is
    still unread: without `wait_event` the read would see an unfinished
    batch, without `record_stream` the allocator could hand the batch's
    memory to the producer. The copies taken after each sleep equal the
    synchronous builds, and so do a slow trainer's losses."""
    g = prepare(synthetic.load("tiny"), oracle=True)
    args = (g, make_policy("comm_rand"), 128, (5, 5), (512, 1024))
    sync = BatchStream(*args, seed=7, device=cuda)
    asyn = AsyncBatchStream(*args, seed=7, device=cuda, depth=3)
    copies = []
    try:
        it = iter(asyn)
        for _ in range(2 * sync.num_batches(0)):
            torch.cuda._sleep(2_000_000)        # ~1 ms on the consumer
            copies.append([t.clone() for t in batch_tensors(next(it))])
    finally:
        asyn.close()
    torch.cuda.synchronize()
    it = iter(sync)
    for got in copies:
        want = list(batch_tensors(next(it)))
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    ref = _pipe_trainer(g, cuda, "sync").train_steps(16)
    slow = _pipe_trainer(g, cuda, "async")
    step = slow.train_step

    def sleepy(batch, *a, **k):
        torch.cuda._sleep(2_000_000)
        return step(batch, *a, **k)

    slow.train_step = sleepy
    try:
        assert slow.train_steps(16) == ref
    finally:
        slow.stream.close()


def test_traced_async_run_passes_the_gates_on_the_card(cuda, tmp_path):
    """A tiny traced async run with the dynamic cache, guard and
    checkpoints off: producer/consumer overlap > 0, no mid-epoch sync, no
    conformance problem, and the epochs' losses equal an untraced run's."""
    g = prepare(synthetic.load("tiny"), oracle=True)
    p = str(tmp_path / "t.jsonl")
    tr = _pipe_trainer(g, cuda, "async", "dynamic")
    try:
        with trace.enabled(p, run="gpu") as tracer:
            traced = [tr.run_epoch(1e-3)["loss"] for _ in range(2)]
            tracer.flush()
    finally:
        tr.stream.close()
    ref = _pipe_trainer(g, cuda, "async", "dynamic")
    try:
        untraced = [ref.run_epoch(1e-3)["loss"] for _ in range(2)]
    finally:
        ref.stream.close()
    assert traced == untraced
    rep = report.analyze(report.load_trace(p))
    assert rep["conformance_problems"] == []
    assert rep["overlap"]["overlap_frac"] > 0
    assert rep["mid_epoch_sync_count"] == 0
    assert len(rep["epochs"]) == 2


# ---------------------------------------------------------------------------
# the prior-work samplers and baselines on the card
# ---------------------------------------------------------------------------
def test_samplers_and_labor_ranks_on_the_card_equal_the_cpu(cuda):
    """LABOR's ranks bit for bit at tiny's and reddit-602's node counts;
    uniform (the same uniforms), full and labor (the same ranks) picks and
    masks element for element, with the isolated last node and padded
    rows, at fanouts below and above the degree."""
    from repro_torch import sampling
    from repro_torch.graphs.csr import DeviceGraph
    from repro_torch.sampling.device import _hash_rank01
    for n in (2000, 232_965):
        ids = torch.arange(n, dtype=torch.int64)
        assert torch.equal(_hash_rank01((7, 0xFFFFFFFF), ids.to(cuda)).cpu(),
                           _hash_rank01((7, 0xFFFFFFFF), ids))
    g = prepare(synthetic.load("tiny"), oracle=False)
    gc, gt = DeviceGraph.from_graph(g, cuda), DeviceGraph.from_graph(g, "cpu")
    rng = np.random.default_rng((0, 41))
    nodes = rng.integers(0, g.num_nodes, 300).astype(np.int32)
    nodes[:2], nodes[-3:] = g.num_nodes - 1, g.num_nodes
    nt = torch.as_tensor(nodes)
    lab = sampling.LaborSampler()
    ranks = lab.epoch_ctx((3, 9), gt)
    assert torch.equal(lab.epoch_ctx((3, 9), gc).cpu(), ranks)
    for fanout in (3, 10, 300):
        u = (torch.as_tensor(rng.random((300, fanout)), dtype=torch.float32),)
        cases = [(sampling.UniformSampler(), u, {}),
                 (sampling.FullNeighborhoodSampler(), (), {}),
                 (lab, (), {"ranks": ranks})]
        for s, args, kw in cases:
            want = s.sample(gt, nt, fanout, *args, **kw)
            got = s.sample(gc, nt.to(cuda), fanout,
                           *(a.to(cuda) for a in args),
                           **{k: v.to(cuda) for k, v in kw.items()})
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), (s.name, fanout)


def _labor_trainer(g, cuda, pipeline):
    cfg = GNNConfig("t", "sage", 2, 32, g.feat_dim, g.num_classes,
                    fanout=(5, 5), dropout=0.5)
    return GNNTrainer(g, cfg, TrainConfig(batch_size=128),
                      make_policy("labor"), caps=(512, 1024),
                      eval_caps=(512, 1024), seed=3, pipeline=pipeline,
                      device=cuda)


def test_labor_async_equals_sync_on_the_card(cuda, monkeypatch):
    """LABOR across an epoch boundary: the async trainer's losses equal the
    sync trainer's bit for bit, 2 fwd and 2 bwd_dx launches a step (1 a
    layer and 1 a layer's self rows past layer 0), and each stream hashes
    the ranks once an epoch."""
    from repro_torch import sampling
    g = prepare(synthetic.load("tiny"), oracle=True)
    calls = []
    ctx = sampling.LaborSampler.epoch_ctx
    monkeypatch.setattr(sampling.LaborSampler, "epoch_ctx",
                        lambda self, w, dg: calls.append(1) or
                        ctx(self, w, dg))
    steps = 2 * -(-len(g.train_ids) // 128) - 3
    sync = _labor_trainer(g, cuda, "sync")
    kernel.reset_launches()
    want = sync.train_steps(steps)
    assert kernel.LAUNCHES["gather_agg_fwd"] == 2 * steps
    assert kernel.LAUNCHES["gather_agg_bwd_dx"] == 2 * steps
    assert len(calls) == 2
    asyn = _labor_trainer(g, cuda, "async")
    try:
        assert asyn.train_steps(steps) == want
    finally:
        asyn.stream.close()
    assert len(calls) == 4


def _subgraph_runs(g, cuda, full: bool, steps: int = 3):
    from repro_torch.train.baselines import (SubgraphTrainer,
                                             clustergcn_batches,
                                             clustergcn_caps,
                                             induced_subgraph)
    cfg = GNNConfig("t", "sage", 3, 32, g.feat_dim, g.num_classes,
                    fanout=(5, 5, 5), dropout=0.0)
    if full:
        nodes = np.arange(g.num_nodes)
        caps = (g.num_nodes + 1, g.num_edges + 1)
    else:
        nodes = clustergcn_batches(g, 2, np.random.default_rng((0, 0)))[0]
        caps = clustergcn_caps(g, 2)
    out = {}
    for dev in (cuda, cuda, "cpu"):
        tr = SubgraphTrainer(g, cfg, TrainConfig(), seed=5, device=dev)
        batch = induced_subgraph(g, nodes, *caps, device=dev)
        kernel.reset_launches()
        losses = [float(tr.step(batch, 0, 0 if full else j))
                  for j in range(steps)]
        out.setdefault(str(dev), []).append(
            (losses, dict(kernel.LAUNCHES), dict(kernel.PLANS)))
    return out


@pytest.mark.parametrize("full", [False, True])
def test_subgraph_steps_relaunch_bit_identical_on_the_card(cuda, full):
    """A ClusterGCN part and the full batch: two fresh trainers' losses
    bit-identical on the card, within 1e-4 of the CPU's; 3 fwd and 5 bwd_dx
    launches a step (a layer's virtual-row means and their segment sum;
    the backward of layers 1 and 2: layer 0 reads the feature matrix), one
    plan for all steps on the batch."""
    g = prepare(synthetic.load("tiny"), oracle=True)
    runs = _subgraph_runs(g, cuda, full)
    (a, la, pa), (b, _, _) = runs[str(cuda)]
    (c, _, _), = runs["cpu"]
    assert a == b
    np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-4)
    assert la == {"gather_agg_fwd": 9, "gather_agg_bwd_dx": 15,
                  "gather_agg_bwd_dw": 0}
    assert pa == {"gather_agg_bwd_dx": 1}


def test_gather_mean_on_the_card_matches_plain_version(cuda):
    from repro_torch.kernels.gather_mean.ops import gather_mean
    from repro_torch.kernels.gather_mean.ref import gather_mean_ref
    rng = np.random.default_rng((0, 43))
    x = torch.as_tensor(rng.normal(size=(500, 602)), dtype=torch.float32,
                        device=cuda)
    idx = torch.as_tensor(rng.integers(0, 500, (700, 37)), dtype=torch.int32,
                          device=cuda)
    mask = torch.as_tensor(rng.random((700, 37)) < 0.6, device=cuda)
    mask[0] = False
    before = kernel.LAUNCHES["gather_agg_fwd"]
    got = gather_mean(x, idx, mask)
    assert kernel.LAUNCHES["gather_agg_fwd"] == before + 1
    torch.testing.assert_close(got, gather_mean_ref(x, idx, mask),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got, gather_mean(x, idx, mask))
    assert not got[0].any()


def test_reduced_lm_train_steps_on_the_card_match_the_cpu(cuda):
    """Reduced gemma3-1b in float32 (TF32 off), 3 steps of the train step
    (remat, chunked CE, clip, AdamW) from the same parameters and batches
    on the card and on the CPU: losses within rtol 1e-4; per step 2 L
    flash forwards (remat recomputes them), L flash backwards and one
    bwd_dx (the token embedding), nothing else."""
    from repro_torch.data.pipeline import LMStream, SyntheticTokens
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    cfg = LM_CONFIGS["gemma3-1b"].reduced().scaled(dtype="float32")
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    it = iter(LMStream(SyntheticTokens(cfg.vocab_size, 64, 64), 4, 32))
    data = [next(it) for _ in range(3)]
    step = make_train_step(cfg, TrainConfig(learning_rate=1e-3))
    losses = {}
    for dev in ("cpu", cuda):
        p = adamw.tree_map(lambda t: t.to(dev), params)
        opt = adamw.init(p)
        losses[str(dev)] = []
        for toks, labels in data:
            for m in (flash_kernel, kernel):
                m.reset_launches()
            p, opt, met = step(p, opt, {
                "tokens": torch.from_numpy(toks).to(dev),
                "labels": torch.from_numpy(labels).to(dev)})
            losses[str(dev)].append(float(met["loss"]))
            if dev != "cpu":
                L = cfg.num_layers
                assert flash_kernel.LAUNCHES == {
                    "flash_attention_fwd": 2 * L, "flash_attention_bwd": L}
                assert flash_kernel.BWD_ROUTES == {"tensor_core": 0,
                                                   "simt": L}
                assert kernel.LAUNCHES == {"gather_agg_fwd": 0,
                                           "gather_agg_bwd_dx": 1,
                                           "gather_agg_bwd_dw": 0}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def test_chaos_soak_on_the_card(cuda):
    """The five scenarios of `resilience.soak` on the tiny graph on the
    card: each fault fires, its recovery engages, and the run ends
    bit-identical to the fault-free sync run."""
    from repro_torch.resilience import soak

    g = prepare(synthetic.load("tiny"), oracle=True)
    for res in soak.run_all(g, device=cuda):
        assert res.fired >= 1 and res.ok, res.summary()
        assert res.meter[soak.EXPECT_METER[res.scenario]] >= 1


# ---------------------------------------------------------------------------
# the sync gate (repro_torch.analysis)
# ---------------------------------------------------------------------------
def _gate_trainer(tiny, **kw):
    from repro_torch.analysis import op_audit
    return op_audit.make_trainer(tiny, "cuda", **kw)


def test_planted_item_in_a_gated_train_step_raises(cuda):
    """A `.item()` inside the step is a sync the gate refuses; the same
    run without it passes, and the gate restores the debug mode."""
    from repro_torch.analysis.sync_gate import sync_gate
    tiny = prepare(synthetic.load("tiny"), oracle=True)
    tr = _gate_trainer(tiny)
    tr.train_steps(1)
    step = tr.train_step

    def planted(*a, **k):
        loss, ok = step(*a, **k)
        loss.item()
        return loss, ok
    tr.train_step = planted
    mode = torch.cuda.get_sync_debug_mode()
    with pytest.raises(RuntimeError, match="synchronizing"):
        with sync_gate():
            tr.train_steps(2)
    assert torch.cuda.get_sync_debug_mode() == mode
    tr.train_step = step
    with sync_gate():
        tr.train_steps(2)


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_gated_sage_steps_pass_with_the_promised_reads(cuda, tmp_path,
                                                       pipeline):
    """The real SAGE step with the dynamic cache, a guard read every 3
    steps and a checkpoint every 4 runs across an epoch boundary under
    the gate; the windows it opened are the docstring's, as
    `promised_reads` counts them, and the losses equal an ungated run's
    bit for bit."""
    from repro_torch.analysis.sync_gate import sync_gate
    from repro_torch.batching import Cursor
    from repro_torch.resilience.guard import GuardConfig
    tiny = prepare(synthetic.load("tiny"), oracle=True)
    losses = []
    for gated in (False, True):
        tr = _gate_trainer(tiny, ckpt_dir=str(tmp_path / f"ck{gated}"),
                           ckpt_every=4, pipeline=pipeline)
        tr.guard = GuardConfig(check_every=3)
        nb = tr.stream.num_batches()
        tr.stream.cursor = Cursor(0, nb - 4)
        promised = tr.promised_reads(8)
        assert promised == {"drain": 1, "guard": 4, "refill": 1,
                            "integrity": 1, "checkpoint": 2}
        try:
            if gated:
                with sync_gate() as gate:
                    losses.append(tr.train_steps(8))
                assert gate.counts() == promised
            else:
                losses.append(tr.train_steps(8))
        finally:
            if pipeline == "async":
                tr.stream.close()
    assert losses[0] == losses[1]
