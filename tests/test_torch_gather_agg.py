"""The gather-aggregate op against the reference: the plain PyTorch path
(what the CPU runs, and what `chip_smoke.py` holds the CUDA kernels
against) matches `gather_agg` with the Pallas kernels in interpret mode and
with the jnp reference, forward and backward.

Forward tolerance rtol = atol = 1e-6: both sides sum r float32 products,
possibly in another order. Gradients rtol = 1e-5, atol = 1e-6: dx sums up
to n_dst * r products per row."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_agg.kernel import gather_agg_bwd_dw_pallas
from repro.kernels.gather_agg.ops import gather_agg as gather_agg_j
from repro.kernels.gather_agg.ref import gather_agg_ref as gather_agg_ref_j
from repro_torch.kernels.gather_agg import kernel, ops, ref
from repro_torch.kernels.gather_agg.ops import gather_agg

IMPLS = ["pallas", "jnp"]


def _case(name, seed=0):
    """(x, idx, w) numpy inputs for a named edge case."""
    rng = np.random.default_rng((seed, 11))
    n, d, r, f = {"repeated": (7, 12, 5, 8), "out_of_range": (20, 9, 4, 16),
                  "masked_rows": (30, 10, 6, 10), "odd_f6": (25, 8, 3, 6),
                  "odd_f10": (40, 17, 10, 10),
                  "reddit_f602": (50, 6, 10, 602)}[name]
    x = rng.normal(size=(n, f)).astype(np.float32)
    idx = rng.integers(0, n, (d, r)).astype(np.int32)
    w = rng.random((d, r)).astype(np.float32)
    if name == "repeated":
        idx[:, :3] = 2                       # many edges on one source row
        idx[4] = 5
    elif name == "out_of_range":
        idx[0, 0], idx[1, 1], idx[2] = -3, n + 4, n  # clipped into range
    elif name == "masked_rows":
        w[2] = 0.0
        w[5] = 0.0                           # all-masked destination rows
        w[7, ::2] = 0.0
    return x, idx, w


CASES = ["repeated", "out_of_range", "masked_rows", "odd_f6", "odd_f10",
         "reddit_f602"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_reference(case, impl):
    x, idx, w = _case(case)
    want = np.asarray(gather_agg_j(jnp.asarray(x), jnp.asarray(idx),
                                   jnp.asarray(w), impl=impl))
    got = gather_agg(torch.as_tensor(x), torch.as_tensor(idx),
                     torch.as_tensor(w)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_grads_match_reference_vjp(case, impl):
    x, idx, w = _case(case, seed=1)
    cot = np.random.default_rng((2, 11)).normal(
        size=(idx.shape[0], x.shape[1])).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: gather_agg_j(a, jnp.asarray(idx), b,
                                               impl=impl),
                     jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(cot))
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    gather_agg(xt, torch.as_tensor(idx), wt).backward(torch.as_tensor(cot))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("case", CASES)
def test_bwd_dw_matches_reference(case, impl):
    """The dw wrapper on CPU tensors (the plain version the CUDA kernel is
    held against) equals the reference's `gather_agg_bwd_dw_pallas` in
    interpret mode, and the weight gradient of its jnp reference. Each
    entry is one F-term dot product: rtol = 1e-5, atol = 1e-6."""
    x, idx, w = _case(case, seed=2)
    idx = np.clip(idx, 0, x.shape[0] - 1)
    g = np.random.default_rng((4, 11)).normal(
        size=(idx.shape[0], x.shape[1])).astype(np.float32)
    if impl == "pallas":
        want = gather_agg_bwd_dw_pallas(jnp.asarray(x), jnp.asarray(idx),
                                        jnp.asarray(g), interpret=True)
    else:
        want = jax.vjp(lambda b: gather_agg_ref_j(jnp.asarray(x),
                                                  jnp.asarray(idx), b),
                       jnp.asarray(w))[1](jnp.asarray(g))[0]
    got = kernel.gather_agg_bwd_dw(torch.as_tensor(x), torch.as_tensor(idx),
                                   torch.as_tensor(g)).numpy()
    assert got.dtype == np.float32 and got.shape == idx.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w_grad", [False, True])
def test_dw_computed_only_when_weights_need_grad(w_grad, monkeypatch):
    """SAGE's and GCN's weights carry no gradient, so their backward never
    reaches the dw wrapper; GAT's attention weights do."""
    calls = []

    def counted(*a):
        calls.append(1)
        return kernel.gather_agg_bwd_dw(*a)

    monkeypatch.setattr(ops, "gather_agg_bwd_dw", counted)
    x, idx, w = _case("odd_f10")
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(w_grad)
    gather_agg(xt, torch.as_tensor(idx), wt).sum().backward()
    assert xt.grad is not None
    assert len(calls) == int(w_grad) and (wt.grad is not None) == w_grad


def test_dx_skipped_when_table_needs_no_grad():
    """Layer 0's table is the global feature matrix: no dx is computed."""
    x, idx, w = _case("odd_f10")
    wt = torch.as_tensor(w).requires_grad_(True)
    xt = torch.as_tensor(x)
    gather_agg(xt, torch.as_tensor(idx), wt).sum().backward()
    assert xt.grad is None and wt.grad is not None


def test_nan_in_cotangent_propagates_through_masked_edges():
    """A zero-weight edge still carries 0 * NaN = NaN into dx, as in the
    reference's scatter-add."""
    x, idx, w = _case("masked_rows")
    cot = np.ones((idx.shape[0], x.shape[1]), np.float32)
    cot[2, 0] = np.nan                       # row 2 is all-masked
    dx_j = np.asarray(jax.vjp(
        lambda a: gather_agg_j(a, jnp.asarray(idx), jnp.asarray(w),
                               impl="pallas"), jnp.asarray(x))[1](
        jnp.asarray(cot))[0])
    dx = ref.gather_agg_bwd_dx_ref(torch.as_tensor(idx), torch.as_tensor(w),
                                   torch.as_tensor(cot), x.shape[0]).numpy()
    np.testing.assert_array_equal(np.isnan(dx), np.isnan(dx_j))
    assert np.isnan(dx).any()


def _bwd_dx_kernel_loops(g, plan, n_src):
    """The CUDA backward's two loops, written out: each chunk of a row's
    sorted edges is summed in order; a one-chunk row is the result, a
    longer row sums its chunk partials in chunk order."""
    p = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in vars(plan).items()}
    dx = np.zeros((n_src, g.shape[1]), np.float32)
    for s in range(n_src):
        a, b = p["row_start"][s], p["row_end"][s]
        starts = list(range(a, b, p["chunk"])) or [a]
        parts = []
        for c0 in starts:
            acc = np.zeros(g.shape[1], np.float32)
            for e in range(c0, min(c0 + p["chunk"], b)):
                acc = acc + np.float32(p["w_sorted"][e]) * \
                    g[p["dst_sorted"][e]]
            parts.append(acc)
        if len(parts) == 1:
            dx[s] = parts[0]
            continue
        acc = np.zeros(g.shape[1], np.float32)
        for part in parts:
            acc = acc + part
        dx[s] = acc
    return dx


@pytest.mark.parametrize("chunk", [4, 64])
@pytest.mark.parametrize("case", ["repeated", "masked_rows", "odd_f10"])
def test_backward_plan_feeds_the_kernel_loops(case, chunk):
    """The sort/searchsorted/chunk glue the CUDA backward consumes, run on
    the CPU: stable by-source order, chunk and scratch offsets within their
    static bounds, and the kernel's loops over them equal the reference's
    scatter-add."""
    x, idx, w = _case(case)
    n_src = x.shape[0]
    idx = np.clip(idx, 0, n_src - 1)
    g = np.random.default_rng((3, 11)).normal(
        size=(idx.shape[0], x.shape[1])).astype(np.float32)
    plan = kernel.bwd_dx_plan(torch.as_tensor(idx), torch.as_tensor(w),
                              n_src, chunk=chunk)
    order = np.argsort(idx.reshape(-1), kind="stable")
    np.testing.assert_array_equal(plan.dst_sorted.numpy(),
                                  order // idx.shape[1])
    np.testing.assert_array_equal(plan.w_sorted.numpy(),
                                  w.reshape(-1)[order])
    count = np.bincount(idx.reshape(-1), minlength=n_src)
    np.testing.assert_array_equal(
        (plan.row_end - plan.row_start).numpy(), count)
    nch = np.maximum(1, -(-count // chunk))
    np.testing.assert_array_equal(plan.chunk_first.numpy(),
                                  np.cumsum(nch) - nch)
    assert nch.sum() <= plan.n_chunks_max
    assert nch[nch > 1].sum() <= plan.n_partial_max
    if chunk == 4 and case == "repeated":
        assert (nch > 1).any()               # the two-level path is covered
    got = _bwd_dx_kernel_loops(g, plan, n_src)
    want = np.asarray(jax.vjp(
        lambda a: gather_agg_j(a, jnp.asarray(idx), jnp.asarray(w),
                               impl="pallas"), jnp.asarray(x))[1](
        jnp.asarray(g))[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# gather_rows: x[idx] with the deterministic fanout-1 backward
# ---------------------------------------------------------------------------
# (n_src, idx shape, trailing shape of x): SAGE's / GCN's self gather
# (n_dst,) of (n_src, F), GAT's z_self (n_dst,) of (n_src, H, dh) and
# e_src (n_dst, r) of (n_src, H)
ROW_CASES = [(30, (50,), (16,)), (12, (40,), (4, 5)), (9, (20, 6), (4,)),
             (1, (7,), (3,))]


def _rows_case(n_src, idx_shape, tail, seed):
    """Random rows and indices, half of them pointing at the last row (the
    padding slot every masked position of a batch names), one below and
    one past the range (clipped)."""
    rng = np.random.default_rng((seed, 23))
    x = rng.normal(size=(n_src, *tail)).astype(np.float32)
    idx = rng.integers(0, n_src, idx_shape).astype(np.int32)
    flat = idx.reshape(-1)
    flat[: flat.size // 2] = n_src - 1
    flat[-1], flat[-2] = -2, n_src + 3
    g = rng.normal(size=(*idx_shape, *tail)).astype(np.float32)
    return x, idx, g


@pytest.mark.parametrize("case", ROW_CASES)
def test_gather_rows_matches_index_select_autograd(case):
    """Forward bit-equal to `index_select`; the gradient equal to its
    autograd within rtol 1e-5 (sums over repeated rows in another order)."""
    x, idx, g = _rows_case(*case, seed=0)
    n_src = x.shape[0]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ops.gather_rows(xt, torch.from_numpy(idx))
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    xr = torch.from_numpy(x).requires_grad_(True)
    clipped = torch.from_numpy(np.clip(idx, 0, n_src - 1)).long()
    want = torch.index_select(xr.reshape(n_src, -1), 0,
                              clipped.reshape(-1)).reshape(out.shape)
    (want_dx,) = torch.autograd.grad(want, xr, torch.from_numpy(g))
    assert out.shape == idx.shape + x.shape[1:]
    assert torch.equal(out.detach(), want.detach())
    torch.testing.assert_close(dx, want_dx, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ROW_CASES)
def test_gather_rows_grad_matches_jax(case):
    """The same numpy inputs through `jax.grad` of `x[idx]` (the
    reference's jnp gather, `repro/models/gnn/models.py`): forward equal,
    dx within rtol 1e-5."""
    x, idx, g = _rows_case(*case, seed=1)
    clipped = np.clip(idx, 0, x.shape[0] - 1)
    want, vjp = jax.vjp(lambda a: a[jnp.asarray(clipped)], jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ops.gather_rows(xt, torch.from_numpy(idx))
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-5,
                               atol=1e-6)


def test_gather_rows_needs_no_backward_for_a_constant_table():
    """A table without gradient (layer 0's feature matrix) gives an output
    without gradient: no backward, no launch."""
    x, idx, _ = _rows_case(*ROW_CASES[0], seed=2)
    out = ops.gather_rows(torch.from_numpy(x), torch.from_numpy(idx))
    assert not out.requires_grad
