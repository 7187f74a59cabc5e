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

from repro.kernels.gather_agg.ops import gather_agg as gather_agg_j
from repro_torch.kernels.gather_agg import kernel, ref
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
