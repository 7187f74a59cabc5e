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

from repro.kernels.gather_agg.kernel import (gather_agg_bwd_dw_pallas,
                                             gather_agg_fwd_pallas)
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


def _ordered(x, idx, w):
    return ref.gather_agg_ref_ordered(torch.as_tensor(x),
                                      torch.as_tensor(idx),
                                      torch.as_tensor(w))


@pytest.mark.parametrize("case", CASES)
def test_ordered_plain_version_matches_the_plain_version(case):
    """`gather_agg_ref_ordered`, the forward kernel's own order (the CUDA
    kernel equals it bit for bit on the card), against `gather_agg_ref`,
    the CPU main path: rtol = atol = 1e-6 (r float32 products summed in
    another order)."""
    x, idx, w = _case(case)
    got = _ordered(x, idx, w)
    want = ref.gather_agg_ref(torch.as_tensor(x), torch.as_tensor(idx),
                              torch.as_tensor(w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_ordered_plain_version_adds_edge_by_edge(case):
    """Bit for bit the float32 loop acc = acc + w[:, j] * x[idx[:, j]] from
    zeros, each product rounded before its add (no fused multiply-add)."""
    x, idx, w = _case(case)
    rows = np.clip(idx, 0, x.shape[0] - 1)
    acc = np.zeros((idx.shape[0], x.shape[1]), np.float32)
    for j in range(idx.shape[1]):
        acc = acc + (w[:, j, None] * x[rows[:, j]]).astype(np.float32)
    np.testing.assert_array_equal(_ordered(x, idx, w).numpy(), acc)


@pytest.mark.parametrize("case", CASES)
def test_ordered_plain_version_matches_pallas_interpret(case):
    """`gather_agg_ref_ordered` against the reference's
    `gather_agg_fwd_pallas` in interpret mode: rtol = atol = 1e-6. The two
    add in the same order but are not bit-equal: on the CPU the interpret
    run rounds each step as a fused multiply-add (it matched an FMA
    emulation on every element at F 33, 64 and 602, and differed in the
    last bits from multiply-then-add on about half of them)."""
    x, idx, w = _case(case)
    idx = np.clip(idx, 0, x.shape[0] - 1)
    want = np.asarray(gather_agg_fwd_pallas(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(_ordered(x, idx, w).numpy(), want,
                               rtol=1e-6, atol=1e-6)


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


def _emulate_bwd_dx(g, keys, order, row_ptr, w, n, r, H, chunk):
    """The CUDA backward's three launches (`csrc/gather_agg.cu`), written
    out at window width `chunk`: every run of at most `chunk` edges is
    summed from 0 in sorted order into its row (empty rows as zeros);
    longer runs are cut at the multiples of `chunk` of the sorted edges
    into pieces with two static slots per window, then summed in window
    order, `chunk` pieces per group, and the groups in order. Without
    `row_ptr` a row finds its run by binary search in `keys`, without
    `order` the sorted position is the edge id. Rows no launch writes stay
    NaN."""
    keys = np.asarray(keys)
    E, F = keys.size, g.shape[1]
    wf = None if w is None else np.asarray(w, np.float32).reshape(-1)

    def run(s):
        if row_ptr is not None:
            return int(row_ptr[s]), int(row_ptr[s + 1])
        return (int(np.searchsorted(keys, s, "left")),
                int(np.searchsorted(keys, s, "right")))

    def sum_edges(a, b, h):
        acc = np.zeros(F, np.float32)
        for e in range(a, b):
            f = int(e if order is None else order[e])
            i = f // r
            d = i * H + h
            wt = np.float32(1.0) if wf is None else wf[d * r + f - i * r]
            acc = acc + wt * g[d]
        return acc

    n_win = -(-E // chunk)
    dx = np.full((n * H, F), np.nan, np.float32)
    part = np.full((2 * n_win * H, F), np.nan, np.float32)

    def piece(q):
        h, ts = q % H, q // H
        t = ts >> 1
        p0, p1 = t * chunk, min(t * chunk + chunk, E)
        s = keys[p0]
        if ts & 1:
            if keys[p1 - 1] == s:
                return None
            s = keys[p1 - 1]
        a, b = run(s)
        return (int(s), a, b, t, h) if b - a > chunk else None

    def slot(a, u, h):
        return (2 * u + (1 if a > u * chunk else 0)) * H + h

    def sum_slots(slots):
        acc = np.zeros(F, np.float32)
        for k in slots:
            acc = acc + part[k]
        return acc

    tasks = range(2 * n_win * H)
    for q in tasks:                          # launch 1: pieces ...
        P = piece(q)
        if P is not None:
            s, a, b, t, h = P
            part[q] = sum_edges(max(a, t * chunk), min(b, t * chunk + chunk),
                                h)
    for s_out in range(n * H):               # ... and rows
        a, b = run(s_out // H)
        if b - a <= chunk:
            dx[s_out] = sum_edges(a, b, s_out % H)
    for level in (1, 2):                     # launches 2 and 3
        for q in tasks:
            P = piece(q)
            if P is None:
                continue
            s, a, b, t, h = P
            t0 = a // chunk
            nw = (b - 1) // chunk - t0 + 1
            if level == 1 and (t - t0) % chunk == 0:
                acc = sum_slots(slot(a, u, h)
                                for u in range(t, min(t + chunk, t0 + nw)))
                if nw <= chunk:
                    dx[s * H + h] = acc
                else:
                    part[q] = acc
            elif level == 2 and t == t0 and nw > chunk:
                dx[s * H + h] = sum_slots(
                    slot(a, t0 + k * chunk, h)
                    for k in range(-(-nw // chunk)))
    return dx


def _run_lengths(idx, n):
    return np.bincount(np.asarray(idx).reshape(-1), minlength=n)


@pytest.mark.parametrize("chunk", [4, 64])
@pytest.mark.parametrize("case", ["repeated", "masked_rows", "odd_f10"])
def test_backward_plan_feeds_the_kernel_loops(case, chunk):
    """The index-only plan the CUDA backward consumes, built on the CPU:
    the keys in stable by-source order, the edge id of each position and
    each row's run offsets; the kernel's launches over it (at window
    width `chunk`) equal the reference's scatter-add, and rows of at most
    `chunk` edges equal the CPU plain version bit for bit."""
    x, idx, w = _case(case)
    n_src = x.shape[0]
    idx = np.clip(idx, 0, n_src - 1)
    g = np.random.default_rng((3, 11)).normal(
        size=(idx.shape[0], x.shape[1])).astype(np.float32)
    plan = kernel.bwd_dx_plan(torch.as_tensor(idx), n_src)
    order = np.argsort(idx.reshape(-1), kind="stable")
    np.testing.assert_array_equal(plan.order.numpy(), order)
    np.testing.assert_array_equal(plan.keys.numpy(), idx.reshape(-1)[order])
    count = _run_lengths(idx, n_src)
    np.testing.assert_array_equal(plan.row_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(count)]))
    assert plan.n_src == n_src and plan.r == idx.shape[1]
    assert plan.heads == 1 and plan.folded(4).heads == 4
    if chunk == 4 and case == "repeated":
        assert count.max() > 4 * chunk       # both combine levels run
    got = _emulate_bwd_dx(g, plan.keys.numpy(), plan.order.numpy(),
                          plan.row_ptr.numpy(), w, n_src, idx.shape[1], 1,
                          chunk)
    want = np.asarray(jax.vjp(
        lambda a: gather_agg_j(a, jnp.asarray(idx), jnp.asarray(w),
                               impl="pallas"), jnp.asarray(x))[1](
        jnp.asarray(g))[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    plain = ref.gather_agg_bwd_dx_ref(torch.as_tensor(idx),
                                      torch.as_tensor(w), torch.as_tensor(g),
                                      n_src).numpy()
    short = count <= chunk
    np.testing.assert_array_equal(got[short], plain[short])


def _gat_index(seed, n_src, n_dst, r, H):
    """src_pos-like (n_dst, r) positions (a padding row on the last slot)
    and GAT's head-folded index idx2 = src * H + h, (n_dst * H, r)."""
    rng = np.random.default_rng((seed, 31))
    src = rng.integers(0, n_src, (n_dst, r)).astype(np.int32)
    src[n_dst // 2:] = n_src - 1
    heads = np.arange(H, dtype=np.int32)
    idx2 = (src[:, None, :] * H + heads[None, :, None]).reshape(n_dst * H, r)
    return src, idx2


@pytest.mark.parametrize("H", [1, 4])
def test_folded_plan_is_a_stable_argsort_of_the_folded_index(H):
    """GAT's head-folded aggregate reuses the plan of src_pos: row s*H + h
    walks s's run with destination i*H + h and weight (i*H + h, j). That
    is, edge for edge, the order a stable argsort of idx2 gives, and the
    launches over the folded plan equal the reference's gradient."""
    n_src, n_dst, r = 9, 20, 5
    src, idx2 = _gat_index(0, n_src, n_dst, r, H)
    plan = kernel.bwd_dx_plan(torch.as_tensor(src), n_src).folded(H)
    keys, order, row_ptr = (plan.keys.numpy(), plan.order.numpy(),
                            plan.row_ptr.numpy())
    order2 = np.argsort(idx2.reshape(-1), kind="stable")
    keys2 = idx2.reshape(-1)[order2]
    for s in range(n_src):
        for h in range(H):
            f = order[row_ptr[s]:row_ptr[s + 1]]
            i, j = f // r, f % r
            got = (i * H + h) * r + j        # the flat edge of idx2 walked
            np.testing.assert_array_equal(got, order2[keys2 == s * H + h])
    rng = np.random.default_rng((1, 31))
    dh = 3
    zf = rng.normal(size=(n_src * H, dh)).astype(np.float32)
    w2 = rng.random((n_dst * H, r)).astype(np.float32)
    g = rng.normal(size=(n_dst * H, dh)).astype(np.float32)
    got = _emulate_bwd_dx(g, keys, order, row_ptr, w2, n_src, r, H, 4)
    want = np.asarray(jax.vjp(
        lambda a: gather_agg_j(a, jnp.asarray(idx2), jnp.asarray(w2),
                               impl="jnp"), jnp.asarray(zf))[1](
        jnp.asarray(g))[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_e_src_plan_is_the_src_pos_plan():
    """GAT's e_src = s_src[src_pos] flattens src_pos to (M, 1): a plan of
    the flat index is the plan of src_pos, position for position, so the
    layer's one plan serves e_src's backward (fanout 1, unit weights),
    which then equals jax's gradient of the reference's gather."""
    n_src, n_dst, r, H = 11, 30, 4, 4
    src, _ = _gat_index(2, n_src, n_dst, r, H)
    plan = kernel.bwd_dx_plan(torch.as_tensor(src), n_src)
    flat = kernel.bwd_dx_plan(torch.as_tensor(src.reshape(-1, 1)), n_src)
    for f in ("keys", "order", "row_ptr"):
        assert torch.equal(getattr(plan, f), getattr(flat, f)), f
    rng = np.random.default_rng((3, 31))
    s_src = rng.normal(size=(n_src, H)).astype(np.float32)
    g = rng.normal(size=(n_dst, r, H)).astype(np.float32)
    got = _emulate_bwd_dx(g.reshape(-1, H), plan.keys.numpy(),
                          plan.order.numpy(), plan.row_ptr.numpy(), None,
                          n_src, 1, 1, 4)
    want = np.asarray(jax.vjp(lambda a: a[jnp.asarray(src)],
                              jnp.asarray(s_src))[1](jnp.asarray(g))[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("chunk", [4, 64])
def test_sorted_path_runs_match_reference_vjp(chunk, impl):
    """The self rows' path: a non-decreasing index (rows empty, single,
    repeated, and the padding slot's long run at the end), no plan, each
    run found by binary search in the index itself. Its launches equal
    jax.vjp of the reference's `gather_agg` at fanout 1 with unit weights,
    and the CPU plain version bit for bit on rows of at most `chunk`."""
    rng = np.random.default_rng((5, 31))
    n_src, F = 40, 6
    idx = np.sort(rng.integers(0, n_src - 1, 70)).astype(np.int32)
    idx = np.concatenate([idx, np.full(150, n_src - 1, np.int32)])
    x = rng.normal(size=(n_src, F)).astype(np.float32)
    g = rng.normal(size=(idx.size, F)).astype(np.float32)
    got = _emulate_bwd_dx(g, idx, None, None, None, n_src, 1, 1, chunk)
    ones = jnp.ones((idx.size, 1), jnp.float32)
    want = np.asarray(jax.vjp(
        lambda a: gather_agg_j(a, jnp.asarray(idx[:, None]), ones,
                               impl=impl), jnp.asarray(x))[1](
        jnp.asarray(g))[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    plain = kernel.gather_agg_bwd_dx_sorted(
        torch.as_tensor(idx[:, None]), None, torch.as_tensor(g),
        n_src).numpy()
    short = _run_lengths(idx, n_src) <= chunk
    np.testing.assert_array_equal(got[short], plain[short])


def test_sorted_rows_refuse_an_unsorted_index_on_the_cpu():
    """The sorted path's promise is checked where it is used: the
    backward of `gather_sorted_rows` over an unsorted index raises (on
    the card the kernel traps); its forward is `x[idx]` either way."""
    x = torch.randn(6, 3, requires_grad=True)
    idx = torch.tensor([0, 2, 1, 5], dtype=torch.int32)
    out = ops.gather_sorted_rows(x, idx)
    assert torch.equal(out, x.detach()[idx.long()])
    with pytest.raises(ValueError, match="non-decreasing"):
        out.sum().backward()
    (dx,) = torch.autograd.grad(ops.gather_sorted_rows(x, idx.sort()[0])
                                .sum(), x)
    want = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 1.0])[:, None].expand(6, 3)
    assert torch.equal(dx, want)


def test_cpu_index_builds_no_plan():
    """The CPU path keeps the plain versions: a `DxPlan` of a CPU index
    builds nothing, folded or not."""
    plan = ops.DxPlan(torch.zeros((3, 2), dtype=torch.int32), 4)
    assert plan.get() is None and plan.folded(4).get() is None
    assert plan._built == [None]


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
