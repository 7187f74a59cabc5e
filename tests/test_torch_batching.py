"""Batching parity: epoch orders, calibrated caps and every `MiniBatch`
field equal the reference's exactly.

The reference draws its sampling uniforms from threefry keys inside the
jitted builder; the port takes them from `draw`. These tests hand the
port the very uniforms the reference drew (its key schedule rebuilt here:
`split(batch_key, L)`, then `split(k_h, 3)`, then `uniform(k1)` /
`uniform(k2)`), so the batches must agree element for element. The
helpers below are shared with the model and trainer parity tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.batching import BatchStream as BatchStreamJ
from repro.batching import make_policy as make_policy_j
from repro.core import minibatch as mb_j
from repro.graphs.csr import DeviceGraph as DeviceGraphJ
from repro_torch.batching import BatchStream, Cursor, make_policy
from repro_torch.core import minibatch as mb
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic
from repro_torch.graphs.csr import DeviceGraph

B, FANOUTS = 256, (5, 5)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def jax_uniforms(key, fanouts, caps, batch_size):
    """The (u_class, u_off) pair per hop that the reference's biased
    sampler draws for batch key `key` (`minibatch.py:111`,
    `sampling/device.py:69-79`), as numpy."""
    keys = jax.random.split(key, len(fanouts))
    out, M = [], batch_size
    for h, r in enumerate(fanouts):
        k1, k2, _ = jax.random.split(keys[h], 3)
        out.append((np.asarray(jax.random.uniform(k1, (M, r))),
                    np.asarray(jax.random.uniform(k2, (M, r)))))
        M = caps[h]
    return out


def injected(uniforms, device="cpu"):
    """A `draw` for the port's builder that returns the given uniforms."""
    def draw(hop, M, fanout):
        uc, uo = uniforms[hop]
        assert uc.shape == (M, fanout)
        return (torch.as_tensor(np.array(uc)).to(device),
                torch.as_tensor(np.array(uo)).to(device))
    return draw


def torch_batch(jb, device="cpu"):
    """A reference `MiniBatch` -> the port's, same values."""
    def t(a):
        return torch.as_tensor(np.array(a)).to(device)
    return mb.MiniBatch(
        levels=[t(lv) for lv in jb.levels], node_mask=t(jb.node_mask),
        blocks=[mb.Block(t(b.src_pos), t(b.self_pos), t(b.edge_mask),
                         t(b.dst_mask)) for b in jb.blocks],
        labels=t(jb.labels), label_mask=t(jb.label_mask))


def assert_batches_equal(tb, jb):
    def eq(a, b, what):
        a, b = a.cpu().numpy(), np.asarray(b)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    assert len(tb.levels) == len(jb.levels)
    for i, (a, b) in enumerate(zip(tb.levels, jb.levels)):
        eq(a, b, f"levels[{i}]")
    for i, (a, b) in enumerate(zip(tb.blocks, jb.blocks)):
        for f in ("src_pos", "self_pos", "edge_mask", "dst_mask"):
            eq(getattr(a, f), getattr(b, f), f"blocks[{i}].{f}")
    for f in ("node_mask", "labels", "label_mask"):
        eq(getattr(tb, f), getattr(jb, f), f)


@pytest.fixture(scope="module")
def tiny_t():
    return prepare(synthetic.load("tiny"), oracle=True)


@pytest.fixture(scope="module")
def dev_graphs(tiny_graph, tiny_t):
    return (DeviceGraphJ.from_graph(tiny_graph),
            DeviceGraph.from_graph(tiny_t, device="cpu"))


# ---------------------------------------------------------------------------
# orders and caps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["rand", "norand", "comm_rand"])
def test_epoch_orders_equal(tiny_graph, tiny_t, dev_graphs, policy):
    gj, gt = dev_graphs
    sj = BatchStreamJ(tiny_graph, make_policy_j(policy), B, FANOUTS,
                      (768, 1024), seed=3, device_graph=gj)
    st = BatchStream(tiny_t, make_policy(policy), B, FANOUTS, (768, 1024),
                     seed=3, device_graph=gt, device="cpu")
    for epoch in range(3):
        np.testing.assert_array_equal(st.root_batches(epoch),
                                      sj.root_batches(epoch))
    assert st.num_batches() == sj.num_batches()


@pytest.mark.parametrize("policy", ["rand", "comm_rand"])
def test_calibrate_caps_equal(tiny_graph, tiny_t, policy):
    got = mb.calibrate_caps(tiny_t, make_policy(policy), B, FANOUTS, seed=1)
    want = mb_j.calibrate_caps(tiny_graph, make_policy_j(policy), B,
                               FANOUTS, seed=1)
    assert got == want


# ---------------------------------------------------------------------------
# batches, given the reference's uniforms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p,caps,n_roots", [
    (0.5, (768, 1152), B),           # ample caps, full batch
    (1.0, (768, 1152), 200),         # intra-only draw, padded roots
    (0.5, (384, 512), B),            # unique count exceeds cap: truncation
])
def test_minibatch_fields_equal(tiny_graph, dev_graphs, p, caps, n_roots):
    gj, gt = dev_graphs
    roots = np.full(B, -1, np.int64)
    roots[:n_roots] = tiny_graph.train_ids[5:5 + n_roots][::-1]
    key = jax.random.key(7)
    jb = mb_j.build_batch(key, gj, jnp.asarray(roots, jnp.int32),
                          jnp.asarray(tiny_graph.labels), FANOUTS, caps, p)
    if caps[0] == 384:   # the truncating case really truncates
        assert int(jb.node_mask.sum()) == caps[-1]
    tb = mb.build_batch(gt, torch.as_tensor(roots, dtype=torch.int32),
                        torch.as_tensor(tiny_graph.labels), FANOUTS, caps,
                        p, draw=injected(jax_uniforms(key, FANOUTS, caps,
                                                      B)))
    assert_batches_equal(tb, jb)


def test_isolated_last_node_samples_itself(tiny_graph):
    """Louvain's order puts tiny's one isolated node last in the CSR, so
    its row starts at E: the port's gather must clamp there as JAX's does
    (it raised IndexError), and the batch must equal the reference's."""
    g = prepare(synthetic.load("tiny"), oracle=False)
    last = g.num_nodes - 1
    assert g.indptr[last] == g.indptr[-1] == g.num_edges
    roots = np.full(B, -1, np.int64)
    roots[:4] = [last, 0, last - 1, 5]
    caps, key = (768, 1152), jax.random.key(3)
    jb = mb_j.build_batch(key, DeviceGraphJ.from_graph(g),
                          jnp.asarray(roots, jnp.int32),
                          jnp.asarray(g.labels), FANOUTS, caps, 0.5)
    tb = mb.build_batch(DeviceGraph.from_graph(g, device="cpu"),
                        torch.as_tensor(roots, dtype=torch.int32),
                        torch.as_tensor(g.labels), FANOUTS, caps, 0.5,
                        draw=injected(jax_uniforms(key, FANOUTS, caps, B)))
    assert_batches_equal(tb, jb)


def test_unique_capped_matches_jnp_unique():
    rng = np.random.default_rng((0, 2))
    for cap in (3, 10, 40):
        ids = rng.integers(0, 25, 30).astype(np.int32)
        want = np.asarray(jnp.unique(jnp.asarray(ids), size=cap,
                                     fill_value=25))
        got = mb._unique_capped(torch.as_tensor(ids), cap, 25).numpy()
        np.testing.assert_array_equal(got, want)


def test_batch_rebuilt_at_same_cursor_is_identical(tiny_t, dev_graphs):
    _, gt = dev_graphs
    s1 = BatchStream(tiny_t, "comm_rand", B, FANOUTS, (768, 1152), seed=4,
                     device_graph=gt, device="cpu")
    first = [next(iter(s1)) for _ in range(3)]
    s2 = BatchStream(tiny_t, "comm_rand", B, FANOUTS, (768, 1152), seed=4,
                     device_graph=gt, device="cpu", cursor=Cursor(0, 2))
    again = next(iter(s2))
    for a, b in zip(again.levels + [again.labels, again.label_mask],
                    first[2].levels + [first[2].labels,
                                       first[2].label_mask]):
        assert torch.equal(a, b)
    for ba, bb in zip(again.blocks, first[2].blocks):
        for f in ("src_pos", "self_pos", "edge_mask", "dst_mask"):
            assert torch.equal(getattr(ba, f), getattr(bb, f))
    # a different cursor draws differently
    assert not torch.equal(first[1].levels[-1], first[2].levels[-1])


@pytest.mark.parametrize("policy", ["rand", "norand", "comm_rand"])
def test_self_positions_are_non_decreasing(tiny_t, dev_graphs, policy):
    """The self rows' backward takes the sort-free path, whose promise is
    a non-decreasing index: every block's `self_pos` (a sorted level mapped
    into its sorted superset), and layer 0's composed `gid[self_pos]`
    (node ids are sorted), on every batch of an epoch and on batches with
    padded roots (all on the last slot), truncating caps included."""
    _, gt = dev_graphs
    N = tiny_t.num_nodes
    for caps in ((768, 1152), (384, 512)):
        st = BatchStream(tiny_t, make_policy(policy), B, FANOUTS, caps,
                         seed=5, device_graph=gt, device="cpu")
        roots = list(st.root_batches(0))
        padded = np.full(B, -1, np.int64)
        padded[:100] = roots[0][:100]
        roots.append(padded)
        assert any((r < 0).any() for r in roots)
        for pos, r in enumerate(roots):
            batch = st.build(r, 0, pos)
            gid = torch.clamp(batch.node_ids, max=N - 1)
            for i, block in enumerate(batch.blocks):
                idx = gid[block.self_pos] if i == 0 else block.self_pos
                for name, t in (("self_pos", block.self_pos),
                                ("self index", idx)):
                    assert bool((t[1:] >= t[:-1]).all()), \
                        (policy, caps, pos, i, name)
