"""The prior-work policies and samplers (paper §6.3) held against the JAX
reference on the CPU, at the tiny graph's size:

- `uniform`, `full` and `labor` `sample`: equal to the reference's element
  for element, for the reference's uniforms (uniform) or epoch key words
  (labor), at fanouts below and above the degree, with an isolated last
  node and padded rows; LABOR's picks with forced tied ranks (the lower
  slot first, as `jax.lax.top_k`); `_hash_rank01` and `epoch_ranks_np`
  bit-equal.
- the `clustergcn` and `labor` policies: epoch orders, member groups,
  root batches, calibrated caps, device orders and presampled cache plans
  equal; whole `MiniBatch`es equal for the same words or uniforms.
- LABOR's sync and async batches, and the trainers' losses, bit-equal.
- `gather_mean` against `repro.kernels.gather_mean` with `use_kernel`
  False and True (the Pallas op in interpret mode) within rtol 1e-5 /
  atol 1e-6, gradient too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import featcache as featcache_j
from repro import sampling as sampling_j
from repro.batching import BatchStream as BatchStreamJ
from repro.batching import make_policy as make_policy_j
from repro.batching.policy import root_batches as root_batches_j
from repro.core import minibatch as mb_j
from repro.graphs.csr import DeviceGraph as DeviceGraphJ
from repro.kernels.gather_mean.ops import gather_mean as gather_mean_j
from repro.sampling.device import _hash_rank01 as hash_rank01_j
from repro_torch import featcache, sampling
from repro_torch.batching import (BatchStream, CapsCalibrator,
                                  available_policies, make_policy,
                                  root_batches)
from repro_torch.batching.stream import shared_words
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core import minibatch as mb
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic
from repro_torch.graphs.csr import DeviceGraph
from repro_torch.kernels.gather_agg import kernel as agg_kernel
from repro_torch.kernels.gather_mean.ops import gather_mean
from repro_torch.kernels.gather_mean.ref import gather_mean_ref
from repro_torch.pipeline import (AsyncBatchStream, DeviceBatchBuilder,
                                  order_bitmatch)
from repro_torch.pipeline.prefetch import batch_tensors
from repro_torch.sampling.device import _hash_rank01, _k_lowest
from repro_torch.train.gnn_loop import GNNTrainer
from test_torch_batching import assert_batches_equal

B, FANOUTS = 256, (5, 5)
CPU = "cpu"
SALT_NODES, SALT_TIES, SALT_MEAN = 21, 22, 23


@pytest.fixture(scope="module")
def tiny_t():
    return prepare(synthetic.load("tiny"), oracle=True)


@pytest.fixture(scope="module")
def iso():
    """tiny under Louvain, whose order puts its isolated node last in the
    CSR (its row starts at E): (numpy graph, reference device graph, the
    port's)."""
    g = prepare(synthetic.load("tiny"), oracle=False)
    assert g.indptr[-2] == g.indptr[-1] == g.num_edges
    return g, DeviceGraphJ.from_graph(g), DeviceGraph.from_graph(g, CPU)


def _nodes(g, M=40):
    """M node ids: random ones, the isolated last node, repeats and padded
    rows (the sentinel N)."""
    rng = np.random.default_rng((M, SALT_NODES))
    ids = rng.integers(0, g.num_nodes, M).astype(np.int32)
    ids[:3] = g.num_nodes - 1
    ids[3:5] = ids[10]
    ids[-4:] = g.num_nodes
    return ids


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).ravel()


def _eq(tensors, arrays):
    for t, a in zip(tensors, arrays):
        a = np.array(a)
        assert t.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(t.numpy(), a)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_registry_has_the_reference_samplers():
    assert sampling.available_samplers() == \
        sampling_j.available_samplers()
    assert available_policies() == tuple(sorted(
        ("rand", "norand", "comm_rand", "clustergcn", "labor")))


@pytest.mark.parametrize("name", ["biased", "uniform", "full", "labor"])
def test_registry_roundtrip(name, iso):
    g, _, gt = iso
    s = sampling.make_sampler(name)
    assert s.name == name
    assert s.describe() == sampling_j.make_sampler(name).describe()
    assert s.shared_randomness == (name == "labor")
    assert sampling.as_sampler(s) is s
    assert sampling.as_sampler((name, {})).describe() == s.describe()
    gen = torch.Generator().manual_seed(0)
    u = s.draw(gen, 32, 7)
    assert len(u) == {"biased": 2, "uniform": 1}.get(name, 0)
    kw = {"ranks": s.epoch_ctx((1, 2), gt)} if s.shared_randomness else {}
    nodes = torch.as_tensor(g.train_ids[:32], dtype=torch.int32)
    srcs, mask = s.sample(gt, nodes, 7, *u, **kw)
    assert srcs.shape == mask.shape == (32, 7)
    assert srcs.dtype == torch.int32 and mask.dtype == torch.bool
    for i, n in enumerate(nodes.tolist()):
        nbrs = set(g.indices[g.indptr[n]:g.indptr[n + 1]].tolist())
        for j in range(7):
            if mask[i, j]:
                assert int(srcs[i, j]) in nbrs


def test_every_policy_binds_a_sampler():
    for name in available_policies():
        assert hasattr(sampling.for_policy(make_policy(name)), "sample")
    assert sampling.for_policy(make_policy("labor")).name == "labor"
    assert sampling.for_policy(make_policy("clustergcn", p=0.7)).p == 0.7


# ---------------------------------------------------------------------------
# the samplers against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fanout", [3, 10, 300])
def test_uniform_sample_equals_reference(iso, fanout):
    g, gj, gt = iso
    nodes = _nodes(g)
    key = jax.random.key(fanout)
    want = sampling_j.UniformSampler().sample(key, gj, jnp.asarray(nodes),
                                              fanout)
    u = torch.as_tensor(np.array(jax.random.uniform(
        key, (len(nodes), fanout))))
    got = sampling.UniformSampler().sample(gt, torch.as_tensor(nodes),
                                           fanout, u)
    _eq(got, want)


@pytest.mark.parametrize("fanout", [3, 10, 300])
def test_full_sample_equals_reference(iso, fanout):
    g, gj, gt = iso
    nodes = _nodes(g)
    want = sampling_j.FullNeighborhoodSampler().sample(
        jax.random.key(0), gj, jnp.asarray(nodes), fanout)
    s = sampling.FullNeighborhoodSampler()
    got = s.sample(gt, torch.as_tensor(nodes), fanout,
                   *s.draw(torch.Generator(), len(nodes), fanout))
    _eq(got, want)
    if fanout == 300:                       # every neighbor, once
        assert int(got[1].sum()) == int(g.degrees()[nodes[:-4]].sum())


@pytest.mark.parametrize("fanout,seed", [(3, 0), (10, 1), (10, 7),
                                         (300, 2)])
def test_labor_sample_equals_reference(iso, fanout, seed):
    g, gj, gt = iso
    nodes = _nodes(g)
    key = jax.random.key(seed)
    want = sampling_j.LaborSampler().sample(key, gj, jnp.asarray(nodes),
                                            fanout)
    s = sampling.LaborSampler()
    got = s.sample(gt, torch.as_tensor(nodes), fanout,
                   ranks=s.epoch_ctx(_words(key), gt))
    _eq(got, want)


@pytest.mark.parametrize("levels", [2, 3, 16])
def test_labor_picks_with_tied_ranks_equal_reference(iso, levels):
    """Ranks quantised to a few values tie across most candidates of a
    row; the picks must still equal the reference's (the lower slot
    first), and ties must cut through the kept set."""
    g, gj, gt = iso
    nodes = _nodes(g, 64)
    rng = np.random.default_rng((levels, SALT_TIES))
    ranks = (rng.integers(0, levels, g.num_nodes) / levels).astype(
        np.float32)
    want = sampling_j.LaborSampler().sample(
        jax.random.key(0), gj, jnp.asarray(nodes), 5,
        ranks=jnp.asarray(ranks))
    got = sampling.LaborSampler().sample(
        gt, torch.as_tensor(nodes), 5, ranks=torch.as_tensor(ranks))
    _eq(got, want)
    srcs, mask = (t.numpy() for t in got)
    kept = ranks[srcs[mask[:, -1]]]        # rows that keep 5 of more
    assert (kept[:, -1:] == kept[:, :-1]).any()


def test_k_lowest_orders_ties_as_jax_top_k():
    rows = np.array([[.5, .25, .5, .25, np.inf, .25],
                     [0., 0., 0., 1., 0., np.inf],
                     [np.inf, np.inf, .1, np.inf, .1, .1]], np.float32)
    for k in (1, 3, 4, 6):
        _, want = jax.lax.top_k(-jnp.asarray(rows), k)
        got = _k_lowest(torch.as_tensor(rows), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _k_lowest(torch.as_tensor(rows), 4)[0].tolist() == [1, 3, 5, 0]


def test_labor_needs_ranks_and_a_max_degree(iso):
    g, _, gt = iso
    s = sampling.LaborSampler()
    nodes = torch.as_tensor(g.train_ids[:4], dtype=torch.int32)
    with pytest.raises(ValueError, match="ranks"):
        s.sample(gt, nodes, 3)
    bare = DeviceGraph(gt.indptr, gt.indices, gt.n_intra, gt.communities,
                       gt.degrees, gt.num_nodes, max_degree=0)
    with pytest.raises(ValueError, match="max_degree"):
        s.sample(bare, nodes, 3, ranks=s.epoch_ctx((0, 0), gt))
    with pytest.raises(ValueError, match="words"):
        mb.sampler_epoch_ctx(s, None, gt)


@pytest.mark.parametrize("n", [2000, 232_965])
def test_labor_ranks_bit_equal_reference(n):
    """Device ranks, the numpy mirror and the reference's hash of the same
    key words, at tiny's and reddit-602's node counts; at the latter
    distinct ids collide after the float32 rounding."""
    ids = torch.arange(n, dtype=torch.int64)
    for seed in (0, 5):
        key = jax.random.fold_in(jax.random.key(seed), 3)
        w = _words(key)
        want = np.asarray(hash_rank01_j(key, jnp.arange(n, dtype=jnp.int32)))
        got = _hash_rank01(w, ids).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            sampling.LaborSampler.epoch_ranks_np(w, n),
            sampling_j.LaborSampler.epoch_ranks_np(key, n))
    if n == 232_965:
        assert len(np.unique(got)) < n


# ---------------------------------------------------------------------------
# policies, orders, caps, plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [("labor", {}),
                                     ("clustergcn", {}),
                                     ("clustergcn", {"parts_per_batch": 3,
                                                     "p": 0.8})])
def test_policy_orders_and_root_batches_equal(tiny_graph, tiny_t, name, kw):
    pol, pol_j = make_policy(name, **kw), make_policy_j(name, **kw)
    assert pol.describe() == pol_j.describe()
    assert pol.sampler_spec() == pol_j.sampler_spec()
    for seed, epoch in ((0, 0), (3, 1), (3, 2)):
        rng, rng_j = (np.random.default_rng((seed, epoch)) for _ in "ab")
        np.testing.assert_array_equal(
            pol.epoch_order(tiny_t.train_ids, tiny_t.communities, rng),
            pol_j.epoch_order(tiny_graph.train_ids, tiny_graph.communities,
                              rng_j))
        np.testing.assert_array_equal(
            root_batches(tiny_t, pol, B, seed=seed, epoch=epoch),
            root_batches_j(tiny_graph, pol_j, B, seed=seed, epoch=epoch))
        if name == "clustergcn":
            got = pol.member_groups(tiny_t.communities,
                                    np.random.default_rng((seed, epoch)))
            want = pol_j.member_groups(tiny_graph.communities,
                                       np.random.default_rng((seed, epoch)))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert order_bitmatch(tiny_t, pol, seed=seed, epochs=(epoch,),
                              device=CPU)


@pytest.mark.parametrize("name", ["labor", "clustergcn"])
def test_calibrate_caps_equal(tiny_graph, tiny_t, name):
    got = mb.calibrate_caps(tiny_t, make_policy(name), B, FANOUTS, seed=1)
    want = mb_j.calibrate_caps(tiny_graph, make_policy_j(name), B, FANOUTS,
                               seed=1)
    assert got == want


def test_labor_caps_calibrate_below_rand(tiny_t):
    caps = {n: mb.calibrate_caps(tiny_t, make_policy(n), B, FANOUTS,
                                 n_probe=4) for n in ("rand", "labor")}
    assert caps["labor"][-1] <= caps["rand"][-1]
    cal = CapsCalibrator()
    assert "labor" in cal.key(tiny_t, make_policy("labor"), B, FANOUTS)
    assert cal.key(tiny_t, make_policy("labor"), B, FANOUTS) != \
        cal.key(tiny_t, make_policy("rand"), B, FANOUTS)


def test_presampled_plans_under_labor_equal(tiny_graph, tiny_t):
    kw = dict(capacity=300, batch_size=128, fanouts=(4, 4), seed=0)
    want = featcache_j.build_plan(tiny_graph, "presampled_freq",
                                  policy=make_policy_j("labor"), **kw)
    got = featcache.build_plan(tiny_t, "presampled_freq",
                               policy=make_policy("labor"), device=CPU,
                               **kw)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.cache.numpy(), np.asarray(want.cache))
    assert got.describe() == want.describe()


def test_numpy_builder_with_epoch_words_equals_reference(tiny_graph, tiny_t):
    """`build_batch_np` under LABOR with the epoch's words in `ctx` (the
    reference's `epoch_key`) gives the reference's levels."""
    key = jax.random.fold_in(jax.random.key(2), 1)
    roots = root_batches(tiny_t, "labor", B, seed=2, epoch=1)
    ctx, ctx_j = {"epoch_words": _words(key)}, {"epoch_key": key}
    for b in roots[:3]:
        got = mb.build_batch_np(np.random.default_rng(0), tiny_t, b,
                                FANOUTS, sampling.LaborSampler(), ctx)
        want = mb_j.build_batch_np(np.random.default_rng(0), tiny_graph, b,
                                   FANOUTS, sampling_j.LaborSampler(),
                                   ctx_j)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# whole batches against the reference's
# ---------------------------------------------------------------------------
def _pair(g, g_t, sampler, policy="rand", seed=4, caps=(1024, 1536)):
    gj, gt = DeviceGraphJ.from_graph(g), DeviceGraph.from_graph(g_t, CPU)
    sj = BatchStreamJ(g, make_policy_j(policy), B, FANOUTS, caps, seed=seed,
                      sampler=sampler, device_graph=gj)
    st = BatchStream(g_t, make_policy(policy), B, FANOUTS, caps, seed=seed,
                     sampler=sampler, device_graph=gt, device=CPU)
    return sj, st


@pytest.mark.parametrize("caps", [(1024, 1536), (384, 512)])
def test_labor_batches_equal_reference(tiny_graph, tiny_t, caps):
    """The reference's LABOR batch at (epoch, pos) from its epoch key; the
    port's from the ranks of that key's words (truncating caps too)."""
    sj, st = _pair(tiny_graph, tiny_t, None, "labor", caps=caps)
    s = st.sampler
    for epoch in (0, 1):
        ranks = s.epoch_ctx(_words(sj.epoch_key(epoch)), st.g)
        roots = st.root_batches(epoch)
        for pos in (0, 3, len(roots) - 1):
            jb = sj.build(roots[pos], epoch, pos)
            tb = mb._build_batch_impl(
                st.g, torch.as_tensor(roots[pos], dtype=torch.int32),
                st.labels, FANOUTS, caps, s, lambda h, M, r: (), ranks)
            assert_batches_equal(tb, jb)
        # `build_batch` hashes the words it is handed
        assert_batches_equal(mb.build_batch(
            st.g, torch.as_tensor(roots[0], dtype=torch.int32), st.labels,
            FANOUTS, caps, "labor", draw=lambda h, M, r: (),
            epoch_words=_words(sj.epoch_key(epoch))),
            sj.build(roots[0], epoch, 0))


def test_uniform_batches_equal_reference(tiny_graph, tiny_t):
    sj, st = _pair(tiny_graph, tiny_t, "uniform")
    caps = st.caps
    for pos in (0, 2):
        roots = st.root_batches(1)[pos]
        keys = jax.random.split(sj.batch_key(1, pos), len(FANOUTS))
        Ms = (B,) + caps

        def draw(h, M, r):
            assert M == Ms[h]
            return (torch.as_tensor(np.array(
                jax.random.uniform(keys[h], (M, r)))),)

        tb = mb.build_batch(st.g, torch.as_tensor(roots, dtype=torch.int32),
                            st.labels, FANOUTS, caps, "uniform", draw=draw)
        assert_batches_equal(tb, sj.build(roots, 1, pos))


def test_full_batches_equal_reference(tiny_graph, tiny_t):
    sj, st = _pair(tiny_graph, tiny_t, "full")
    for pos in (0, 5):
        roots = st.root_batches(0)[pos]
        assert_batches_equal(st.build(roots, 0, pos),
                             sj.build(roots, 0, pos))


# ---------------------------------------------------------------------------
# LABOR in the port: once-per-epoch ranks, sync against async
# ---------------------------------------------------------------------------
def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(batch_tensors(a), batch_tensors(b)))


def test_labor_ranks_once_per_epoch_and_shared(tiny_t):
    st = BatchStream(tiny_t, "labor", 128, FANOUTS, (512, 1024), seed=7,
                     device=CPU)
    bld = DeviceBatchBuilder.from_stream(st)
    for epoch in (0, 1):
        r = st.epoch_ctx(epoch)
        assert st.epoch_ctx(epoch) is r             # cached for the epoch
        assert bld.epoch_ranks(epoch) is bld.epoch_ranks(epoch)
        assert torch.equal(bld.epoch_ranks(epoch), r)
        np.testing.assert_array_equal(
            r.numpy(), sampling.LaborSampler.epoch_ranks_np(
                shared_words(7, epoch), tiny_t.num_nodes))
    assert not torch.equal(st.epoch_ctx(0), st.epoch_ctx(1))
    assert DeviceBatchBuilder.from_stream(BatchStream(
        tiny_t, "rand", 128, FANOUTS, (512, 1024), device=CPU)
    ).epoch_ranks(0) is None
    # a build that hoists nothing draws the same batch
    roots = st.root_batches(1)[2]
    assert _same(st.build(roots, 1, 2), mb._build_batch_impl(
        st.g, torch.as_tensor(roots, dtype=torch.int32), st.labels,
        FANOUTS, (512, 1024), st.sampler, lambda h, M, r: (),
        st.sampler.epoch_ctx(shared_words(7, 1), st.g)))


def test_labor_async_batches_equal_sync_over_two_epochs(tiny_t):
    sync = BatchStream(tiny_t, "labor", 128, FANOUTS, (512, 1024), seed=7,
                       device=CPU)
    asyn = AsyncBatchStream(tiny_t, "labor", 128, FANOUTS, (512, 1024),
                            seed=7, device=CPU)
    bld = DeviceBatchBuilder.from_stream(sync)
    try:
        nb = sync.num_batches(0)
        it_s, it_a = iter(sync), iter(asyn)
        for i in range(2 * nb + 1):
            b = next(it_s)
            assert _same(b, next(it_a))
            assert _same(b, bld.build(i // nb, i % nb))
    finally:
        asyn.close()


def _labor_trainer(g, pipeline):
    cfg = GNNConfig("sage-labor", "sage", 2, 16, g.feat_dim, g.num_classes,
                    fanout=FANOUTS)
    return GNNTrainer(g, cfg, TrainConfig(batch_size=128, max_epochs=2),
                      make_policy("labor"), caps=(512, 1024),
                      eval_caps=(512, 1024), seed=3, pipeline=pipeline,
                      device=CPU)


def test_labor_trains_and_async_equals_sync(tiny_t):
    want = _labor_trainer(tiny_t, "sync").train_steps(20)
    a = _labor_trainer(tiny_t, "async")
    try:
        assert a.stream.sampler.name == "labor"
        got = a.train_steps(20)
    finally:
        a.stream.close()
    assert got == want                      # bit for bit, across an epoch
    assert np.isfinite(want).all()
    assert np.mean(want[-4:]) < np.mean(want[:4])


def test_eval_batches_take_a_shared_sampler(tiny_t):
    """Evaluation through LABOR hashes one set of words for every chunk,
    a pure function of the seed."""
    from repro_torch.batching import eval_batches
    from repro_torch.batching.stream import SALT_LABOR_EVAL
    ids = tiny_t.val_ids
    a, b = (list(eval_batches(tiny_t, ids, 64, FANOUTS, (512, 1024), seed=2,
                              sampler="labor", device=CPU)) for _ in "ab")
    assert len(a) == -(-len(ids) // 64)
    s = sampling.LaborSampler()
    gt = DeviceGraph.from_graph(tiny_t, CPU)
    ranks = s.epoch_ctx(shared_words(2, 0, SALT_LABOR_EVAL), gt)
    pad = np.full(64, -1, np.int64)
    pad[:min(64, len(ids))] = ids[:64]
    want = mb._build_batch_impl(
        gt, torch.as_tensor(pad, dtype=torch.int32),
        torch.as_tensor(tiny_t.labels, dtype=torch.int32), FANOUTS,
        (512, 1024), s, lambda h, M, r: (), ranks)
    assert _same(a[0], want)
    assert all(_same(x, y) for x, y in zip(a, b))


def test_labor_footprint_below_rand(tiny_t):
    def mean_unique(policy):
        st = BatchStream(tiny_t, policy, B, FANOUTS, (2048, 2048), seed=0,
                         device=CPU)
        it = iter(st.epoch())
        return np.mean([int(next(it).num_unique) for _ in range(5)])
    assert mean_unique("labor") < mean_unique("rand")


# ---------------------------------------------------------------------------
# gather_mean
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("shape", [(30, 8, 12, 5), (64, 33, 40, 1),
                                   (7, 4, 9, 16)])
def test_gather_mean_matches_reference(use_kernel, shape):
    N, F, D, r = shape
    rng = np.random.default_rng((N, SALT_MEAN))
    x = rng.normal(size=(N, F)).astype(np.float32)
    idx = rng.integers(0, N, (D, r)).astype(np.int32)
    mask = rng.random((D, r)) < 0.7
    mask[0] = False                                  # an all-masked row
    want = np.asarray(gather_mean_j(jnp.asarray(x), jnp.asarray(idx),
                                    jnp.asarray(mask), use_kernel=use_kernel))
    xt = torch.as_tensor(x, dtype=torch.float32).requires_grad_(True)
    agg_kernel.reset_launches()
    got = gather_mean(xt, torch.as_tensor(idx), torch.as_tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        gather_mean_ref(xt, torch.as_tensor(idx),
                        torch.as_tensor(mask)).detach().numpy(),
        want, rtol=1e-5, atol=1e-6)
    assert np.all(got.detach().numpy()[0] == 0)
    g = rng.normal(size=(D, F)).astype(np.float32)
    (dx,) = torch.autograd.grad(got, xt, torch.as_tensor(g))
    _, vjp = jax.vjp(lambda a: gather_mean_j(a, jnp.asarray(idx),
                                             jnp.asarray(mask),
                                             use_kernel=use_kernel),
                     jnp.asarray(x))
    np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-6)
    assert set(agg_kernel.LAUNCHES.values()) == {0}  # the CPU's plain path
