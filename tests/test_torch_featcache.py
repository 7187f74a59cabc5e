"""Feature-cache parity (paper §6.5): the port's static cache against the
JAX reference, on the CPU at the tiny graph's size.

- Rows and counters of `gather_cached` equal the reference's exactly (a
  copy: no rounding), under both reference impls (jnp and Pallas in
  interpret mode); gradients within rtol 1e-5 / atol 1e-6 (the scatter-adds
  sum in another order where padding rows share the clipped row).
- Plans, access streams and simulators equal the reference's exactly
  (integer and host-numpy results).
- `apply_gnn(cache=)` equals the uncached port bit for bit and the
  reference's cached path within rtol 1e-5 / atol 1e-6; cached and
  uncached trainer trajectories are bit-identical, and the measured hit
  counters equal the numpy mirror over the same batches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import featcache as featcache_j
from repro.batching import make_policy as make_policy_j
from repro.configs.base import GNNConfig as GNNConfigJ
from repro.core import minibatch as mb_j
from repro.featcache.sim import _lru_miss_rate_ref as lru_ref_j
from repro.graphs.csr import DeviceGraph as DeviceGraphJ
from repro.kernels.gather_cached.ops import cache_stats as cache_stats_j
from repro.kernels.gather_cached.ops import gather_cached as gather_cached_j
from repro.models.gnn.models import apply_gnn as apply_gnn_j
from repro.models.gnn.models import init_gnn as init_gnn_j
from repro_torch import featcache
from repro_torch.batching import BatchStream, make_policy
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core.reorder import prepare
from repro_torch.featcache.sim import _lru_miss_rate_ref
from repro_torch.graphs import synthetic
from repro_torch.kernels.gather_cached import kernel
from repro_torch.kernels.gather_cached.ref import gather_cached_ref
from repro_torch.models.gnn.models import apply_gnn, params_from_jax
from repro_torch.train.gnn_loop import GNNTrainer
from test_torch_batching import torch_batch

SALT_ROWS, SALT_GRAD, SALT_STREAM = 11, 12, 13


@pytest.fixture(scope="module")
def tiny_t():
    return prepare(synthetic.load("tiny"), oracle=True)


def _case(kind: str, seed: int, N=50, F=24, C=12, M=40):
    """(feats, cache, pos, ids) as numpy: a random plan of C rows and ids
    with padding (the sentinel N and -1), or every id a hit / a miss."""
    rng = np.random.default_rng((seed, SALT_ROWS))
    feats = rng.normal(size=(N, F)).astype(np.float32)
    if kind == "all_hit":
        rows = np.arange(N)
    elif kind == "all_miss":
        rows = np.zeros(0, np.int64)
    else:
        rows = np.sort(rng.choice(N, size=C, replace=False))
    pos = np.full(N, -1, np.int32)
    pos[rows] = np.arange(len(rows), dtype=np.int32)
    cache = feats[rows] if len(rows) else feats[:1]
    ids = rng.integers(0, N, M).astype(np.int32)
    if kind == "random":
        pad = rng.random(M)
        ids[pad < 0.15] = N
        ids[pad > 0.92] = -1
    return feats, cache, pos, ids


CASES = [("random", s) for s in range(4)] + [("all_hit", 0), ("all_miss", 0)]


# ---------------------------------------------------------------------------
# 1-2. rows, counters and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,seed", CASES)
def test_rows_and_counters_equal_reference(kind, seed):
    feats, cache, pos, ids = _case(kind, seed)
    N = feats.shape[0]
    rows, hits, misses = featcache.gather_cached(
        torch.as_tensor(cache), torch.as_tensor(feats), torch.as_tensor(pos),
        torch.as_tensor(ids))
    assert rows.dtype == torch.float32 and rows.shape == (len(ids),
                                                          feats.shape[1])
    got = rows.numpy()
    np.testing.assert_array_equal(got, feats[np.clip(ids, 0, N - 1)])
    np.testing.assert_array_equal(got, gather_cached_ref(
        *map(torch.as_tensor, (cache, feats, pos, ids))).numpy())
    want_counts = featcache.cache_stats_np(pos, ids, N)
    assert want_counts == featcache_j.cache_stats_np(pos, ids, N)
    assert (int(hits), int(misses)) == want_counts
    hj, mj = cache_stats_j(jnp.asarray(pos), jnp.asarray(ids), N)
    assert (int(hj), int(mj)) == want_counts
    for impl in ("jnp", "pallas"):
        out_j, hj, mj = gather_cached_j(jnp.asarray(cache), jnp.asarray(feats),
                                        jnp.asarray(pos), jnp.asarray(ids),
                                        impl=impl)
        np.testing.assert_array_equal(got, np.asarray(out_j), err_msg=impl)
        assert (int(hj), int(mj)) == want_counts
    if kind == "all_hit":
        assert want_counts == (len(ids), 0)
    elif kind == "all_miss":
        assert want_counts == (0, len(ids))


@pytest.mark.parametrize("kind,seed", CASES)
def test_gradients_match_reference(kind, seed):
    """d_cache and d_feats through the port's autograd (two fanout-1
    scatter-adds) against `jax.grad` through the reference's custom VJP
    (Pallas, interpret mode); padding ids send their cotangents to the
    clipped row in both."""
    feats, cache, pos, ids = _case(kind, seed)
    rng = np.random.default_rng((seed, SALT_GRAD))
    cot = rng.normal(size=(len(ids), feats.shape[1])).astype(np.float32)

    dc_j, df_j = jax.grad(
        lambda ca, fe: (gather_cached_j(ca, fe, jnp.asarray(pos),
                                        jnp.asarray(ids), impl="pallas")[0]
                        * cot).sum(), argnums=(0, 1))(
        jnp.asarray(cache), jnp.asarray(feats))

    ca = torch.as_tensor(cache).requires_grad_()
    fe = torch.as_tensor(feats).requires_grad_()
    rows, _, _ = featcache.gather_cached(ca, fe, torch.as_tensor(pos),
                                         torch.as_tensor(ids))
    (rows * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(ca.grad.numpy(), np.asarray(dc_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fe.grad.numpy(), np.asarray(df_j),
                               rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    kernel.reset_launches()
    feats, cache, pos, ids = _case("random", 0)
    ca = torch.as_tensor(cache).requires_grad_()
    rows = kernel.gather_cached_fwd(ca.detach(), torch.as_tensor(feats),
                                    torch.as_tensor(pos),
                                    torch.as_tensor(ids))
    out, _, _ = featcache.gather_cached(ca, torch.as_tensor(feats),
                                        torch.as_tensor(pos),
                                        torch.as_tensor(ids))
    out.sum().backward()
    assert torch.equal(rows, out.detach())
    assert kernel.LAUNCHES == {"gather_cached_fwd": 0}


# ---------------------------------------------------------------------------
# 3-4. plans, access streams, simulators
# ---------------------------------------------------------------------------
PLAN_KW = dict(capacity=300, batch_size=128, fanouts=(4, 4), seed=0)


@pytest.mark.parametrize("admission", ["degree_hot", "community_freq",
                                       "presampled_freq"])
def test_plans_equal_reference(tiny_graph, tiny_t, admission):
    assert featcache.available_admissions() == \
        featcache_j.available_admissions()
    want = featcache_j.build_plan(
        tiny_graph, admission, policy=make_policy_j("comm_rand", mix=0.0,
                                                    p=1.0), **PLAN_KW)
    got = featcache.build_plan(
        tiny_t, admission, policy=make_policy("comm_rand", mix=0.0, p=1.0),
        device="cpu", **PLAN_KW)
    assert got.pos.dtype == torch.int32 and got.cache.dtype == torch.float32
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.cache.numpy(), np.asarray(want.cache))
    np.testing.assert_array_equal(got.cached_ids(), want.cached_ids())
    assert (got.capacity, got.describe()) == (want.capacity,
                                              want.describe())


def _streams(g, g_t):
    """The policy's access stream on tiny through each package's own numpy
    builder (equal), and short random batch-deduped streams."""
    s_j = featcache_j.policy_access_stream(
        g, make_policy_j("comm_rand", mix=0.125, p=1.0), 128, (4, 4),
        n_batches=6, seed=3)
    s_t = featcache.policy_access_stream(
        g_t, make_policy("comm_rand", mix=0.125, p=1.0), 128, (4, 4),
        n_batches=6, seed=3)
    assert len(s_t) == len(s_j) == 6
    for a, b in zip(s_t, s_j):
        np.testing.assert_array_equal(a, b)
    out = [s_t]
    for seed in range(3):
        rng = np.random.default_rng((seed, SALT_STREAM))
        out.append([rng.choice(60, size=int(rng.integers(1, 31)),
                               replace=False)
                    for _ in range(int(rng.integers(2, 9)))])
    return out


def test_simulators_equal_reference(tiny_graph, tiny_t):
    assert featcache.CLOCK_TIE_BREAK == featcache_j.CLOCK_TIE_BREAK
    for stream in _streams(tiny_graph, tiny_t):
        for cap in (1, 7, 40, 300):
            lru = featcache.lru_miss_rate(stream, cap)
            assert lru == featcache_j.lru_miss_rate(stream, cap)
            assert lru == _lru_miss_rate_ref(stream, cap) == \
                lru_ref_j(stream, cap)
            assert featcache.clock_miss_rate(stream, cap) == \
                featcache_j.clock_miss_rate(stream, cap)
            got = featcache.clock_replay(stream, cap)
            want = featcache_j.clock_replay(stream, cap)
            assert got[0] == want[0] and got[3:] == want[3:]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
        cached = np.unique(np.concatenate(stream))[::3]
        assert featcache.static_miss_rate(stream, cached) == \
            featcache_j.static_miss_rate(stream, cached)
        pos = np.full(tiny_t.num_nodes, -1, np.int32)
        pos[cached] = np.arange(len(cached), dtype=np.int32)
        for ids in stream:
            for a, b in zip(
                    featcache.cache_ref_updates_np(pos, ids, len(cached)),
                    featcache_j.cache_ref_updates_np(pos, ids,
                                                     len(cached))):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# 5. models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small(tiny_graph):
    """A reference batch of 64 roots (fanout 4; the sentinel pads every
    level) and its degree array."""
    g = tiny_graph
    gj = DeviceGraphJ.from_graph(g)
    roots = np.full(64, -1, np.int64)
    roots[:60] = g.train_ids[200:260]
    jb = mb_j.build_batch(jax.random.key(7), gj,
                          jnp.asarray(roots, jnp.int32),
                          jnp.asarray(g.labels), (4, 4), (256, 768), 1.0)
    assert not bool(jnp.all(jb.node_mask))
    return jb, gj.degrees


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_apply_gnn_cache(tiny_graph, tiny_t, small, model, impl):
    """Cached logits equal the port's uncached ones bit for bit, and the
    reference's cached ones within rtol 1e-5 / atol 1e-6 (GAT 30 wide in 3
    heads, as in test_torch_models)."""
    jb, deg_j = small
    g = tiny_graph
    kw = dict(name="t", model=model, num_layers=2, hidden_dim=32,
              in_dim=g.feat_dim, num_classes=g.num_classes, fanout=(4, 4),
              dropout=0.0)
    if model == "gat":
        kw.update(hidden_dim=30, gat_heads=3)
    cfg_j, cfg = GNNConfigJ(**kw, agg_impl=impl), GNNConfig(**kw)
    params = init_gnn_j(cfg_j, jax.random.key(3))
    plan_j = featcache_j.build_plan(g, "degree_hot", capacity=500)
    want = apply_gnn_j(cfg_j, params, jb, jnp.asarray(g.features), deg_j,
                       feats_global=True, cache=plan_j)

    plan = featcache.build_plan(tiny_t, "degree_hot", capacity=500,
                                device="cpu")
    model_t = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tb = torch_batch(jb)
    feats = torch.as_tensor(tiny_t.features)
    deg = torch.as_tensor(np.array(deg_j))
    got = apply_gnn(cfg, model_t, tb, feats, deg, feats_global=True,
                    cache=plan)
    plain = apply_gnn(cfg, model_t, tb, feats, deg, feats_global=True)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="feats_global"):
        apply_gnn(cfg, model_t, tb, feats[tb.node_ids.clamp(
            max=tiny_t.num_nodes - 1)], deg, cache=plan)


# ---------------------------------------------------------------------------
# 6. trainer
# ---------------------------------------------------------------------------
def _trainer(g, **kw):
    cfg = GNNConfig("t", "sage", 2, 32, g.feat_dim, g.num_classes,
                    fanout=(4, 4), dropout=0.5)
    return GNNTrainer(g, cfg, TrainConfig(batch_size=64, max_epochs=1),
                      "comm_rand", caps=(384, 768), eval_caps=(384, 768),
                      seed=0, device="cpu", **kw)


def test_trainer_cache_is_bit_identical_and_metered(tiny_t):
    t0 = _trainer(tiny_t)
    t1 = _trainer(tiny_t, cache="presampled_freq", cache_frac=0.3)
    assert t0.cache is None and t1.cache is not None
    assert t1.stream.cache is t1.cache
    assert t1.cache.capacity == int(tiny_t.num_nodes * 0.3)
    l0, l1 = t0.train_steps(10), t1.train_steps(10)
    assert l0 == l1
    assert t0.cache_meter.total == 0
    # the meter's device counters equal the numpy mirror over a replay of
    # the same stream (the batches are pure functions of the cursor)
    replay = BatchStream(tiny_t, t1.policy, 64, t1.fanouts, t1.caps, seed=0,
                         device="cpu")
    it = iter(replay)
    pos = t1.cache.pos.numpy()
    want = np.zeros(2, np.int64)
    for _ in range(10):
        want += featcache.cache_stats_np(pos, next(it).node_ids.numpy(),
                                         tiny_t.num_nodes)
    assert (t1.cache_meter.hits, t1.cache_meter.misses) == tuple(want)
    assert 0.0 < t1.cache_meter.hit_rate < 1.0
    # evaluation reads through the cache and counts nothing
    total = t1.cache_meter.total
    assert t1.evaluate(tiny_t.val_ids) == t0.evaluate(tiny_t.val_ids)
    assert t1.cache_meter.total == total
    e0, e1 = t0.run_epoch(1e-3), t1.run_epoch(1e-3)
    assert e0["loss"] == e1["loss"] and e0["uniq"] == e1["uniq"]
    assert e0["cache_hit"] == 0.0 and 0.0 <= e1["cache_hit"] <= 1.0
    assert e1["cache_hit"] == t1.cache_meter.trajectory[-1]["hit_rate"]


def test_fit_reports_the_cache(tiny_t):
    r = _trainer(tiny_t, cache="degree_hot", cache_capacity=200).fit()
    assert r.cache == "degree_hot@C=200"
    assert 0.0 < r.cache_hit_rate < 1.0
    assert all(0.0 <= h.cache_hit_rate <= 1.0 for h in r.history)


@pytest.mark.parametrize("spec", ["dynamic", "dynamic:degree_hot"])
def test_dynamic_admission_is_refused(tiny_t, spec):
    """Dynamic (CLOCK) admission is ported (it raised before): the spec
    builds a CLOCK state seeded from its admission, and only a seed
    admission that is not registered is refused."""
    tr = _trainer(tiny_t, cache=spec)
    assert isinstance(tr.cache, featcache.DynamicCacheState)
    seed = spec.split(":")[1] if ":" in spec else "presampled_freq"
    assert tr.cache.policy.startswith(seed)
    assert tr.stream.cache is tr.cache
    with pytest.raises(KeyError, match="unknown admission"):
        _trainer(tiny_t, cache=f"{spec}_unknown" if ":" in spec
                 else "dynamic:unknown")


@pytest.mark.parametrize("entry", ["trainer", "stream", "plan"])
def test_cache_entry_points_raise_without_a_card(tiny_t, entry,
                                                 monkeypatch):
    """No card and no explicit device: raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "trainer":
            cfg = GNNConfig("t", "sage", 2, 32, tiny_t.feat_dim,
                            tiny_t.num_classes, fanout=(4, 4))
            GNNTrainer(tiny_t, cfg, TrainConfig(batch_size=64), "comm_rand",
                       caps=(384, 768), eval_caps=(384, 768),
                       cache="degree_hot")
        elif entry == "stream":
            BatchStream(tiny_t, "comm_rand", 64, (4, 4), (384, 768),
                        cache="degree_hot")
        else:
            featcache.build_plan(tiny_t, "degree_hot", capacity=100)
