"""Dynamic CLOCK admission in the port (`repro_torch.featcache.dynamic`,
`kernels.clock_refill`), held against the reference's own functions: the
extended counters (`cache_ref_updates`) equal the reference's and the
numpy mirror, `ref_updates` equals `ref_updates_np`, and the plain refill
(candidate sort + the plain CLOCK walk + row copy) equals `refill_np` and
the reference's jitted `refill` slot for slot — residency, rows, bits
(including those a failed pass leaves cleared), hand and churn — at
seeded cases dense with frequency ties and at the tie-breaking cases of
tests/test_featcache_dynamic.py. The trainer on tiny keeps its losses
bit-identical to the uncached run across an epoch boundary while the
cache churns, evaluation feeds no counter, epoch 0's counters equal the
static plan's, and the port's CLOCK state equals the reference's
`ref_updates`/`refill` run on the same batches at every boundary."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.featcache import dynamic as dynamic_j
from repro.featcache.dynamic import DynamicCacheState as DynamicCacheStateJ
from repro.kernels.gather_cached.ops import \
    cache_ref_updates as cache_ref_updates_j
from repro_torch import featcache
from repro_torch.batching import make_policy
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core.reorder import prepare
from repro_torch.featcache import dynamic
from repro_torch.featcache.dynamic import DynamicCacheState
from repro_torch.graphs import synthetic
from repro_torch.kernels.clock_refill import kernel as walk_kernel
from repro_torch.train.gnn_loop import GNNTrainer

FANOUTS, CAPS, B = (5, 5), (768, 1152), 256


@pytest.fixture(scope="module")
def tiny_t():
    return prepare(synthetic.load("tiny"), oracle=True)


def _random_fields(seed, n, c, f, max_freq=4):
    """A mid-epoch CLOCK state as numpy fields (small `max_freq` forces
    plenty of frequency TIES) and the matching feature matrix."""
    rng = np.random.default_rng((seed, 5))
    feats = rng.normal(size=(n, f)).astype(np.float32)
    ids = np.sort(rng.choice(n, size=c, replace=False))
    pos = np.full(n, -1, np.int32)
    pos[ids] = np.arange(c, dtype=np.int32)
    fields = {"cache": feats[ids], "pos": pos,
              "slot_ids": ids.astype(np.int32),
              "refbit": rng.integers(0, 2, c).astype(np.int32),
              "slot_freq": rng.integers(0, max_freq, c).astype(np.int32),
              "freq": rng.integers(0, max_freq, n).astype(np.int32),
              "hand": np.asarray(int(rng.integers(0, c)), np.int32)}
    return fields, feats


def _port_state(fields, policy="test"):
    return DynamicCacheState(**{k: torch.as_tensor(np.array(v))
                                for k, v in fields.items()},
                             capacity=len(fields["slot_ids"]), policy=policy)


def _ref_state(fields, policy="test"):
    return DynamicCacheStateJ(**{k: jnp.asarray(v) for k, v in fields.items()},
                              capacity=len(fields["slot_ids"]), policy=policy)


def _np_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# extended counters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,c,m,seed", [(16, 1, 4, 0), (50, 7, 33, 1),
                                        (200, 40, 128, 2), (50, 50, 64, 3)])
def test_ref_updates_match_reference_and_mirror(n, c, m, seed):
    fields, _ = _random_fields(seed, n, c, 4)
    rng = np.random.default_rng((seed, 6))
    # padded (>= n) and negative entries are excluded everywhere
    ids = np.where(rng.random(m) < 0.15, n,
                   rng.integers(-1, n, m)).astype(np.int32)
    state = _port_state(fields)
    sh, nm = featcache.cache_ref_updates(state.pos, torch.as_tensor(ids), c)
    sh_j, nm_j = cache_ref_updates_j(jnp.asarray(fields["pos"]),
                                     jnp.asarray(ids), c)
    sh_np, nm_np = featcache.cache_ref_updates_np(fields["pos"], ids, c)
    for got, want in ((sh, sh_j), (nm, nm_j), (sh, sh_np), (nm, nm_np)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hits, misses = featcache.cache_stats(state.pos, torch.as_tensor(ids), n)
    assert int(sh.sum()) == int(hits) and int(nm.sum()) == int(misses)
    folded = dynamic.with_refs(state, dynamic.ref_updates(
        state, torch.as_tensor(ids)))
    _np_equal(dynamic.state_to_np(folded),
              dynamic.ref_updates_np(dynamic.state_to_np(state), ids))
    assert folded.cache is state.cache      # the rows are not copied


# ---------------------------------------------------------------------------
# refill == numpy oracle == the reference's jitted refill
# ---------------------------------------------------------------------------
REFILL_CASES = [(12, 1, 3, 0), (12, 5, 2, 1), (40, 2, 5, 2), (40, 16, 3, 3),
                (40, 16, 5, 4), (90, 5, 2, 5), (90, 16, 2, 6),
                (90, 40, 5, 7)]


@pytest.mark.parametrize("n,c,max_freq,seed", REFILL_CASES)
def test_refill_matches_oracle_and_reference(n, c, max_freq, seed):
    fields, feats = _random_fields(seed, n, c, 4, max_freq=max_freq)
    state = _port_state(fields)
    before = dynamic.state_to_np(state)
    got, adm = dynamic.refill(state, torch.as_tensor(feats))
    oracle, adm_np = dynamic.refill_np(before, feats)
    ref, adm_j = dynamic_j.refill(_ref_state(fields), jnp.asarray(feats))
    _np_equal(dynamic.state_to_np(got), oracle)
    _np_equal(dynamic.state_to_np(got), dynamic_j.state_to_np(ref))
    assert adm == adm_np == int(adm_j)
    assert got.hand.shape == () and got.pos.dtype == torch.int32
    _np_equal(dynamic.state_to_np(state), before)   # input not modified
    assert dynamic.integrity_ok(got)


def test_plain_walk_reports_steps_and_admissions():
    fields, feats = _random_fields(9, 60, 12, 4, max_freq=3)
    state = _port_state(fields)
    _, walk, adm = featcache.dynamic.clock_refill(
        state.cache, state.pos, state.slot_ids, state.refbit,
        state.slot_freq, state.freq, state.hand, torch.as_tensor(feats))
    assert int(walk.n_admitted) == adm > 0
    slots, nodes = walk.adm_slots[:adm], walk.adm_nodes[:adm]
    assert torch.equal(walk.slot_ids[slots.long()], nodes)
    assert torch.equal(walk.pos[nodes.long()], slots)
    assert int(walk.steps) >= 0
    assert walk_kernel.LAUNCHES["clock_refill"] == 0     # the CPU path


def _tie_state(pos_ids, n, refbit, slot_freq, freq, hand):
    c = len(pos_ids)
    feats = np.arange(n, dtype=np.float32).reshape(n, 1).repeat(2, 1)
    pos = np.full(n, -1, np.int32)
    pos[np.asarray(pos_ids)] = np.arange(c, dtype=np.int32)
    fields = {"cache": feats[np.asarray(pos_ids)], "pos": pos,
              "slot_ids": np.asarray(pos_ids, np.int32),
              "refbit": np.asarray(refbit, np.int32),
              "slot_freq": np.asarray(slot_freq, np.int32),
              "freq": np.asarray(freq, np.int32),
              "hand": np.asarray(hand, np.int32)}
    return fields, feats


# (state, admitted, slot_ids, hand or None): the rules of
# featcache.sim.CLOCK_TIE_BREAK on the refill side
TIES = [
    # equal-frequency candidates in ascending id: 5 and 6 get the slots
    (([0, 1, 2], 8, [0, 0, 0], [9, 0, 0], [0, 0, 0, 0, 0, 2, 2, 2], 1),
     2, [0, 5, 6], None),
    # candidate as hot as every occupant: the incumbents stay
    (([0, 1, 2], 6, [0, 0, 0], [2, 2, 2], [0, 0, 0, 2, 2, 2], 0),
     0, [0, 1, 2], 0),
    # all clear and equally cold: the victim is the slot at the hand
    (([0, 1, 2], 6, [0, 0, 0], [0, 0, 0], [0, 0, 0, 5, 0, 0], 2),
     1, [0, 1, 3], 0),
    # second chance: the referenced slot at the hand survives, bit gone
    (([0, 1, 2], 6, [0, 1, 0], [0, 9, 0], [0, 0, 0, 5, 0, 0], 1),
     1, [0, 1, 3], 0),
]


@pytest.mark.parametrize("case,admitted,slot_ids,hand", TIES)
def test_refill_tie_breaking(case, admitted, slot_ids, hand):
    fields, feats = _tie_state(*case)
    got, adm = dynamic.refill(_port_state(fields), torch.as_tensor(feats))
    ref, adm_j = dynamic_j.refill(_ref_state(fields), jnp.asarray(feats))
    _np_equal(dynamic.state_to_np(got), dynamic_j.state_to_np(ref))
    assert adm == int(adm_j) == admitted
    assert got.slot_ids.tolist() == slot_ids
    if hand is not None:
        assert int(got.hand) == hand


def test_integrity_check_detects_corruption(tiny_t):
    state = featcache.as_cache("dynamic:degree_hot", tiny_t,
                               policy=make_policy("rand"), batch_size=B,
                               fanouts=FANOUTS, seed=0, device="cpu")
    assert dynamic.integrity_ok(state)
    bad = dynamic._corrupt_state(state, np.random.default_rng((0, 7)))
    assert not dynamic.integrity_ok(bad)
    new_state, _ = dynamic.refill(state, torch.as_tensor(tiny_t.features))
    assert dynamic.integrity_ok(new_state)


def test_as_cache_and_to_dynamic(tiny_t):
    kw = dict(policy=make_policy("comm_rand", mix=0.0, p=1.0),
              batch_size=128, fanouts=(4, 4), seed=0, capacity=200,
              device="cpu")
    assert featcache.as_cache(None, tiny_t, **kw) is None
    plan = featcache.build_plan(tiny_t, "degree_hot", capacity=200,
                                device="cpu")
    assert featcache.as_cache(plan, tiny_t, **kw) is plan
    assert isinstance(featcache.as_cache("degree_hot", tiny_t, **kw),
                      featcache.CachePlan)
    dyn = featcache.as_cache("dynamic:degree_hot", tiny_t, **kw)
    assert isinstance(dyn, DynamicCacheState)
    assert featcache.as_cache(dyn, tiny_t, **kw) is dyn
    d2 = plan.to_dynamic()
    assert torch.equal(d2.pos, plan.pos) and torch.equal(d2.cache,
                                                         plan.cache)
    np.testing.assert_array_equal(d2.cached_ids(), plan.cached_ids())
    assert int(d2.hand) == 0 and int(d2.refbit.sum()) == 0
    assert d2.describe() == "clock[degree_hot]@C=200"
    assert "presampled_freq" in featcache.as_cache("dynamic", tiny_t,
                                                   **kw).policy


# ---------------------------------------------------------------------------
# the trainer on tiny, on the CPU
# ---------------------------------------------------------------------------
def _trainer(g, cache, **kw):
    cfg = GNNConfig("t", "sage", 2, 32, g.feat_dim, g.num_classes,
                    fanout=FANOUTS, dropout=0.5)
    return GNNTrainer(g, cfg, TrainConfig(batch_size=B, max_epochs=3),
                      "comm_rand", caps=CAPS, eval_caps=CAPS, seed=0,
                      cache=cache, cache_frac=0.3, device="cpu", **kw)


def test_trainer_dynamic_cache_bit_identical(tiny_t):
    """Losses bit-identical to the uncached run across an epoch boundary
    (a refill lands inside the window) while the cache churns; epoch 0's
    counters equal the static plan's (same residency, same batches)."""
    t0 = _trainer(tiny_t, None)
    t1 = _trainer(tiny_t, "dynamic")
    ts = _trainer(tiny_t, "presampled_freq")
    assert t1.stream.cache is t1.cache
    nb = t1.stream.num_batches(0)
    assert t0.train_steps(nb + 3) == t1.train_steps(nb + 3)
    assert t1.cache_meter.refills > 0
    assert t1.stream.cache is t1.cache    # the stream follows the state
    assert t0.cache_meter.total == 0
    # epoch 0 alone: the dynamic cache is the static plan until the refill
    t1 = _trainer(tiny_t, "dynamic")
    ts.train_steps(nb)
    t1.train_steps(nb)
    assert (t1.cache_meter.hits, t1.cache_meter.misses) == \
        (ts.cache_meter.hits, ts.cache_meter.misses)
    assert t1.cache_meter.refills > 0 and int(t1.cache.freq.sum()) == 0
    pos, sid = t1.cache.pos, t1.cache.slot_ids
    assert torch.equal(pos[sid.long()], torch.arange(len(sid),
                                                     dtype=torch.int32))
    assert torch.equal(t1.cache.cache, t1.feats[sid.long()])


def test_eval_does_not_feed_admission(tiny_t):
    t = _trainer(tiny_t, "dynamic")
    t.train_steps(3)
    before = dynamic.state_to_np(t.cache)
    ev = t.evaluate(tiny_t.val_ids)
    assert 0.0 <= ev["acc"] <= 1.0
    _np_equal(dynamic.state_to_np(t.cache), before)


def test_clock_state_equals_the_reference_on_the_same_batches(tiny_t):
    """Two epochs: the reference's `ref_updates` / `with_refs` / `refill`
    fed the node ids of the port's batches end each epoch in the port
    trainer's CLOCK state, slot for slot."""
    t = _trainer(tiny_t, "dynamic")
    state_j = _ref_state(dynamic.state_to_np(t.cache), t.cache.policy)
    feats_j = jnp.asarray(tiny_t.features)
    stream = t.stream
    for epoch in range(2):
        roots = stream.root_batches(epoch)
        for p in range(len(roots)):
            ids = stream.build(roots[p], epoch, p).node_ids.numpy()
            state_j = dynamic_j.with_refs(state_j, dynamic_j.ref_updates(
                state_j, jnp.asarray(ids)))
        state_j, _ = dynamic_j.refill(state_j, feats_j)
        t.run_epoch(t.tcfg.learning_rate)
        _np_equal(dynamic.state_to_np(t.cache),
                  dynamic_j.state_to_np(state_j))
    assert len(t.cache_meter.trajectory) == 2
