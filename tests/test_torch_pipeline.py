"""`repro_torch.pipeline` held against the numpy orders, the reference's
device orders and the synchronous stream: the device epoch order element
for element (rand / norand / comm_rand over seeds and epochs, words with
the top bit set, the clustergcn program against JAX's), the builder's
batches bit for bit against `BatchStream.build`, the async stream's
sequence, resume and realignment, its watchdog, and the async trainer's
trajectory against the sync one (dynamic cache across a boundary, a guard
rollback, a mid-epoch resume). Every producer thread is bounded: streams
are closed in `finally`, and each watchdog wait by `stall_timeout_s`."""
import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.batching import make_policy as make_policy_j
from repro.pipeline import device_order as order_j
from repro_torch.batching import BatchStream, Cursor, make_policy
from repro_torch.batching.order import (SALT_BLOCK, SALT_ELEM, SALT_PERM,
                                        block_shuffle_perm,
                                        community_groups, hash_perm,
                                        hash_u32)
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic
from repro_torch.pipeline import (AsyncBatchStream, DeviceBatchBuilder,
                                  OrderSpec, device_epoch_order,
                                  order_bitmatch, stage_times)
from repro_torch.pipeline import device_order
from repro_torch.pipeline.device_order import _hash_u32, epoch_words_for
from repro_torch.pipeline.prefetch import batch_tensors
from repro_torch.resilience import (FaultPlan, FaultSpec, GuardConfig,
                                    InjectedFault, faults)
from repro_torch.train.gnn_loop import GNNTrainer, train_once
from repro_torch.train.monitor import ResilienceMeter

BATCH, FANOUTS, CAPS = 128, (5, 5), (512, 1024)
CPU = "cpu"
POLICIES = [("rand", {}), ("norand", {}), ("comm_rand", {"mix": 0.0}),
            ("comm_rand", {"mix": 0.125}), ("comm_rand", {"mix": 1.0})]
# edge words: zero, all ones, top bit only, and one of each
EDGE_WORDS = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0x80000000, 0x80000000),
              (0xFFFFFFFF, 0), (0x80000001, 0x7FFFFFFF)]


@pytest.fixture(scope="module")
def tiny_t():
    return prepare(synthetic.load("tiny"), oracle=True)


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(batch_tensors(a), batch_tensors(b)))


def _stream(g, cls=BatchStream, policy="comm_rand", **kw):
    return cls(g, make_policy(policy), BATCH, FANOUTS, CAPS, seed=7,
               device=CPU, **kw)


def _threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("AsyncBatchStream")]


# ---------------------------------------------------------------------------
# the device order
# ---------------------------------------------------------------------------
def test_hash_u32_equals_numpy_at_the_edges():
    rng = np.random.default_rng((26, 0))
    idx = np.concatenate([[0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                          rng.integers(0, 2 ** 32, 64, dtype=np.uint64)])
    words = EDGE_WORDS + [tuple(rng.integers(0, 2 ** 32, 2,
                                             dtype=np.uint64))]
    for w in words:
        w32 = np.asarray(w, np.uint32)
        for salt in (SALT_PERM, SALT_BLOCK, SALT_ELEM):
            want = hash_u32(idx.astype(np.uint32), w32, salt)
            got = _hash_u32(torch.as_tensor(idx.astype(np.int64)), w32,
                            salt)
            assert got.dtype == torch.int64
            assert np.array_equal(got.numpy(), want.astype(np.int64)), \
                (w, salt)


@pytest.mark.parametrize("name,kw", POLICIES)
def test_device_order_equals_numpy_and_jax(tiny_t, name, kw):
    """Element for element against the numpy policy order and the
    reference's jitted device order, over seeds and epochs."""
    pol = make_policy(name, **kw)
    spec = OrderSpec.for_policy(tiny_t, pol, CPU)
    spec_j = order_j.OrderSpec.for_policy(tiny_t, make_policy_j(name, **kw))
    for seed in (0, 3, 11):
        assert order_bitmatch(tiny_t, pol, seed=seed, epochs=(0, 1, 2),
                              device=CPU)
        for epoch in (0, 1, 5):
            w = epoch_words_for(seed, epoch)
            got = device_epoch_order(spec, w)
            assert got.dtype == torch.int32
            want_j = np.asarray(order_j.device_epoch_order(spec_j, w))
            assert np.array_equal(got.numpy(), want_j), (seed, epoch)


@pytest.mark.parametrize("name,kw", POLICIES)
def test_device_order_with_top_bit_words(tiny_t, name, kw):
    """Words with the top bit set (and all ones, all zeros) against the
    numpy closed form and the reference's device order."""
    pol = make_policy(name, **kw)
    spec = OrderSpec.for_policy(tiny_t, pol, CPU)
    spec_j = order_j.OrderSpec.for_policy(tiny_t, make_policy_j(name, **kw))
    train = tiny_t.train_ids
    groups = community_groups(train, tiny_t.communities)
    flat = np.concatenate(groups)
    sizes = np.array([len(g) for g in groups])
    for w in EDGE_WORDS:
        w32 = np.asarray(w, np.uint32)
        if name == "rand":
            want = train[hash_perm(len(train), w32)]
        elif name == "norand":
            want = flat
        else:
            want = flat[block_shuffle_perm(sizes, kw["mix"], w32)]
        got = device_epoch_order(spec, w32).numpy()
        assert np.array_equal(got, want), w
        assert np.array_equal(
            got, np.asarray(order_j.device_epoch_order(spec_j, w32))), w


def test_clustergcn_program_equals_jax(tiny_t):
    """The clustergcn order program (its policy is not registered in the
    port yet) against the reference's jitted one on the same layout."""
    train = np.asarray(tiny_t.train_ids)
    comm_of = np.asarray(tiny_t.communities[train])
    n_comm = int(tiny_t.communities.max()) + 1
    for ppb in (1, 3, n_comm):
        for w in EDGE_WORDS + [tuple(epoch_words_for(5, 1))]:
            w32 = np.asarray(w, np.uint32)
            got = device_order._order_clustergcn(
                w32, torch.as_tensor(train, dtype=torch.int32),
                torch.as_tensor(comm_of, dtype=torch.int64), n_comm, ppb)
            want = order_j._order_clustergcn(
                jnp.asarray(w32), jnp.asarray(train, jnp.int32),
                jnp.asarray(comm_of, jnp.int32), n_comm, ppb)
            assert np.array_equal(got.numpy(), np.asarray(want)), (ppb, w)
    spec = device_order.OrderSpec(
        "clustergcn", torch.as_tensor(train, dtype=torch.int32),
        comm_of=torch.as_tensor(comm_of), n_comm=n_comm, ppb=2)
    perm = device_epoch_order(spec, epoch_words_for(0, 0)).numpy()
    assert np.array_equal(np.sort(perm), np.sort(train))


def test_device_order_is_permutation_and_varies(tiny_t):
    spec = OrderSpec.for_policy(tiny_t, make_policy("comm_rand"), CPU)
    o0 = device_epoch_order(spec, epoch_words_for(0, 0)).numpy()
    o1 = device_epoch_order(spec, epoch_words_for(0, 1)).numpy()
    ref = np.sort(tiny_t.train_ids)
    assert np.array_equal(np.sort(o0), ref)
    assert np.array_equal(np.sort(o1), ref)
    assert not np.array_equal(o0, o1)        # epochs reshuffle


def test_unknown_policy_raises():
    class Odd:
        name = "odd"
        p = 0.5

    for name in ("odd", "labor", "clustergcn"):
        Odd.name = name
        with pytest.raises(NotImplementedError):
            OrderSpec.for_policy(None, Odd(), CPU)


# ---------------------------------------------------------------------------
# the builder against the synchronous stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy,drop_last", [("comm_rand", False),
                                              ("rand", False),
                                              ("norand", True)])
def test_builder_equals_stream_build_at_every_cursor(tiny_t, policy,
                                                     drop_last):
    """Every (epoch, pos) of two epochs, the -1-padded last batch (or its
    drop under drop_last) included: every tensor equal, dtype and all."""
    st = _stream(tiny_t, policy=policy, drop_last=drop_last)
    bld = DeviceBatchBuilder.from_stream(st)
    nb = st.num_batches(0)
    assert bld.num_batches == nb
    assert (len(tiny_t.train_ids) % BATCH != 0) is True
    for epoch in (0, 1):
        roots = st.root_batches(epoch)
        assert len(roots) == nb
        for pos in range(nb):
            assert _same(st.build(roots[pos], epoch, pos),
                         bld.build(epoch, pos)), (epoch, pos)
    if not drop_last:
        assert (roots[-1] == -1).any()      # the padded last batch ran
    with pytest.raises(IndexError):
        bld.build(0, nb)
    with pytest.raises(IndexError):
        bld.build(0, -1)
    assert bld.epoch_ranks(0) is None


def test_builder_standalone_and_epoch_roots(tiny_t):
    bld = DeviceBatchBuilder(tiny_t, make_policy("comm_rand"), BATCH,
                             FANOUTS, CAPS, seed=7, device=CPU)
    st = _stream(tiny_t)
    r0 = bld.epoch_roots(0)
    assert r0.shape == (bld.padded_len,) and r0.dtype == torch.int32
    assert np.array_equal(r0.numpy(), st.root_batches(0).reshape(-1))
    buf = r0.data_ptr()
    r1 = bld.epoch_roots(1)                 # refreshed in place
    assert r1.data_ptr() == buf
    assert np.array_equal(r1.numpy(), st.root_batches(1).reshape(-1))
    assert _same(bld.build(1, 3), st.build(st.root_batches(1)[3], 1, 3))


def test_stage_times_shape(tiny_t):
    st = _stream(tiny_t)
    bd = stage_times(st.g, st.root_batches(0)[0], st.labels, FANOUTS, CAPS,
                     st.sampler, seed=7, iters=2)
    assert set(bd) == {"roots_us", "sample_us", "dedup_us"}
    assert all(v > 0 for v in bd.values())


# ---------------------------------------------------------------------------
# the async stream: sequence, resume, realignment
# ---------------------------------------------------------------------------
def test_async_sequence_bitexact_vs_sync_over_two_epochs(tiny_t):
    sync = _stream(tiny_t)
    asyn = _stream(tiny_t, AsyncBatchStream)
    try:
        nb = sync.num_batches(0)
        it_s, it_a = iter(sync), iter(asyn)
        for _ in range(2 * nb + 1):            # crosses two boundaries
            assert _same(next(it_s), next(it_a))
            assert sync.cursor.state() == asyn.cursor.state()
    finally:
        asyn.close()
    assert not _threads()


def test_async_resume_mid_epoch_bitexact(tiny_t):
    """Stop the async stream mid-epoch with builds in flight, restore a
    fresh one from `Cursor.state()`: the continuation matches an
    uninterrupted synchronous run batch for batch."""
    sync = _stream(tiny_t)
    asyn = _stream(tiny_t, AsyncBatchStream, depth=2)
    try:
        it_s, it_a = iter(sync), iter(asyn)
        for _ in range(4):
            next(it_s)
            next(it_a)
        saved = asyn.cursor.state()
    finally:
        asyn.close()
    resumed = _stream(tiny_t, AsyncBatchStream, depth=2)
    resumed.cursor = Cursor.from_state(saved)
    try:
        it_r = iter(resumed)
        for _ in range(sync.num_batches(0)):   # through the boundary
            assert _same(next(it_s), next(it_r))
    finally:
        resumed.close()


def test_async_external_cursor_reset_realigns(tiny_t):
    """Assigning a new Cursor to a LIVE async stream (resume, rollback)
    discards in-flight work and realigns."""
    sync = _stream(tiny_t, policy="rand")
    asyn = _stream(tiny_t, AsyncBatchStream, policy="rand", depth=3)
    try:
        it_a = iter(asyn)
        for _ in range(3):
            next(it_a)
        asyn.cursor = Cursor(2, 5)          # jump while the producer runs
        got = next(iter(asyn))
        assert _same(sync.build(sync.root_batches(2)[5], 2, 5), got)
        assert asyn.cursor.state() == {"epoch": 2, "pos": 6}
        assert asyn.restarts == 0           # a realignment, not a restart
    finally:
        asyn.close()


def test_async_rejects_bad_depth(tiny_t):
    with pytest.raises(ValueError, match="depth"):
        _stream(tiny_t, AsyncBatchStream, depth=0)


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------
def _sync_batches(g, n):
    it = iter(_stream(g))
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("site", ["batch_build", "producer_hang"])
def test_watchdog_restarts_once_bitexact_and_metered(tiny_t, site):
    """A build failure kills the producer; a hang stops its heartbeat
    (after `prime()`, with a 0.5 s timeout). Either way the consumer
    restarts it once from the cursor it waits on: the sequence stays
    bit-exact and the meter counts one `producer_restarts`."""
    want = _sync_batches(tiny_t, 9)
    meter = ResilienceMeter()
    asyn = _stream(tiny_t, AsyncBatchStream, meter=meter)
    plan = FaultPlan(specs=(FaultSpec(site, 4),))
    try:
        if site == "producer_hang":
            asyn.prime()
            asyn.stall_timeout_s = 0.5
        it = iter(asyn)
        with faults.inject(plan):
            got = [next(it) for _ in range(9)]
    finally:
        asyn.close()
    assert len(plan.fired(site)) == 1
    assert asyn.restarts == 1 and meter.producer_restarts == 1
    assert meter.events[0]["kind"] == "producer_restarts"
    assert all(_same(a, b) for a, b in zip(want, got))
    assert not _threads()


def test_watchdog_budget_exhausted_raises_the_real_error(tiny_t):
    meter = ResilienceMeter()
    asyn = _stream(tiny_t, AsyncBatchStream, meter=meter, max_restarts=2,
                   restart_backoff_s=0.0)
    plan = FaultPlan(specs=(FaultSpec("batch_build", 0, 100),))
    try:
        with faults.inject(plan), pytest.raises(InjectedFault) as err:
            next(iter(asyn))
    finally:
        asyn.close()
    assert err.value.site == "batch_build"
    assert asyn.restarts == 2 and meter.producer_restarts == 2
    assert not _threads()


def test_close_is_idempotent_and_leaves_no_producer(tiny_t):
    asyn = _stream(tiny_t, AsyncBatchStream, depth=2)
    it = iter(asyn)
    next(it)
    assert _threads()
    asyn.close()
    asyn.close()
    assert not _threads()
    # close() then reuse restarts from the cursor
    try:
        assert _same(next(iter(asyn)), _sync_batches(tiny_t, 2)[1])
    finally:
        asyn.close()
    assert not _threads()


# ---------------------------------------------------------------------------
# the async trainer against the sync one
# ---------------------------------------------------------------------------
def _trainer(g, pipeline, **kw):
    cfg = GNNConfig("sage-pipe", "sage", 2, 16, g.feat_dim, g.num_classes,
                    fanout=FANOUTS)
    tcfg = TrainConfig(batch_size=BATCH, max_epochs=2)
    return GNNTrainer(g, cfg, tcfg, "comm_rand", caps=CAPS, eval_caps=CAPS,
                      seed=3, pipeline=pipeline, device=CPU, **kw)


def test_async_trainer_with_dynamic_cache_across_a_boundary(tiny_t):
    ref = _trainer(tiny_t, "sync", cache="dynamic")
    want = ref.train_steps(14)
    a = _trainer(tiny_t, "async", cache="dynamic")
    try:
        got = a.train_steps(14)
    finally:
        a.stream.close()
    assert got == want                      # bit-exact, not allclose
    assert a.cache_meter.refills == ref.cache_meter.refills > 0
    assert (a.cache_meter.hits, a.cache_meter.misses) == \
        (ref.cache_meter.hits, ref.cache_meter.misses)
    for f in ("pos", "slot_ids", "refbit", "cache"):
        assert torch.equal(getattr(a.cache, f), getattr(ref.cache, f))
    assert a.guard_meter.producer_restarts == 0


def test_async_trainer_through_a_guard_rollback(tiny_t):
    """A NaN burst past the skip budget rolls back to the step-4
    checkpoint; the async stream realigns to the restored cursor and the
    replayed trajectory equals the fault-free sync one."""
    want = _trainer(tiny_t, "sync").train_steps(12)
    with tempfile.TemporaryDirectory() as d:
        a = _trainer(tiny_t, "async", ckpt_dir=d, ckpt_every=4,
                     guard=GuardConfig(max_consecutive_skips=1,
                                       check_every=1))
        plan = FaultPlan(specs=(FaultSpec("step_nonfinite", 5, 2),))
        losses = {}
        try:
            with faults.inject(plan):
                while a.global_step < 12:
                    prev = a.global_step
                    (loss,) = a.train_steps(1)
                    if a.global_step == prev + 1:
                        losses[a.global_step] = loss
        finally:
            a.stream.close()
    assert a.guard_meter.rollbacks == 1
    assert [losses[i] for i in range(1, 13)] == want


def test_async_trainer_resume_mid_epoch_bitexact(tiny_t):
    """8 async steps with a checkpoint at 8 and builds in flight, the
    stream closed ("crash"), a fresh async trainer resumes there and takes
    6 more: the 14 losses equal 14 uninterrupted sync steps."""
    want = _trainer(tiny_t, "sync").train_steps(14)
    with tempfile.TemporaryDirectory() as d:
        a = _trainer(tiny_t, "async", ckpt_dir=d, ckpt_every=8)
        try:
            first = a.train_steps(8)
            at_kill = a.stream.cursor.state()
        finally:
            a.stream.close()
        b = _trainer(tiny_t, "async", ckpt_dir=d, ckpt_every=0)
        try:
            assert b.global_step == 8
            assert b.stream.cursor.state() == at_kill
            rest = b.train_steps(6)
        finally:
            b.stream.close()
    assert first + rest == want


def test_train_once_async_closes_its_producer(tiny_t):
    cfg = GNNConfig("sage-pipe", "sage", 2, 16, tiny_t.feat_dim,
                    tiny_t.num_classes, fanout=FANOUTS)
    tcfg = TrainConfig(batch_size=BATCH, max_epochs=1)
    res = train_once(tiny_t, cfg, "comm_rand", tcfg, seed=3,
                     pipeline="async", device=CPU)
    assert np.isfinite(res.history[0].train_loss)
    assert not _threads()


@pytest.mark.parametrize("bad", ["bogus", "", None])
def test_unknown_pipeline_raises(tiny_t, bad):
    with pytest.raises(ValueError, match="pipeline"):
        _trainer(tiny_t, bad)
