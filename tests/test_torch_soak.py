"""The port's chaos soak (`repro_torch.resilience.soak`) against the
reference's (`repro.resilience.soak`) on the CPU: the same constants,
trigger windows and seeded plans, the same trainer configuration, and the
five scenarios on the tiny graph, each firing its fault, engaging its
recovery and ending bit-identical (losses `==`, parameter digest) to the
fault-free sync run."""
import dataclasses
import math

import numpy as np
import pytest

from repro.resilience import faults as ref_faults
from repro.resilience import soak as ref_soak
from repro_torch.core.reorder import prepare
from repro_torch.featcache.dynamic import DynamicCacheState
from repro_torch.graphs import synthetic
from repro_torch.models.gnn.models import params_to_jax
from repro_torch.resilience import faults, soak


@pytest.fixture(scope="module")
def tiny():
    return prepare(synthetic.load("tiny"), oracle=True)


@pytest.fixture(scope="module")
def results(tiny):
    return {r.scenario: r for r in soak.run_all(tiny, device="cpu")}


def test_constants_equal_the_reference():
    for name in ("BATCH", "FANOUTS", "CAPS", "SEED", "CKPT_EVERY", "N_STEPS",
                 "STALL_S", "WINDOWS", "EXPECT_METER"):
        assert getattr(soak, name) == getattr(ref_soak, name), name
    assert dataclasses.asdict(soak.GUARD) == dataclasses.asdict(
        ref_soak.GUARD)
    assert faults.FAULT_SITES == ref_faults.FAULT_SITES
    assert set(soak.EXPECT_METER) == set(faults.FAULT_SITES)


@pytest.mark.parametrize("site", faults.FAULT_SITES)
def test_seeded_plan_windows_equal_the_reference(site):
    counts = {site: soak.GUARD.max_consecutive_skips + 1} \
        if site == "step_nonfinite" else None
    for seed in (11, 23):
        got = faults.FaultPlan.seeded(seed, {site: soak.WINDOWS[site]},
                                      counts)
        want = ref_faults.FaultPlan.seeded(seed, {site: soak.WINDOWS[site]},
                                           counts)
        assert [(s.site, s.start, s.count) for s in got.specs] == \
            [(s.site, s.start, s.count) for s in want.specs]
        lo, hi = soak.WINDOWS[site]
        assert all(lo <= s.start <= hi for s in got.specs)


def test_trainer_configuration_equals_the_reference(tiny):
    tr = soak.make_trainer(tiny, pipeline="sync", ckpt_dir=None,
                           ckpt_every=0, device="cpu")
    assert (tr.cfg.model, tr.cfg.num_layers, tr.cfg.hidden_dim,
            tr.cfg.fanout) == ("sage", 2, 16, soak.FANOUTS)
    assert tr.tcfg.batch_size == soak.BATCH and tr.tcfg.max_epochs == 4
    pol = ref_soak.CommRandLaborPolicy("comm_rand", 0.125, 1.0)
    assert (tr.policy.root_mode, tr.policy.mix, tr.policy.p) == \
        (pol.root_mode, pol.mix, pol.p)
    assert tr.policy.sampler_spec() == pol.sampler_spec() == ("labor", {})
    assert tuple(tr.caps) == tuple(tr.eval_caps) == soak.CAPS
    assert tr.seed == soak.SEED and tr.guard == soak.GUARD
    assert isinstance(tr.cache, DynamicCacheState)
    assert tr.cache.policy == "degree_hot"


def test_params_digest_equals_the_reference_digest(tiny):
    """The same weights give the same sha1 in both packages: the leaves
    are hashed in the reference's tree order."""
    tr = soak.make_trainer(tiny, pipeline="sync", ckpt_dir=None,
                           ckpt_every=0, device="cpu")
    tr.train_steps(2)
    assert soak.params_digest(tr.params) == \
        ref_soak.params_digest(params_to_jax(tr.params))


@pytest.mark.parametrize("site", faults.FAULT_SITES)
def test_scenario_recovers_bit_exactly(results, site):
    res = results[site]
    assert res.fired >= 1, "the fault never fired"
    assert res.meter[soak.EXPECT_METER[site]] >= 1, res.meter
    assert res.bitmatch and res.digest_match, res.summary()
    assert res.ok and res.summary()["ok"]


def test_sync_and_async_fault_free_runs_are_equal(tiny):
    ref_losses, ref_digest = soak.run_reference(tiny, device="cpu")
    tr = soak.make_trainer(tiny, pipeline="async", ckpt_dir=None,
                           ckpt_every=0, device="cpu")
    try:
        losses = soak.run_steps_tracked(tr, soak.N_STEPS)
        digest = soak.params_digest(tr.params)
    finally:
        tr.stream.close()
    assert sorted(losses) == list(range(1, soak.N_STEPS + 1))
    assert losses == ref_losses and digest == ref_digest
    assert all(math.isfinite(x) for x in losses.values())


def test_a_trajectory_with_a_nan_is_not_ok():
    """`==` over the trajectories: a NaN the recovery failed to replay
    never matches, even against a NaN at the same step."""
    ref = {1: 1.5, 2: float(np.float32(np.nan))}
    got = {1: 1.5, 2: float("nan")}
    res = soak.SoakResult("step_nonfinite", 2, fired=1,
                          bitmatch=(got == ref), digest_match=True,
                          recovered=True, meter={"rollbacks": 1}, events=[])
    assert not res.bitmatch and not res.ok
    assert not soak.SoakResult("batch_build", 2, 0, True, True, True, {},
                               []).ok
