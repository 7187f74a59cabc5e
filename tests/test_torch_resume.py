"""Checkpoints, resume and the guard in the port's trainer.

Port against port, bit for bit (`torch.equal` on losses, params, AdamW's
state and the CLOCK state): a run checkpointed and resumed mid-epoch
equals the uninterrupted one for SAGE with the dynamic cache, for GCN
and for GAT; across an epoch-boundary refill (`cache_epoch` keeps the
resumed run from skipping or repeating it); and `fit()` resumed between
epochs or from a finished, early-stopped run. A checkpoint of the
reference's own state, made by its jitted step on converted batches and
saved with `repro.train.checkpoint`, continues in the port within rtol
1e-4 of the reference's continuation.

The guard: a `step_nonfinite` burst past the skip budget makes exactly
one rollback and a trajectory bit-identical to the fault-free run; with no
`ckpt_dir` it raises `StepFailure`; a `ckpt_truncate` save is absorbed by
`restore_latest` (metered); a `cache_corrupt` refill degrades to the
uncached gather with the trajectory unchanged; a seeded `FaultPlan`
draws the reference's windows. Last, the training CLI run twice on one
`--ckpt-dir` resumes."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.batching import BatchStream as BatchStreamJ
from repro.batching import make_policy as make_policy_j
from repro.configs.base import GNNConfig as GNNConfigJ
from repro.configs.base import TrainConfig as TrainConfigJ
from repro.graphs.csr import DeviceGraph as DeviceGraphJ
from repro.models.gnn.models import init_gnn as init_gnn_j
from repro.optim import adamw as adamw_j
from repro.resilience import FaultPlan as FaultPlanJ
from repro.train import checkpoint as ckpt_j
from repro.train.gnn_loop import _make_steps
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core.reorder import prepare
from repro_torch.featcache.dynamic import DynamicCacheState
from repro_torch.graphs import synthetic
from repro_torch.resilience import (FaultPlan, FaultSpec, GuardConfig,
                                    as_guard, faults)
from repro_torch.train.gnn_loop import GNNTrainer
from repro_torch.train.monitor import StepFailure
from test_torch_batching import torch_batch

FANOUTS, CAPS, B = (5, 5), (768, 1152), 256
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def tiny_t():
    return prepare(synthetic.load("tiny"), oracle=True)


def _trainer(g, model="sage", cache=None, d=None, every=0, guard=None,
             tcfg=None, dropout=0.5):
    cfg = GNNConfig("t", model, 2, 32, g.feat_dim, g.num_classes,
                    fanout=FANOUTS, dropout=dropout)
    return GNNTrainer(g, cfg, tcfg or TrainConfig(batch_size=B, max_epochs=3),
                      "comm_rand", caps=CAPS, eval_caps=CAPS, seed=0,
                      cache=cache, cache_frac=0.3, ckpt_dir=d,
                      ckpt_every=every, guard=guard, device="cpu")


def _assert_same_state(a: GNNTrainer, b: GNNTrainer) -> None:
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(x, y)
    for k in ("m", "v"):
        for x, y in zip(a.opt_state[k], b.opt_state[k]):
            assert torch.equal(x, y)
    assert torch.equal(a.opt_state["count"], b.opt_state["count"])
    assert a.opt_state["count"].dtype == torch.int32
    assert a.stream.cursor.state() == b.stream.cursor.state()
    assert type(a.cache) is type(b.cache)
    if isinstance(a.cache, DynamicCacheState):
        for f in DynamicCacheState.DATA_FIELDS:
            x, y = getattr(a.cache, f), getattr(b.cache, f)
            assert x.dtype == y.dtype and torch.equal(x, y), f


# ---------------------------------------------------------------------------
# port against port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model,cache", [("sage", "dynamic"), ("gcn", None),
                                         ("gat", None)])
def test_resume_mid_epoch_is_bit_exact(tiny_t, tmp_path, model, cache):
    """Checkpoint at step 4 (epoch 0, batch 4 of 6), resume, run to step
    10: past the epoch-6 boundary (the dynamic cache's refill)."""
    a = _trainer(tiny_t, model, cache)
    la = a.train_steps(10)
    d = str(tmp_path)
    b = _trainer(tiny_t, model, cache, d=d, every=4)
    b.train_steps(7)
    del b                                   # "crash" at step 7
    b2 = _trainer(tiny_t, model, cache, d=d, every=4)
    assert b2.global_step == 4
    assert b2.stream.cursor.state() == {"epoch": 0, "pos": 4}
    assert b2.train_steps(6) == la[4:]
    _assert_same_state(a, b2)
    if cache:
        assert a.cache_meter.refills > 0


@pytest.mark.parametrize("every", [5, 6])
def test_resume_across_a_refill(tiny_t, tmp_path, every):
    """Checkpoints one step before the epoch boundary and at it (after
    its refill, `cache_epoch` 1): the resumed run makes each boundary's
    refill exactly once, through a second boundary at step 12."""
    a = _trainer(tiny_t, cache="dynamic")
    la = a.train_steps(13)
    d = str(tmp_path)
    b = _trainer(tiny_t, cache="dynamic", d=d, every=every)
    b.train_steps(every)
    b2 = _trainer(tiny_t, cache="dynamic", d=d, every=every)
    assert b2.global_step == every
    assert b2._cache_epoch == (1 if every == 6 else 0)
    assert b2.train_steps(13 - every) == la[every:]
    _assert_same_state(a, b2)
    assert b.cache_meter.refills + b2.cache_meter.refills == \
        a.cache_meter.refills > 0


def test_fit_resumes_between_epochs(tiny_t, tmp_path):
    d = str(tmp_path)
    full = _trainer(tiny_t).fit()
    first = _trainer(tiny_t, d=d, tcfg=TrainConfig(batch_size=B,
                                                   max_epochs=1)).fit()
    assert len(first.history) == 1
    b = _trainer(tiny_t, d=d)
    assert b._fit_state["epoch"] == 1 and b.global_step == 6
    rest = b.fit()
    assert [h.val_loss for h in rest.history] == \
        [h.val_loss for h in full.history[1:]]
    assert (rest.val_acc, rest.test_acc, rest.epochs_to_converge) == \
        (full.val_acc, full.test_acc, full.epochs_to_converge)


def test_fit_resumes_a_finished_early_stopped_run(tiny_t, tmp_path):
    """A checkpoint of an early-stopped fit trains no further: the resumed
    fit returns the best weights' test accuracy and runs no epoch."""
    d = str(tmp_path)
    tcfg = TrainConfig(batch_size=B, max_epochs=8, learning_rate=0.3,
                       early_stop_patience=1)
    done = _trainer(tiny_t, d=d, tcfg=tcfg).fit()
    assert len(done.history) < tcfg.max_epochs          # stopped early
    b = _trainer(tiny_t, d=d, tcfg=tcfg)
    step = b.global_step
    again = b.fit()
    assert again.history == [] and b.global_step == step
    assert again.test_acc == done.test_acc
    assert again.epochs_to_converge == done.epochs_to_converge


def test_jax_checkpoint_continues_in_the_port(tiny_graph, tiny_t, tmp_path):
    """The reference's jitted step takes 3 steps on its own batches; its
    state is saved with `repro.train.checkpoint`; the port restores it and
    both continue 5 steps on the same (converted) batches."""
    g = tiny_graph
    cfg_j = GNNConfigJ("t", "sage", 2, 32, g.feat_dim, g.num_classes,
                       fanout=FANOUTS, dropout=0.0, agg_impl="jnp")
    step_j, _ = _make_steps(cfg_j, TrainConfigJ(batch_size=B))
    params = init_gnn_j(cfg_j, jax.random.key(0))
    opt = adamw_j.init(params)
    skips = jnp.zeros((), jnp.int32)
    gj = DeviceGraphJ.from_graph(g)
    stream = iter(BatchStreamJ(g, make_policy_j("comm_rand"), B, FANOUTS,
                               CAPS, seed=0, device_graph=gj))
    feats = jnp.asarray(g.features)
    lr = 1e-3

    def step(params, opt, skips, jb):
        params, opt, loss, ok, skips, *_ = step_j(
            params, opt, jb, feats, gj.degrees, lr, jax.random.key(0), None,
            1.0, skips)
        assert bool(ok)
        return params, opt, skips, float(loss)

    for _ in range(3):
        params, opt, skips, _ = step(params, opt, skips, next(stream))
    d = str(tmp_path)
    ckpt_j.save(d, 3, {"params": params, "opt": opt, "best": params},
                extra={"cursor": {"epoch": 0, "pos": 3}, "fit": None,
                       "cache_epoch": 0})
    tr = _trainer(tiny_t, d=d, dropout=0.0)
    assert tr.global_step == 3 and int(tr.opt_state["count"]) == 3
    want, got = [], []
    for _ in range(5):
        jb = next(stream)
        params, opt, skips, loss = step(params, opt, skips, jb)
        want.append(loss)
        got.append(float(tr.train_step(torch_batch(jb), lr)[0]))
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# the guard and the fault sites
# ---------------------------------------------------------------------------
def run_steps_tracked(tr: GNNTrainer, n: int) -> dict:
    """Advance `tr` to global step `n` one `train_steps(1)` at a time,
    keeping the loss each step finally settled on: a rollback rewinds
    `global_step`, and the replayed steps overwrite their entries."""
    losses, iters = {}, 0
    while tr.global_step < n:
        prev = tr.global_step
        (loss,) = tr.train_steps(1)
        if tr.global_step == prev + 1:
            losses[tr.global_step] = loss
        iters += 1
        assert iters <= 8 * n + 16, f"stuck at step {tr.global_step}"
    return losses


def test_as_guard_normalization():
    assert as_guard(None) is None and as_guard(False) is None
    assert as_guard(True) == GuardConfig()
    g = GuardConfig(max_consecutive_skips=1, check_every=2)
    assert as_guard(g) is g
    with pytest.raises(TypeError):
        as_guard("yes")
    with pytest.raises(ValueError):
        GuardConfig(max_consecutive_skips=-1)


def test_skip_budget_without_ckpt_raises_stepfailure(tiny_t):
    """Escalation with no ckpt_dir cannot roll back: it fails loudly."""
    tr = _trainer(tiny_t, guard=GuardConfig(max_consecutive_skips=1,
                                            check_every=1))
    plan = FaultPlan(specs=(FaultSpec("step_nonfinite", 0, 2),))
    with faults.inject(plan), pytest.raises(StepFailure,
                                            match="no ckpt_dir"):
        tr.train_steps(3)
    assert tr.guard_meter.rollbacks == 1
    assert tr.guard_meter.skipped_steps == 2


GUARD = GuardConfig(max_consecutive_skips=1)
N = 14


@pytest.fixture(scope="module")
def clean_run(tiny_t):
    tr = _trainer(tiny_t, cache="dynamic", guard=GUARD)
    return run_steps_tracked(tr, N), tr


def test_nonfinite_burst_rolls_back_once(tiny_t, tmp_path, clean_run):
    """Steps 6 and 7 poisoned: the forced guard read before step 8's
    checkpoint sees 2 > 1 skips and rolls back to step 4; the replay is
    clean and bit-identical to the fault-free run."""
    ref_losses, ref = clean_run
    tr = _trainer(tiny_t, cache="dynamic", d=str(tmp_path), every=4,
                  guard=GUARD)
    plan = FaultPlan(specs=(FaultSpec("step_nonfinite", 6, 2),))
    with faults.inject(plan):
        losses = run_steps_tracked(tr, N)
    assert len(plan.fired("step_nonfinite")) == 2
    assert tr.guard_meter.rollbacks == 1
    assert tr.guard_meter.skipped_steps == 2
    assert losses == ref_losses
    _assert_same_state(ref, tr)


def test_ckpt_truncate_is_absorbed_by_restore_latest(tiny_t, tmp_path,
                                                     clean_run):
    """The second save (step 8) is damaged; the run "crashes" at step 10
    while it is the newest checkpoint; the next trainer falls back to
    step 4 (metered) and replays onto the fault-free trajectory."""
    ref_losses, ref = clean_run
    d = str(tmp_path)
    plan = FaultPlan(specs=(FaultSpec("ckpt_truncate", 1),))
    with faults.inject(plan):
        tr = _trainer(tiny_t, cache="dynamic", d=d, every=4, guard=GUARD)
        losses = run_steps_tracked(tr, 10)
        assert plan.fired("ckpt_truncate")[0]["step"] == 8
        with pytest.warns(RuntimeWarning, match="corrupt checkpoint"):
            tr = _trainer(tiny_t, cache="dynamic", d=d, every=4,
                          guard=GUARD)
        assert tr.global_step == 4
        assert tr.guard_meter.ckpt_fallbacks == 1
        losses.update(run_steps_tracked(tr, N))
    assert losses == ref_losses
    _assert_same_state(ref, tr)


def test_cache_corrupt_degrades_with_the_trajectory_unchanged(tiny_t):
    plain = _trainer(tiny_t).train_steps(10)
    tr = _trainer(tiny_t, cache="dynamic")
    plan = FaultPlan(specs=(FaultSpec("cache_corrupt", 0),))
    with faults.inject(plan):
        got = tr.train_steps(10)
    assert plan.fired("cache_corrupt")
    assert tr.cache is None and tr.stream.cache is None
    assert tr.guard_meter.cache_degradations == 1
    assert tr.cache_meter.degraded_at == 6
    assert got == plain


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_seeded_plan_draws_the_reference_windows(seed):
    windows = {"batch_build": (6, 14), "step_nonfinite": (6, 12),
               "ckpt_truncate": (1, 1), "cache_corrupt": (0, 5)}
    counts = {"step_nonfinite": 3}
    got = FaultPlan.seeded(seed, windows, counts)
    want = FaultPlanJ.seeded(seed, windows, counts)
    assert [(s.site, s.start, s.count) for s in got.specs] == \
        [(s.site, s.start, s.count) for s in want.specs]
    for s, t in zip(got.specs, want.specs):
        assert got.payload_rng(s).integers(1 << 30, size=4).tolist() == \
            want.payload_rng(t).integers(1 << 30, size=4).tolist()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_resumes_from_its_checkpoint(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "graphsage", "--dataset", "tiny", "--device", "cpu", "--epochs",
           "1", "--batch", "256", "--hidden", "16", "--layers", "2",
           "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "4",
           "--cache", "dynamic", "--caps-cache", str(tmp_path / "caps.json")]
    outs = [subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300) for _ in range(2)]
    for out in outs:
        assert out.returncode == 0, out.stderr
    assert "resumed" not in outs[0].stdout
    assert "resumed at step 6 (cursor: {'epoch': 1, 'pos': 0})" in \
        outs[1].stdout
    assert "epoch   0" in outs[0].stdout and "epoch   0" not in \
        outs[1].stdout
