"""Trainer parity and loops.

From the same parameters and the same (converted) batches, with dropout
off, the port's guarded train step follows the reference's jitted
`train_step` (20 steps of SAGE, 10 of GCN and of GAT) within rtol = 1e-4
on the loss: AdamW's
m / sqrt(v) amplifies the float32 rounding left by the matmuls' and the
aggregation's different summation orders. The loops (`train_steps`,
`run_epoch`, `evaluate`, `fit`) run on the CPU with finite, falling loss,
and a NaN-poisoned step changes nothing but the skip counter."""
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
from repro.train.gnn_loop import _make_steps
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic
from repro_torch.models.gnn.models import params_from_jax
from repro_torch.optim import adamw
from repro_torch.train.gnn_loop import GNNTrainer, train_once
from test_torch_batching import torch_batch

FANOUTS, CAPS, B = (5, 5), (768, 1152), 256


@pytest.fixture(scope="module")
def tiny_t():
    return prepare(synthetic.load("tiny"), oracle=True)


def _cfg(g, dropout=0.0, model="sage"):
    return GNNConfig("t", model, 2, 32, g.feat_dim, g.num_classes,
                     fanout=FANOUTS, dropout=dropout)


def _trainer(g, dropout=0.0, seed=0, max_epochs=2, model="sage"):
    return GNNTrainer(g, _cfg(g, dropout, model),
                      TrainConfig(batch_size=B, max_epochs=max_epochs),
                      "comm_rand", caps=CAPS, eval_caps=CAPS, seed=seed,
                      device="cpu")


def _trajectory(g, tiny_t, model, steps):
    """The reference's jitted step and the port's guarded step from the
    same parameters on the same batches: (port, reference) losses."""
    cfg_j = GNNConfigJ("t", model, 2, 32, g.feat_dim, g.num_classes,
                       fanout=FANOUTS, dropout=0.0, agg_impl="jnp")
    tcfg_j = TrainConfigJ(batch_size=B)
    step_j, _ = _make_steps(cfg_j, tcfg_j)
    params = init_gnn_j(cfg_j, jax.random.key(0))
    opt = adamw_j.init(params)
    skips = jnp.zeros((), jnp.int32)
    gj = DeviceGraphJ.from_graph(g)
    stream = iter(BatchStreamJ(g, make_policy_j("comm_rand"), B, FANOUTS,
                               CAPS, seed=0, device_graph=gj))
    feats = jnp.asarray(g.features)

    tr = _trainer(tiny_t, model=model)
    tr.params = params_from_jax(jax.tree.map(np.asarray, params),
                                device="cpu")
    tr.opt_state = adamw.init(list(tr.params.parameters()))
    lr = tcfg_j.learning_rate
    want, got = [], []
    for _ in range(steps):
        jb = next(stream)
        params, opt, loss, ok, skips, *_ = step_j(
            params, opt, jb, feats, gj.degrees, lr, jax.random.key(0), None,
            1.0, skips)
        want.append(float(loss))
        loss_t, ok_t = tr.train_step(torch_batch(jb), lr)
        got.append(float(loss_t))
        assert bool(ok) and bool(ok_t)
    assert int(tr.skips) == 0
    rel = np.abs(np.array(got) - want) / np.abs(want)
    print(f"{model}: max relative loss difference over {steps} steps: "
          f"{rel.max():.3e}")
    return got, want


def test_loss_trajectory_matches_reference(tiny_graph, tiny_t):
    got, want = _trajectory(tiny_graph, tiny_t, "sage", 20)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_gcn_gat_loss_trajectory_matches_reference(tiny_graph, tiny_t,
                                                   model):
    """GCN reads the trainer's degree array; GAT's attention gradient goes
    through the dw path. 10 steps within rtol = 1e-4, as for SAGE."""
    got, want = _trajectory(tiny_graph, tiny_t, model, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_loops_run_with_falling_loss(tiny_t):
    tr = _trainer(tiny_t, dropout=0.5)
    losses = tr.train_steps(24)
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < np.mean(losses[:6])
    assert tr.global_step == 24
    # 24 steps = 4 epochs of 6 batches; the cursor rests on the boundary
    assert tr.stream.cursor.state() == {"epoch": 3, "pos": 6}
    em = tr.run_epoch(tr.tcfg.learning_rate)
    assert np.isfinite(em["loss"]) and em["uniq"] > 0
    ev = tr.evaluate(tiny_t.val_ids)
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["acc"] <= 1.0


def test_fit_two_epochs(tiny_t):
    res = _trainer(tiny_t, dropout=0.5, seed=1).fit()
    h = res.history
    assert len(h) == 2
    assert all(np.isfinite([e.train_loss, e.val_loss]).all() for e in h)
    assert h[1].train_loss < h[0].train_loss
    assert h[1].val_loss < h[0].val_loss
    assert res.val_acc > 0.3 and res.caps == CAPS
    assert res.feature_bytes_per_batch == \
        res.mean_unique_nodes * tiny_t.feat_dim * 4


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_gcn_gat_train_and_evaluate(tiny_t, model):
    """The trainer's loops with dropout on, for the two new models."""
    tr = _trainer(tiny_t, dropout=0.5, model=model)
    losses = tr.train_steps(12)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    ev = tr.evaluate(tiny_t.val_ids)
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["acc"] <= 1.0


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_models_learn_the_labels(tiny_t, model):
    """Each model learns the task, not just a falling loss: after 60
    `rand` steps with dropout on, validation accuracy is at least twice
    chance (4 classes). GCN starts slowest: its degree normalisers shrink
    the early updates."""
    cfg = _cfg(tiny_t, dropout=0.5, model=model)
    tr = GNNTrainer(tiny_t, cfg, TrainConfig(batch_size=B, max_epochs=20),
                    "rand", caps=CAPS, eval_caps=CAPS, seed=0, device="cpu")
    tr.train_steps(60)
    assert tr.evaluate(tiny_t.val_ids)["acc"] >= 2.0 / tiny_t.num_classes


def test_trainer_refuses_an_unknown_model(tiny_t):
    with pytest.raises(ValueError, match="unknown model"):
        _trainer(tiny_t, model="gin")


def test_train_once_on_cpu(tiny_t):
    res = train_once(tiny_t, _cfg(tiny_t), "rand",
                     TrainConfig(batch_size=512, max_epochs=1),
                     device="cpu")
    assert len(res.history) == 1 and np.isfinite(res.test_acc)


def test_poisoned_step_changes_nothing_but_the_skip_counter(tiny_t):
    tr = _trainer(tiny_t)
    tr.train_steps(2)                       # non-trivial optimizer state
    batch = next(iter(tr.stream))
    before = ([p.detach().clone() for p in tr.params.parameters()],
              [t.clone() for t in tr.opt_state["m"] + tr.opt_state["v"]],
              tr.opt_state["count"].clone())
    loss, ok = tr.train_step(batch, 1e-3, poison=float("nan"))
    assert not bool(ok) and not torch.isfinite(loss)
    assert int(tr.skips) == 1
    for a, b in zip(before[0], tr.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(before[1], tr.opt_state["m"] + tr.opt_state["v"]):
        assert torch.equal(a, b)
    assert torch.equal(before[2], tr.opt_state["count"])
    tr.train_step(batch, 1e-3, poison=float("nan"))
    assert int(tr.skips) == 2               # consecutive skips
    _, ok = tr.train_step(batch, 1e-3)
    assert bool(ok) and int(tr.skips) == 0
    assert not torch.equal(before[0][0], tr.params.layers[0].w_self)
