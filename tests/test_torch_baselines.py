"""The prior-work baselines (`repro_torch.train.baselines`,
`repro_torch.models.gnn.fullgraph`) held against the JAX reference on the
CPU, at the tiny graph's size: ClusterGCN's unions and the induced
subgraphs exactly equal (the vectorised pass against the reference's
per-node loop, truncation at `cap_n` and `cap_e` included); the virtual
rows listing each destination's edges in order;
`sage_subgraph_apply` logits and gradients within 1e-5 of the reference's
`segment_sum` aggregation; 5 baseline steps from imported parameters at
dropout 0, and `train_clustergcn` / `train_fullbatch`, within 1e-4;
relaunches bit-identical; `labor_lite_epoch_footprint` equal; and the
reference's own properties (unions cover the graph, induced edges are
real, ClusterGCN learns, full batch steps once an epoch)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as GNNConfigJ
from repro.configs.base import TrainConfig as TrainConfigJ
from repro.core import partition as partition_j
from repro.configs.base import CommRandPolicy as CommRandPolicyJ
from repro.models.gnn.fullgraph import sage_subgraph_apply as apply_j
from repro.models.gnn.models import init_gnn as init_gnn_j
from repro.optim import adamw as adamw_j
from repro.train import baselines as base_j
from repro.train.losses import gnn_softmax_ce as ce_j
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core.minibatch import build_batch_np
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic
from repro_torch.models.gnn.fullgraph import (neighbor_chunks,
                                              sage_subgraph_apply)
from repro_torch.models.gnn.models import params_from_jax
from repro_torch.train import baselines
from repro_torch.train.baselines import (SubgraphTrainer, clustergcn_batches,
                                         clustergcn_caps, induced_subgraph,
                                         labor_lite_epoch_footprint,
                                         train_clustergcn, train_fullbatch)
from repro_torch.train.losses import gnn_softmax_ce

CPU = "cpu"
FIELDS = ("nodes", "node_mask", "edge_src", "edge_dst", "edge_mask",
          "labels", "loss_mask")


@pytest.fixture(scope="module")
def tiny_t():
    return prepare(synthetic.load("tiny"), oracle=True)


def _cfgs(g, dropout=0.0, layers=2):
    args = ("sage-b", "sage", layers, 32, g.feat_dim, g.num_classes)
    return (GNNConfigJ(*args, fanout=(5,) * layers, dropout=dropout),
            GNNConfig(*args, fanout=(5,) * layers, dropout=dropout))


def _part(g, ppb=2, seed=0, i=0):
    return clustergcn_batches(g, ppb, np.random.default_rng((seed, 0)))[i]


# ---------------------------------------------------------------------------
# unions and induced subgraphs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ppb", [1, 2, 3])
def test_clustergcn_batches_equal_and_cover_graph(tiny_graph, tiny_t, ppb):
    rng, rng_j = (np.random.default_rng((4, 0)) for _ in "ab")
    for _ in range(2):                          # two epochs of one stream
        got = clustergcn_batches(tiny_t, ppb, rng)
        want = base_j.clustergcn_batches(tiny_graph, ppb, rng_j)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert len(np.unique(np.concatenate(got))) == tiny_t.num_nodes


CASES = {"part": lambda n, e: (n + 8, n * 40),
         "cap_e cuts": lambda n, e: (n + 8, e // 3),
         "cap_n cuts": lambda n, e: (n // 2, n * 40),
         "full graph": None, "no nodes": None}


@pytest.mark.parametrize("case", list(CASES))
def test_induced_subgraph_fields_equal(tiny_graph, tiny_t, case):
    if case == "full graph":
        nodes = np.arange(tiny_t.num_nodes)
        cap_n, cap_e = tiny_t.num_nodes + 1, tiny_t.num_edges + 1
    elif case == "no nodes":
        nodes, cap_n, cap_e = np.zeros(0, np.int64), 16, 32
    else:
        nodes = _part(tiny_t)
        cap_n, cap_e = CASES[case](len(nodes), tiny_t.num_edges
                                   * len(nodes) // tiny_t.num_nodes)
    got = induced_subgraph(tiny_t, nodes, cap_n, cap_e, CPU)
    want = base_j.induced_subgraph(tiny_graph, nodes, cap_n, cap_e)
    for f in FIELDS:
        a, b = getattr(got, f), np.array(getattr(want, f))
        assert a.dtype == torch.from_numpy(b).dtype, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    if case == "cap_e cuts":
        assert bool(got.edge_mask.all())        # the list was cut


@pytest.mark.parametrize("width", [1, 4, 32])
def test_neighbor_chunks_list_each_rows_edges_in_order(tiny_t, width):
    """Virtual rows of `width` slots: a destination's rows, concatenated,
    list its valid edges in list order; padding names the destination;
    owners non-decreasing; shares sum to 1 per destination with edges."""
    part = _part(tiny_t)
    b = induced_subgraph(tiny_t, part, len(part) + 8, len(part) * 40, CPU)
    es, ed = b.edge_src.numpy(), b.edge_dst.numpy()
    em = b.edge_mask.numpy()
    # an edge list in another order, masked slots among the valid ones
    perm = np.random.default_rng((width, 31)).permutation(len(es))
    nbr, nbr_mask, owner, share = neighbor_chunks(es[perm], ed[perm],
                                                  em[perm], len(part) + 8,
                                                  width)
    assert nbr.shape == nbr_mask.shape == (len(owner), width)
    assert (np.diff(owner) >= 0).all()
    deg = np.bincount(ed[em], minlength=len(part) + 8)
    np.testing.assert_array_equal(np.bincount(owner,
                                              minlength=len(deg)),
                                  -(-deg // width))
    for i in np.unique(owner):
        rows = owner == i
        got = nbr[rows][nbr_mask[rows]]
        want = es[perm][em[perm] & (ed[perm] == i)]
        np.testing.assert_array_equal(got, want)
        assert (nbr[rows][~nbr_mask[rows]] == i).all()
        assert abs(share[rows].sum() - 1) < 1e-6
    t2, m2, o2, s2 = neighbor_chunks(np.zeros(0), np.zeros(0),
                                     np.zeros(0, bool), 3, width)
    assert t2.shape == (0, width) and len(o2) == len(s2) == 0


# ---------------------------------------------------------------------------
# the model and the steps
# ---------------------------------------------------------------------------
def _batches(tiny_graph, tiny_t, nodes, cap_n, cap_e):
    return (base_j.induced_subgraph(tiny_graph, nodes, cap_n, cap_e),
            induced_subgraph(tiny_t, nodes, cap_n, cap_e, CPU))


@pytest.mark.parametrize("layers,full", [(2, False), (3, False), (2, True)])
def test_sage_subgraph_apply_matches_reference(tiny_graph, tiny_t, layers,
                                               full):
    cfg_j, cfg = _cfgs(tiny_t, layers=layers)
    tree = init_gnn_j(cfg_j, jax.random.key(layers))
    params = params_from_jax(jax.tree.map(np.asarray, tree))
    if full:
        nodes = np.arange(tiny_t.num_nodes)
        caps = (tiny_t.num_nodes + 1, tiny_t.num_edges + 1)
    else:
        nodes = _part(tiny_t, seed=layers)
        caps = clustergcn_caps(tiny_t, 2)
    bj, bt = _batches(tiny_graph, tiny_t, nodes, *caps)
    n = tiny_t.num_nodes
    xj = jnp.asarray(tiny_graph.features)[jnp.minimum(bj.nodes, n - 1)]
    xt = torch.as_tensor(tiny_t.features)[torch.clamp(bt.nodes.long(),
                                                       max=n - 1)]
    want = np.asarray(apply_j(cfg_j, tree, bj, xj))
    got = sage_subgraph_apply(cfg, params, bt, xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)

    def loss_j(p):
        return ce_j(apply_j(cfg_j, p, bj, xj), bj.labels,
                    bj.loss_mask.astype(jnp.float32))
    g_j = jax.grad(loss_j)(tree)
    loss = gnn_softmax_ce(got, bt.labels, bt.loss_mask.to(torch.float32))
    grads = torch.autograd.grad(loss, list(params.parameters()))
    want_g = [np.asarray(layer[k]) for layer in g_j["layers"]
              for k in ("w_self", "w_neigh", "b")]
    for a, b in zip(grads, want_g):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


def test_subgraph_apply_is_sage_only(tiny_t):
    _, cfg = _cfgs(tiny_t)
    part = _part(tiny_t)
    b = induced_subgraph(tiny_t, part, len(part), len(part) * 40, CPU)
    with pytest.raises(ValueError, match="SAGE"):
        sage_subgraph_apply(dataclasses.replace(cfg, model="gcn"), None, b,
                            None)


def _reference_steps(tiny_graph, cfg_j, tree, batches, tcfg):
    feats = jnp.asarray(tiny_graph.features)
    opt, losses = adamw_j.init(tree), []
    for bj in batches:
        def loss_fn(p):
            x = feats[jnp.minimum(bj.nodes, feats.shape[0] - 1)]
            return ce_j(apply_j(cfg_j, p, bj, x), bj.labels,
                        bj.loss_mask.astype(jnp.float32))
        loss, grads = jax.value_and_grad(loss_fn)(tree)
        tree, opt = adamw_j.update(grads, opt, tree, lr=tcfg.learning_rate,
                                   weight_decay=tcfg.weight_decay)
        losses.append(float(loss))
    return losses, tree


@pytest.mark.parametrize("kind", ["clustergcn", "fullbatch"])
def test_five_baseline_steps_match_reference(tiny_graph, tiny_t, kind):
    """5 AdamW steps from the reference's initial parameters at dropout 0:
    ClusterGCN over one epoch's first parts, full batch on the whole
    graph; losses and final weights within 1e-4."""
    cfg_j, cfg = _cfgs(tiny_t)
    tcfg = TrainConfig()
    tree = init_gnn_j(cfg_j, jax.random.key(0))
    if kind == "clustergcn":
        parts = clustergcn_batches(tiny_t, 1, np.random.default_rng((0, 0)))
        caps = clustergcn_caps(tiny_t, 1)
        nodes = [parts[i % len(parts)] for i in range(5)]
    else:
        caps = (tiny_t.num_nodes + 1, tiny_t.num_edges + 1)
        nodes = [np.arange(tiny_t.num_nodes)] * 5
    pairs = [_batches(tiny_graph, tiny_t, n, *caps) for n in nodes]
    want, tree_end = _reference_steps(tiny_graph, cfg_j, tree,
                                      [p[0] for p in pairs], tcfg)
    tr = SubgraphTrainer(tiny_t, cfg, tcfg, device=CPU)
    tr.params = params_from_jax(jax.tree.map(np.asarray, tree))
    got = [float(tr.step(bt, 0, j)) for j, (_, bt) in enumerate(pairs)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    end = params_from_jax(jax.tree.map(np.asarray, tree_end))
    for a, b in zip(tr.params.parameters(), end.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.fixture
def imported_init(monkeypatch):
    """Both packages' trainers start from the reference's parameters."""
    def init(cfg, gen, device=None):
        cfg_j = GNNConfigJ(cfg.name, cfg.model, cfg.num_layers,
                           cfg.hidden_dim, cfg.in_dim, cfg.num_classes,
                           fanout=cfg.fanout, dropout=cfg.dropout)
        tree = init_gnn_j(cfg_j, jax.random.key(int(gen.initial_seed())))
        return params_from_jax(jax.tree.map(np.asarray, tree), device)
    monkeypatch.setattr(baselines, "init_gnn", init)


def test_train_clustergcn_matches_reference(tiny_graph, tiny_t,
                                            imported_init):
    cfg_j, cfg = _cfgs(tiny_t)
    want = base_j.train_clustergcn(tiny_graph, cfg_j, TrainConfigJ(),
                                   parts_per_batch=2, seed=1, epochs=2)
    got = train_clustergcn(tiny_t, cfg, TrainConfig(), parts_per_batch=2,
                           seed=1, epochs=2, device=CPU)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["val_acc"], want["val_acc"], atol=1e-4)


def test_train_fullbatch_matches_reference(tiny_graph, tiny_t,
                                           imported_init):
    cfg_j, cfg = _cfgs(tiny_t)
    want = base_j.train_fullbatch(tiny_graph, cfg_j, TrainConfigJ(),
                                  seed=2, epochs=5)
    got = train_fullbatch(tiny_t, cfg, TrainConfig(), seed=2, epochs=5,
                          device=CPU)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["val_acc_curve"], want["val_acc_curve"],
                               atol=1e-4)


@pytest.mark.parametrize("trainer", ["clustergcn", "fullbatch"])
def test_baseline_relaunch_is_bit_identical(tiny_t, trainer):
    """Dropout on: two runs from one seed give the same losses and
    accuracies (the dropout generators are the cursor's)."""
    _, cfg = _cfgs(tiny_t, dropout=0.5)
    fn = train_clustergcn if trainer == "clustergcn" else train_fullbatch
    a, b = (fn(tiny_t, cfg, TrainConfig(), seed=3, epochs=2, device=CPU)
            for _ in "ab")
    a.pop("per_epoch_time_s"), b.pop("per_epoch_time_s")
    assert a == b


def test_clustergcn_trains(tiny_t):
    _, cfg = _cfgs(tiny_t, dropout=0.5)
    r = train_clustergcn(tiny_t, cfg, TrainConfig(max_epochs=10),
                         parts_per_batch=2, epochs=10, device=CPU)
    assert np.isfinite(r["loss"])
    assert r["val_acc"] > 0.6


def test_fullbatch_trains_and_steps_once_per_epoch(tiny_t):
    _, cfg = _cfgs(tiny_t, dropout=0.5)
    r = train_fullbatch(tiny_t, cfg, TrainConfig(), epochs=4, device=CPU)
    assert len(r["val_acc_curve"]) == 4
    assert r["per_epoch_time_s"] > 0
    assert r["val_acc"] == r["val_acc_curve"][-1]


# ---------------------------------------------------------------------------
# LABOR-lite's footprint estimator
# ---------------------------------------------------------------------------
def test_labor_lite_footprint_equal_and_below_iid(tiny_graph, tiny_t):
    batches = partition_j.batches_for_epoch(
        tiny_graph.train_ids, tiny_graph.communities,
        CommRandPolicyJ("rand"), 256, np.random.default_rng(0))[:3]
    for seed in (0, 4):
        got = labor_lite_epoch_footprint(tiny_t, batches, (5, 5), seed)
        assert got == base_j.labor_lite_epoch_footprint(
            tiny_graph, batches, (5, 5), seed)
    iid = np.mean([build_batch_np(np.random.default_rng(i), tiny_t, b,
                                  (5, 5), 0.5)[0][-1]
                   for i, b in enumerate(batches)])
    assert got < iid
