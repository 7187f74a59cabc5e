"""Model parity (GraphSAGE, GCN, GAT): with the reference's parameters
carried across (`params_from_jax`) and the reference's batch converted,
the port's `apply_gnn` gives the same logits and the same gradient for
every parameter, against the reference run through the Pallas kernels
(interpret mode) and through jnp. Tolerance rtol = 1e-5, atol = 1e-6: the
matmuls and the aggregation sum in another order."""
import importlib
from dataclasses import asdict, fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as GNNConfigJ
from repro.core import minibatch as mb_j
from repro.graphs.csr import DeviceGraph as DeviceGraphJ
from repro.models.gnn.models import apply_gnn as apply_gnn_j
from repro.models.gnn.models import init_gnn as init_gnn_j
from repro.train.losses import gnn_softmax_ce as ce_j
from repro_torch.configs import CONFIGS, GNNConfig
from repro_torch.models.gnn.models import (apply_gnn, init_gnn,
                                           params_from_jax, params_to_jax)
from repro_torch.train.losses import gnn_softmax_ce
from test_torch_batching import torch_batch

FANOUTS, CAPS = (5, 5), (768, 1152)
# GCN / GAT: a smaller tower (64 roots, fanout 4), since the reference's
# interpret-mode dw kernel walks an (n_dst * heads, fanout) grid
SMALL_FANOUTS, SMALL_CAPS = (4, 4), (256, 768)


@pytest.fixture(scope="module")
def setup(tiny_graph):
    g = tiny_graph
    gj = DeviceGraphJ.from_graph(g)
    roots = np.full(256, -1, np.int64)
    roots[:240] = g.train_ids[100:340]
    jb = mb_j.build_batch(jax.random.key(5), gj,
                          jnp.asarray(roots, jnp.int32),
                          jnp.asarray(g.labels), FANOUTS, CAPS, 1.0)
    return g, jb


@pytest.fixture(scope="module")
def small(tiny_graph):
    g = tiny_graph
    gj = DeviceGraphJ.from_graph(g)
    roots = np.full(64, -1, np.int64)
    roots[:60] = g.train_ids[200:260]
    jb = mb_j.build_batch(jax.random.key(7), gj,
                          jnp.asarray(roots, jnp.int32),
                          jnp.asarray(g.labels), SMALL_FANOUTS, SMALL_CAPS,
                          1.0)
    return g, jb, gj.degrees


def _cfgs(g, impl, model="sage", fanout=FANOUTS):
    """2 layers, hidden 32. GAT takes hidden 30 in 3 heads of 10, so that
    layer 0 has no `w_out` (H * dh == dout) and the class layer (4 classes,
    3 heads of 1) has one."""
    kw = dict(name="t", model=model, num_layers=2, hidden_dim=32,
              in_dim=g.feat_dim, num_classes=g.num_classes, fanout=fanout,
              dropout=0.0)
    if model == "gat":
        kw.update(hidden_dim=30, gat_heads=3)
    return GNNConfigJ(**kw, agg_impl=impl), GNNConfig(**kw)


@pytest.mark.parametrize("feats_global", [True, False])
@pytest.mark.parametrize("impl", ["pallas", "jnp"])
def test_logits_and_grads_match(setup, impl, feats_global):
    g, jb = setup
    cfg_j, cfg = _cfgs(g, impl)
    params = init_gnn_j(cfg_j, jax.random.key(0))
    feats = jnp.asarray(g.features)
    x_j = feats if feats_global else \
        feats[jnp.minimum(jb.node_ids, g.num_nodes - 1)]

    def loss_j(p):
        logits = apply_gnn_j(cfg_j, p, jb, x_j, feats_global=feats_global)
        return ce_j(logits, jb.labels,
                    jb.label_mask.astype(jnp.float32)), logits

    (_, logits_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)

    model = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tb = torch_batch(jb)
    x = torch.as_tensor(np.array(x_j))
    logits = apply_gnn(cfg, model, tb, x, feats_global=feats_global)
    gnn_softmax_ce(logits, tb.labels,
                   tb.label_mask.to(torch.float32)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-6)
    for i, layer in enumerate(model.layers):
        for k in ("w_self", "w_neigh", "b"):
            np.testing.assert_allclose(
                getattr(layer, k).grad.numpy(),
                np.asarray(grads_j["layers"][i][k]), rtol=1e-5, atol=1e-6,
                err_msg=f"layers[{i}].{k}")


@pytest.mark.parametrize("feats_global", [True, False])
@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_gcn_gat_logits_and_grads_match(small, model, impl, feats_global):
    """Every gradient leaf, GAT's `a_src`, `a_dst` and `w_out` included;
    the reference's GAT takes its head-folded `gather_agg` path under
    "pallas" and an einsum under "jnp", the port always the folded one."""
    g, jb, deg_j = small
    cfg_j, cfg = _cfgs(g, impl, model, SMALL_FANOUTS)
    params = init_gnn_j(cfg_j, jax.random.key(3))
    feats = jnp.asarray(g.features)
    x_j = feats if feats_global else \
        feats[jnp.minimum(jb.node_ids, g.num_nodes - 1)]

    def loss_j(p):
        logits = apply_gnn_j(cfg_j, p, jb, x_j, deg_j,
                             feats_global=feats_global)
        return ce_j(logits, jb.labels,
                    jb.label_mask.astype(jnp.float32)), logits

    (_, logits_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)

    model_t = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tb = torch_batch(jb)
    logits = apply_gnn(cfg, model_t, tb, torch.as_tensor(np.array(x_j)),
                       torch.as_tensor(np.array(deg_j)),
                       feats_global=feats_global)
    gnn_softmax_ce(logits, tb.labels,
                   tb.label_mask.to(torch.float32)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-6)
    checked = 0
    for i, layer in enumerate(model_t.layers):
        for k, want in grads_j["layers"][i].items():
            got = getattr(layer, k)
            if want is None:
                assert got is None, f"layers[{i}].{k}"
                continue
            np.testing.assert_allclose(
                got.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6,
                err_msg=f"layers[{i}].{k}")
            checked += 1
    assert checked == len(jax.tree.leaves(grads_j))
    if model == "gat":
        assert [layer.w_out is None for layer in model_t.layers] == \
            [True, False]


def test_gcn_needs_degrees(small):
    g, jb, _ = small
    _, cfg = _cfgs(g, "jnp", "gcn", SMALL_FANOUTS)
    model = init_gnn(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="degrees"):
        apply_gnn(cfg, model, torch_batch(jb),
                  torch.as_tensor(g.features), feats_global=True)


def test_params_round_trip(setup):
    g, _ = setup
    cfg_j, cfg = _cfgs(g, "jnp")
    tree = jax.tree.map(np.asarray, init_gnn_j(cfg_j, jax.random.key(1)))
    back = params_to_jax(params_from_jax(tree))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    # the port's own init has the reference's layout (din, dout)
    own = params_to_jax(init_gnn(cfg, torch.Generator().manual_seed(0)))
    assert jax.tree.map(np.shape, own) == jax.tree.map(np.shape, tree)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_gcn_gat_params_round_trip(setup, model):
    """GAT's tree keeps a `w_out: None` where H * dh == dout (layer 0) and a
    live `w_out` where it does not (the class layer)."""
    g, _ = setup
    cfg_j, cfg = _cfgs(g, "jnp", model)
    tree = jax.tree.map(np.asarray, init_gnn_j(cfg_j, jax.random.key(2)))
    back = params_to_jax(params_from_jax(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    if model == "gat":
        assert [p["w_out"] is None for p in back["layers"]] == \
            [True, False]
    own = params_to_jax(init_gnn(cfg, torch.Generator().manual_seed(0)))
    assert jax.tree.map(np.shape, own) == jax.tree.map(np.shape, tree)


@pytest.mark.parametrize("name", ["graphsage", "gcn", "gat"])
def test_configs_match_reference(name):
    """The port's model configs carry the reference's values (the
    reference's `agg_impl` knob aside)."""
    ref = importlib.import_module(f"repro.configs.{name}").CONFIG
    want = {f.name: getattr(ref, f.name) for f in fields(ref)
            if f.name != "agg_impl"}
    assert asdict(CONFIGS[name]) == want
