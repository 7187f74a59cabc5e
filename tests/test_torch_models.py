"""GraphSAGE parity: with the reference's parameters carried across
(`params_from_jax`) and the reference's batch converted, the port's
`apply_gnn` gives the same logits and the same gradient for every
parameter, against the reference run through the Pallas kernels
(interpret mode) and through jnp. Tolerance rtol = 1e-5, atol = 1e-6: the
matmuls and the aggregation sum in another order."""
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
from repro_torch.configs import GNNConfig
from repro_torch.models.gnn.models import (apply_gnn, init_gnn,
                                           params_from_jax, params_to_jax)
from repro_torch.train.losses import gnn_softmax_ce
from test_torch_batching import torch_batch

FANOUTS, CAPS = (5, 5), (768, 1152)


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


def _cfgs(g, impl):
    kw = dict(name="t", model="sage", num_layers=2, hidden_dim=32,
              in_dim=g.feat_dim, num_classes=g.num_classes, fanout=FANOUTS,
              dropout=0.0)
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
