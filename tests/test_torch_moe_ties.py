"""The MoE router's top-k in the port (`repro_torch.models.lm.moe.top_k`)
picks among equal probabilities as the reference's `jax.lax.top_k` does:
values descending, the lower expert first. A tie across the K-th place
decides a token's expert set, and with it the layer's output, its
capacity drops and the aux loss, so the port is held to the reference on
inputs built to tie: rows of equal values on their own, and a router
with two identical columns inside `moe_ffn` (its output, aux loss,
occupied rows and gradients) and the dense oracle `moe_ref`. Inputs are
drawn with numpy and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config
from repro.models.lm import moe as jax_moe
from repro_torch.models.lm import moe
from test_torch_lm_train import _close
from test_torch_moe import _reference_route, moe_params, port_config

ARCH = "qwen2-moe-a2.7b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(E, K):
    """float32 rows that tie: all equal; a tie inside the top K; a tie
    across the K-th place; zeros (underflowed probabilities) tied past
    the few non-zero values; a tie at the top across all of the top K."""
    rng = np.random.default_rng((E, K))
    base = rng.permutation(np.linspace(0.01, 0.5, E)).astype(np.float32)
    inside, across, top = base.copy(), base.copy(), base.copy()
    order = np.argsort(-base, kind="stable")
    inside[order[1]] = inside[order[0]]                  # places 1 and 2
    across[order[K]] = across[order[K - 1]]              # places K and K + 1
    top[order[:K + 2]] = top[order[0]]                   # K + 2 at the top
    zeros = np.zeros(E, np.float32)
    zeros[[E - 1, E // 2]] = (0.75, 0.25)
    return np.stack([np.full(E, 1.0 / E, np.float32), inside, across, zeros,
                     top])


@pytest.mark.parametrize("E, K", [(60, 4), (8, 2), (64, 8), (2, 1)])
def test_top_k_picks_ties_as_jax_lax_top_k(E, K):
    """Indices and values equal to `jax.lax.top_k`'s, bit for bit, on rows
    that tie (an all-equal row gives experts 0 .. K - 1) and on a (2, 3,
    E) batch of values quantised to eighths (ties everywhere)."""
    rows = _rows(E, K)
    quant = (np.random.default_rng(E).integers(0, 8, (2, 3, E)) / 8.0) \
        .astype(np.float32)
    for probs in (rows, quant):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), K)
        got_v, got_i = moe.top_k(_t(probs), K)
        assert got_i.dtype == torch.int64 and got_v.dtype == torch.float32
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(moe.top_k(_t(rows), K)[1][0].numpy(),
                                  np.arange(K))


def test_top_k_gradient_matches_jax_vjp():
    """The values' gradient lands on the selected positions, once each,
    as `jax.vjp` of `jax.lax.top_k` puts it, ties included."""
    E, K = 60, 4
    probs = _rows(E, K)
    g = np.random.default_rng(3).normal(size=(probs.shape[0], K)) \
        .astype(np.float32)
    _, vjp = jax.vjp(lambda p: jax.lax.top_k(p, K)[0], jnp.asarray(probs))
    want, = vjp(jnp.asarray(g))
    tp = _t(probs).requires_grad_()
    (moe.top_k(tp, K)[0] * _t(g)).sum().backward()
    np.testing.assert_array_equal(tp.grad.numpy(), np.asarray(want))


def _tied_case(T, cf, seed=8, a=2, b=5):
    """Reduced qwen2-moe (E 8, top-2) whose router has columns a and b
    equal, so experts a and b get equal probabilities for every token;
    x unit normal (T, d)."""
    cfg = port_config(ARCH).scaled(capacity_factor=cf)
    jcfg = get_config(ARCH).reduced().scaled(capacity_factor=cf)
    p = moe_params(jcfg, seed)
    p["router"][:, b] = p["router"][:, a]
    x = np.random.default_rng((T, seed)).normal(
        size=(T, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, p, x, (a, b)


def _jax_topi(x, p, jcfg, monkeypatch):
    """The reference's probabilities and top-k ids in `moe_ffn`."""
    tops = []
    real = jax.lax.top_k

    def spy(v, k):
        tops.append((v, real(v, k)[1]))
        return real(v, k)
    monkeypatch.setattr(jax.lax, "top_k", spy)
    try:
        jax_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg)
    finally:
        monkeypatch.setattr(jax.lax, "top_k", real)
    return np.asarray(tops[0][0]), np.asarray(tops[0][1])


@pytest.mark.parametrize("T,cf", [(64, 1.25), (64, 0.5), (8192, 1.25)])
def test_moe_ffn_with_a_tie_across_the_kth_place_matches_the_reference(
        T, cf, monkeypatch):
    """Tied router columns put a tie across the K-th place for some tokens
    (their two tied experts split by it). The port picks the reference's
    experts for every token, hands the grouped matmuls the occupied rows
    the reference's own `route` keeps, and matches its output (rtol 1e-4
    / atol 1e-5), aux loss (rtol 1e-5) and, for an output and an aux
    gradient drawn with numpy, the gradients of x and every leaf (rtol
    1e-5) from `jax.vjp`: the tolerances of the untied tests."""
    cfg, jcfg, p, x, (a, b) = _tied_case(T, cf)
    probs, want_topi = _jax_topi(x, p, jcfg, monkeypatch)
    assert np.array_equal(probs[..., a], probs[..., b])
    split = np.isin(want_topi, [a, b]).sum(-1) == 1
    assert split.any()                    # a tie across the K-th place
    E, K, G = cfg.num_experts, cfg.top_k, moe.moe_group_count(T)
    Tg = T // G
    C = moe.moe_capacity(Tg, cfg)
    want_rows = np.zeros((E, G), np.int64)
    ref_route = _reference_route(E, C, K, Tg)
    for g in range(G):
        _, dest, keep = (np.asarray(t) for t in ref_route(
            jnp.asarray(want_topi[g], jnp.int32)))
        np.add.at(want_rows[:, g], dest[keep] // C, 1)

    rng = np.random.default_rng((T, 9))
    dy = rng.normal(size=(T, cfg.d_model)).astype(np.float32)
    daux = np.float32(0.75)

    @jax.jit
    def ref(xa, q, g, ga):
        out, vjp = jax.vjp(lambda xa, q: jax_moe.moe_ffn(xa, q, jcfg), xa, q)
        return out, vjp((g, ga))

    (want_y, want_aux), (want_dx, want_dp) = ref(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p), jnp.asarray(dy),
        jnp.asarray(daux))

    seen_topi, seen_rows = [], []
    real_route, real_gated = moe.route, moe.moe_gmm_gated

    def route_spy(topi, *args):
        seen_topi.append(topi.detach().clone())
        return real_route(topi, *args)

    def gated_spy(xe, wg, wu, rows=None):
        seen_rows.append(rows.clone())
        return real_gated(xe, wg, wu, rows=rows)
    monkeypatch.setattr(moe, "route", route_spy)
    monkeypatch.setattr(moe, "moe_gmm_gated", gated_spy)
    tx = _t(x).requires_grad_()
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    y, aux = moe.moe_ffn(tx, tp, cfg)
    ((y * _t(dy)).sum() + aux * float(daux)).backward()

    np.testing.assert_array_equal(seen_topi[0].numpy(), want_topi)
    np.testing.assert_array_equal(seen_rows[0].numpy(), want_rows)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    _close(tx.grad, want_dx, 1e-5)
    assert set(tp) == set(want_dp)
    for k, t in tp.items():
        _close(t.grad, want_dp[k], 1e-5)


def test_moe_ref_with_tied_router_columns_matches_the_reference_oracle():
    """The dense oracle routes through the same top-k: with tied router
    columns it equals the reference's `moe_ref` (rtol 1e-4 / atol 1e-5),
    and so does the drop-free `moe_ffn`."""
    cfg, jcfg, p, x, _ = _tied_case(64, 8.0)
    want = np.asarray(jax_moe.moe_ref(jnp.asarray(x),
                                      jax.tree.map(jnp.asarray, p), jcfg))
    tp = {k: _t(v) for k, v in p.items()}
    np.testing.assert_allclose(moe.moe_ref(_t(x), tp, cfg).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    got, _ = moe.moe_ffn(_t(x), tp, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
