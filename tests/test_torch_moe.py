"""The port's MoE serving path (`repro_torch.kernels.moe_gmm`,
`repro_torch.models.lm.moe`, qwen2-moe-a2.7b through the transformer and
`generate`) against the JAX reference on the CPU.

The grouped matmul's plain version is held against the Pallas op in
interpret mode where its tiles divide the shapes and against the
reference's einsum oracle where they do not; routing (order, slot, keep,
dest) and the dispatch buffer equal the reference's element for element;
`moe_ffn` and the whole model agree in float32 within rtol 1e-4 /
atol 1e-5 (sums in another order), bfloat16 within the bound of
`test_torch_lm.py`. Inputs and parameters are drawn with numpy and handed
to both packages."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import get_config
from repro.dist import sharding as jax_shd
from repro.kernels.moe_gmm.ops import moe_gmm as jax_moe_gmm
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_moe_gmm_ref
from repro.models.lm import moe as jax_moe
from repro.models.lm import transformer as jax_tf
from repro_torch.configs import LM_CONFIGS, ModelConfig
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm.ops import moe_gmm, moe_gmm_gated
from repro_torch.kernels.moe_gmm.ref import moe_gmm_gated_ref, moe_gmm_ref
from repro_torch.launch import serve
from repro_torch.models.lm import moe, transformer
from test_torch_lm import (B, PROMPT, STEPS, _jax_serve, _torch_serve,
                           numpy_params, prompts)

QWEN = LM_CONFIGS["qwen2-moe-a2.7b"]
CFG = QWEN.reduced()
F32 = CFG.scaled(dtype="float32")


def port_config(arch):
    """The port's ModelConfig of a reference config, reduced."""
    return ModelConfig(**dataclasses.asdict(get_config(arch).reduced()))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a, np.float32)


def moe_params(cfg, seed):
    """One layer's MoE leaves in the reference's layout, drawn with numpy
    (LeCun-scaled over the second-to-last axis)."""
    rng = np.random.default_rng((seed, 19))
    shapes = jax.eval_shape(lambda k: jax_moe.init_moe(k, cfg),
                            jax.random.key(0))
    return {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[-2]))
            .astype(np.float32) for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# the grouped matmul's plain version
# ---------------------------------------------------------------------------
def _gmm_inputs(E, C, d, f, seed):
    """Unit-normal activations and LeCun-scaled expert weights, as the
    model holds them: outputs of order 1."""
    rng = np.random.default_rng((E, C, d, f, seed))
    return (rng.normal(size=(E, C, d)).astype(np.float32),
            (rng.normal(size=(E, d, f)) / np.sqrt(d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 128, 256), (1, 256, 256, 128)])
def test_plain_gmm_matches_the_pallas_op(shape, dtype):
    """Where the Pallas kernel's tiles divide the shapes: the port's op on
    CPU tensors against `repro.kernels.moe_gmm.ops.moe_gmm` in interpret
    mode, the same bf16 or float32 inputs; float32 outputs within
    rtol = atol = 1e-5 (float32 sums in another order)."""
    x, w = _gmm_inputs(*shape, 0)
    want = jax_moe_gmm(jnp.asarray(x).astype(dtype),
                       jnp.asarray(w).astype(dtype))
    got = moe_gmm(_t(x).to(getattr(torch, dtype)),
                  _t(w).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 8, 64, 32), (2, 344, 64, 32),
                                   (1, 344, 100, 7)])
def test_plain_gmm_takes_shapes_the_pallas_kernel_refuses(shape, dtype):
    """At the decode (C 8) and prefill (C 344) capacities, and at d, f that
    no tile divides: the Pallas kernel asserts (C 344 is not a multiple of
    its 128-row tile), the port's op matches the reference's einsum oracle
    within rtol = atol = 1e-5."""
    x, w = _gmm_inputs(*shape, 1)
    xj, wj = (jnp.asarray(a).astype(dtype) for a in (x, w))
    if shape[1] == 344:
        with pytest.raises(AssertionError):
            jax_moe_gmm(xj, wj)
    got = moe_gmm(_t(x).to(getattr(torch, dtype)),
                  _t(w).to(getattr(torch, dtype)))
    np.testing.assert_allclose(got.numpy(), _np(jax_moe_gmm_ref(xj, wj)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), moe_gmm_ref(_t(x).to(getattr(torch, dtype)),
                                 _t(w).to(getattr(torch, dtype))).numpy())


def test_cpu_tensors_count_no_launch_and_the_ops_train():
    """CPU tensors take the plain versions and count no launch, forward
    and backward: the ops' backward (no longer refused under grad) gives
    the gradients of `moe_gmm_ref` / `moe_gmm_gated_ref` through autograd
    within rtol = atol = 1e-5 (the backward's plain versions sum in
    another order), with and without grad mode."""
    x, w = (_t(a) for a in _gmm_inputs(2, 8, 16, 8, 2))
    wu = w.flip(2).contiguous()
    before = (dict(gmm_kernel.LAUNCHES), dict(gmm_kernel.ROUTES))
    gmm_kernel.moe_gmm_fwd(x, w)
    moe_gmm(x, w)
    moe_gmm_gated(x, w, w)
    with torch.no_grad():
        moe_gmm(x, w)
    g = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 8, 8)),
                        dtype=torch.float32)
    for op, plain, ws in ((moe_gmm, moe_gmm_ref, (w,)),
                          (moe_gmm_gated, moe_gmm_gated_ref, (w, wu))):
        got = [t.clone().requires_grad_() for t in (x, *ws)]
        want = [t.clone().requires_grad_() for t in (x, *ws)]
        (op(*got) * g).sum().backward()
        (plain(*want) * g).sum().backward()
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                       rtol=1e-5, atol=1e-5)
    assert (gmm_kernel.LAUNCHES, gmm_kernel.ROUTES) == before


# ---------------------------------------------------------------------------
# the epilogues: output in the compute dtype, gated, rows
# ---------------------------------------------------------------------------
BF16_ULP = 2.0 ** -7          # bf16 keeps 8 significant bits


def _bf16_np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 64, 32), (3, 344, 40, 24)])
def test_plain_epilogues_match_the_reference_composite(shape, dtype):
    """`moe_gmm_ref(..., out_dtype=dt)` and `moe_gmm_gated_ref` against the
    reference's own expert math (`repro/models/lm/moe.py:125-126`):
    `jnp.einsum` in the compute dtype, then `jax.nn.silu(g) * u`, on the
    same inputs. float32 within rtol = atol = 1e-5 (sums in another
    order). bf16 within 2 bf16 ulps of each value (2 x 2^-7 |want|) plus
    2 ulps of the largest (2 x 2^-7 max |want|, for values that cancel):
    both round each product to bf16, but JAX sums in another order, so a
    product near a rounding boundary may round one ulp the other way,
    and its silu (x * sigmoid(x) in bf16) rounds at other points than
    PyTorch's x / (1 + exp(-x))."""
    E, C, d, f = shape
    x, wg = _gmm_inputs(E, C, d, f, 5)
    _, wu = _gmm_inputs(E, C, d, f, 6)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, gj, uj = (jnp.asarray(a).astype(jdt) for a in (x, wg, wu))
    want_g = jnp.einsum("ecd,edf->ecf", xj, gj)
    want_h = jax.nn.silu(want_g) * jnp.einsum("ecd,edf->ecf", xj, uj)
    assert want_h.dtype == jdt
    xt, gt, ut = (_t(a).to(tdt) for a in (x, wg, wu))
    got_g = moe_gmm_ref(xt, gt, tdt)
    got_h = moe_gmm_gated_ref(xt, gt, ut)
    assert got_g.dtype == got_h.dtype == tdt
    for got, want in ((got_g, want_g), (got_h, want_h)):
        got, want = _bf16_np(got), _np(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(
                got, want, rtol=2 * BF16_ULP,
                atol=2 * BF16_ULP * np.abs(want).max())
    # the gated op on CPU tensors is the plain composite, and the plain
    # output in the compute dtype is the float32 one rounded once
    assert torch.equal(moe_gmm_gated(xt, gt, ut), got_h)
    assert torch.equal(moe_gmm(xt, gt, out_dtype=tdt),
                       moe_gmm_ref(xt, gt).to(tdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_are_a_no_op_for_the_plain_versions(dtype):
    """On CPU tensors `rows` is checked and then ignored: the outputs with
    it equal those without, bit for bit, for each op and epilogue."""
    E, C, d, f, G = 4, 24, 16, 8, 2
    x, wg = (_t(a).to(getattr(torch, dtype)) for a in
             _gmm_inputs(E, C, d, f, 7))
    wu = wg.flip(0).contiguous()
    rows = torch.tensor([[0, 0], [3, 12], [12, 1], [5, 7]],
                        dtype=torch.int32)
    for kw in ({}, {"out_dtype": x.dtype}):
        assert torch.equal(gmm_kernel.moe_gmm_fwd(x, wg, rows=rows, **kw),
                           gmm_kernel.moe_gmm_fwd(x, wg, **kw))
    assert torch.equal(gmm_kernel.moe_gmm_gated_fwd(x, wg, wu, rows=rows),
                       gmm_kernel.moe_gmm_gated_fwd(x, wg, wu))


def test_the_wrapper_refuses_rows_it_cannot_read():
    """Wrong shape, dtype or device, or a group count that does not divide
    C: refused before dispatch (so here, on the CPU path, too), by both
    ops; and an out_dtype other than float32 or x's."""
    x, w = (_t(a) for a in _gmm_inputs(4, 24, 16, 8, 8))
    ok = torch.zeros((4, 2), dtype=torch.int32)
    bad = [(ok[:3], ValueError), (ok[:, :0], ValueError),
           (ok[:, 0], ValueError), (ok[None], ValueError),
           (ok.long(), TypeError), (ok.float(), TypeError),
           (torch.zeros((4, 5), dtype=torch.int32), ValueError),
           (torch.zeros((2, 4), dtype=torch.int32).T, ValueError),
           (ok.to("meta"), ValueError)]
    for rows, err in bad:
        with pytest.raises(err):
            gmm_kernel.moe_gmm_fwd(x, w, rows=rows)
        with pytest.raises(err):
            gmm_kernel.moe_gmm_gated_fwd(x, w, w, rows=rows)
    with pytest.raises(TypeError):
        gmm_kernel.moe_gmm_fwd(x, w, out_dtype=torch.bfloat16)
    gmm_kernel.moe_gmm_fwd(x, w, rows=ok)
    gmm_kernel.moe_gmm_gated_fwd(x, w, w, rows=torch.zeros(
        (4, 24), dtype=torch.int32))


def test_route_picks_by_dtype_shape_and_alignment():
    """`kernel.route` (read from shapes and pointers, so it answers for CPU
    tensors too): float32 -> simt; bf16 -> tensor_core for 16 < C <= 4096,
    E <= 256, d and f multiples of 8 and 16-byte aligned starts, else
    mma_sync."""
    def bf(*shape, offset=0):
        return torch.zeros(int(np.prod(shape)) + offset,
                           dtype=torch.bfloat16)[offset:].view(shape)

    assert gmm_kernel.route(bf(2, 17, 16).float(), bf(2, 16, 8).float()) \
        == "simt"
    assert gmm_kernel.route(bf(2, 17, 16), bf(2, 16, 8)) == "tensor_core"
    assert gmm_kernel.route(bf(2, 17, 16), bf(2, 16, 8),
                            bf(2, 16, 8)) == "tensor_core"
    assert gmm_kernel.route(bf(60, 688, 2048), bf(60, 2048, 1408)) == \
        "tensor_core"
    for x, w in ((bf(2, 16, 16), bf(2, 16, 8)),        # decode's C
                 (bf(2, 17, 12), bf(2, 12, 8)),        # d not of 8
                 (bf(2, 17, 16), bf(2, 16, 12)),       # f not of 8
                 (bf(257, 17, 16), bf(257, 16, 8)),    # E past 256
                 (bf(2, 4097, 16), bf(2, 16, 8)),      # C past 4096
                 (bf(2, 17, 16, offset=1), bf(2, 16, 8))):   # misaligned
        assert gmm_kernel.route(x, w) == "mma_sync"
    assert gmm_kernel.route(bf(2, 17, 16), bf(2, 16, 8),
                            bf(2, 16, 8, offset=1)) == "mma_sync"


# ---------------------------------------------------------------------------
# groups, capacity, routing, dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_group_count_and_capacity_equal_the_reference(arch):
    full = get_config(arch)
    for cfg in (full, full.reduced(), full.scaled(capacity_factor=0.5)):
        for T in (1, 4, 8, 64, 100, 4096, 4100, 8192, 3 * 4096):
            G = moe.moe_group_count(T)
            assert G == jax_moe.moe_group_count(T)
            assert moe.moe_capacity(T // G, cfg) == \
                jax_moe.moe_capacity(T // G, cfg)
    # qwen2-moe-a2.7b's serving shapes: prefill 4 x 2048, decode batch 4
    assert moe.moe_group_count(8192) == 2
    assert moe.moe_capacity(4096, QWEN) == 344
    assert moe.moe_capacity(4, QWEN) == 8


def _reference_route(E, C, K, Tg):
    """The reference's own `route`, the closure inside `moe_ffn`
    (`repro/models/lm/moe.py:90-98`), rebuilt from its code object over
    cells holding E, C, K and T_g."""
    code = next(c for c in jax_moe.moe_ffn.__code__.co_consts
                if getattr(c, "co_name", None) == "route")
    env = {"C": C, "E": E, "K": K, "Tg": Tg}
    cells = tuple(types.CellType(env[n]) for n in code.co_freevars)
    return types.FunctionType(code, vars(jax_moe), "route", None, cells)


def _topi(rng, G, Tg, K, E, skew):
    """K distinct experts per token; `skew` > 0 crowds the low ids."""
    scores = rng.random((G, Tg, E)) + skew * np.linspace(1, 0, E)
    return np.argsort(-scores, axis=-1)[..., :K].astype(np.int64)


@pytest.mark.parametrize("case", [(2, 64, 2, 8, 32, 0.0),   # no drops
                                  (2, 64, 2, 8, 8, 2.0),    # skewed, drops
                                  (1, 40, 4, 60, 8, 0.5)])  # qwen's E, K
def test_route_equals_the_reference(case):
    G, Tg, K, E, C, skew = case
    topi = _topi(np.random.default_rng(case[:5]), G, Tg, K, E, skew)
    got = moe.route(torch.from_numpy(topi), E, C)
    ref_route = _reference_route(E, C, K, Tg)
    for g in range(G):
        want = ref_route(jnp.asarray(topi[g], jnp.int32))
        order, slot, keep, dest = (t[g].numpy() for t in got)
        np.testing.assert_array_equal(order, np.asarray(want[0]))
        np.testing.assert_array_equal(keep, np.asarray(want[2]))
        np.testing.assert_array_equal(dest, np.asarray(want[1]))
        np.testing.assert_array_equal(
            slot, np.arange(Tg * K) - np.searchsorted(
                np.sort(topi[g].reshape(-1), kind="stable"),
                topi[g].reshape(-1)[order]))
    if skew == 2.0:
        assert not got[2].all()                  # the case drops


@pytest.mark.parametrize("T,cf", [(64, 1.25), (64, 0.5), (8192, 1.25)])
def test_dispatch_buffer_equals_the_reference(T, cf, monkeypatch):
    """The port's (E, G * C, d) buffer, read as (G, E, C, d), equals the
    reference's dispatch buffer (`xg`, taken at its `act_moe_grouped`
    constraint) row for row, drops included (cf 0.5) and over two groups
    (T 8192)."""
    cfg = port_config("qwen3-moe-235b-a22b").scaled(capacity_factor=cf)
    jcfg = get_config("qwen3-moe-235b-a22b").reduced().scaled(
        capacity_factor=cf)
    p = moe_params(jcfg, 3)
    x = np.random.default_rng((T, 3)).normal(
        size=(T, cfg.d_model)).astype(np.float32)
    seen = []
    real = jax_shd.act_moe_grouped
    monkeypatch.setattr(jax_shd, "act_moe_grouped",
                        lambda a: seen.append(a) or real(a))
    jax_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg)
    want = np.asarray(seen[1])                   # (G, E * C, d)
    got = []
    real_gmm = moe.moe_gmm_gated
    monkeypatch.setattr(moe, "moe_gmm_gated",
                        lambda a, wg, wu, rows=None: got.append(a)
                        or real_gmm(a, wg, wu, rows=rows))
    moe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, cfg)
    E, G = cfg.num_experts, moe.moe_group_count(T)
    C = moe.moe_capacity(T // G, cfg)
    buf = got[0].reshape(E, G, C, cfg.d_model).permute(1, 0, 2, 3)
    np.testing.assert_array_equal(buf.reshape(G, E * C, -1).numpy(), want)
    assert want.shape == (G, E * C, cfg.d_model)


@pytest.mark.parametrize("T,cf", [(64, 1.25), (64, 0.5), (8192, 1.25)])
def test_rows_equal_the_reference_routes_occupied_slots(T, cf, monkeypatch):
    """The `rows` moe_ffn hands both grouped matmuls: for each (expert,
    group) the slots the reference's own `route` keeps, from the
    reference's top-k, drops included (cf 0.5) and over two groups (T
    8192); int32 (E, G); and the rows past them in the buffer are zero."""
    arch = "qwen3-moe-235b-a22b"
    cfg = port_config(arch).scaled(capacity_factor=cf)
    jcfg = get_config(arch).reduced().scaled(capacity_factor=cf)
    p = moe_params(jcfg, 6)
    x = np.random.default_rng((T, 6)).normal(
        size=(T, cfg.d_model)).astype(np.float32)
    tops = []
    real_top_k = jax.lax.top_k
    monkeypatch.setattr(jax.lax, "top_k",
                        lambda a, k: tops.append(real_top_k(a, k))
                        or tops[-1])
    jax_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg)
    monkeypatch.setattr(jax.lax, "top_k", real_top_k)
    topi = np.asarray(tops[0][1])                         # (G, Tg, K)
    E, K, G = cfg.num_experts, cfg.top_k, moe.moe_group_count(T)
    Tg = T // G
    C = moe.moe_capacity(Tg, cfg)
    ref_route = _reference_route(E, C, K, Tg)
    want = np.zeros((E, G), np.int64)
    for g in range(G):
        _, dest, keep = (np.asarray(a) for a in ref_route(
            jnp.asarray(topi[g], jnp.int32)))
        np.add.at(want[:, g], dest[keep] // C, 1)
    seen = []
    real = moe.moe_gmm_gated
    monkeypatch.setattr(moe, "moe_gmm_gated",
                        lambda a, wg, wu, rows=None: seen.append((a, rows))
                        or real(a, wg, wu, rows=rows))
    moe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, cfg)
    buf, rows = seen[0]
    assert rows.dtype == torch.int32 and rows.shape == (E, G)
    np.testing.assert_array_equal(rows.numpy(), want)
    if cf == 0.5:
        assert (want == C).any()                 # some expert is full
    buf = buf.reshape(E, G, C, -1)
    for e in range(E):
        for g in range(G):
            n = int(rows[e, g])
            assert bool(buf[e, g, n:].eq(0).all())
            assert bool(buf[e, g, :n].ne(0).any(-1).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [64, 8192])
def test_moe_ffn_equals_the_composite_it_replaced(T, dtype, monkeypatch):
    """moe_ffn through the gated op and the down product in the compute
    dtype equals, bit for bit, the composite it replaced: three float32
    grouped matmuls, each cast to the compute dtype, F.silu and the
    multiply between them."""
    cfg = port_config("qwen2-moe-a2.7b").scaled(dtype=dtype)
    p = {k: _t(v) for k, v in moe_params(
        get_config("qwen2-moe-a2.7b").reduced(), 7).items()}
    x = _t(np.random.default_rng((T, 7)).normal(
        size=(T, cfg.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    got, aux = moe.moe_ffn(x, p, cfg)

    def gated(a, wg, wu, rows=None):
        dt = a.dtype
        return F.silu(moe_gmm(a, wg).to(dt)) * moe_gmm(a, wu).to(dt)

    def down(a, w, rows=None, out_dtype=torch.float32):
        return moe_gmm(a, w).to(out_dtype)

    monkeypatch.setattr(moe, "moe_gmm_gated", gated)
    monkeypatch.setattr(moe, "moe_gmm", down)
    want, want_aux = moe.moe_ffn(x, p, cfg)
    assert got.dtype == x.dtype
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


# ---------------------------------------------------------------------------
# moe_ffn and the dense oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,cf", [(64, 1.25), (64, 0.5), (8192, 1.25)])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_moe_ffn_matches_the_reference(arch, T, cf):
    """float32 output within rtol 1e-4 / atol 1e-5 and the aux loss within
    rtol 1e-5, with the shared expert (qwen2-moe) and without it
    (qwen3-moe), in one group (T 64) and in two (T 8192), and with
    capacity drops (capacity factor 0.5)."""
    cfg = port_config(arch).scaled(capacity_factor=cf)
    jcfg = get_config(arch).reduced().scaled(capacity_factor=cf)
    p = moe_params(jcfg, 4)
    x = np.random.default_rng((T, 4)).normal(
        size=(T, cfg.d_model)).astype(np.float32)
    want, want_aux = jax_moe.moe_ffn(jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, p), jcfg)
    got, aux = moe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, cfg)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_moe_ref_and_drop_free_moe_ffn_match_the_reference_oracle(arch):
    cfg = port_config(arch).scaled(capacity_factor=8.0)       # no drops
    jcfg = get_config(arch).reduced().scaled(capacity_factor=8.0)
    p = moe_params(jcfg, 5)
    x = np.random.default_rng(5).normal(
        size=(64, cfg.d_model)).astype(np.float32)
    want = np.asarray(jax_moe.moe_ref(jnp.asarray(x),
                                      jax.tree.map(jnp.asarray, p), jcfg))
    tp = {k: _t(v) for k, v in p.items()}
    np.testing.assert_allclose(moe.moe_ref(_t(x), tp, cfg).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    got, _ = moe.moe_ffn(_t(x), tp, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_init_moe_draws_the_reference_shapes():
    jcfg = get_config("qwen2-moe-a2.7b").reduced()
    shapes = jax.eval_shape(lambda k: jax_moe.init_moe(k, jcfg),
                            jax.random.key(0))
    got = moe.init_moe(torch.Generator().manual_seed(0), CFG)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(s.shape) for k, s in shapes.items()}
    assert all(v.dtype == torch.float32 for v in got.values())


# ---------------------------------------------------------------------------
# the model: prefill, caches, decode, generate
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def f32_params():
    return numpy_params(F32, 10)


def test_f32_prefill_caches_and_decode_match_jax(f32_params):
    """Reduced qwen2-moe-a2.7b (4 layers, d 64, 4 heads of 16, qkv bias,
    8 experts top-2 of 32, shared expert 64): prefill logits, the k (after
    RoPE) and v caches and 8 greedy decode steps' logits within rtol 1e-4
    / atol 1e-5; the greedy ids equal."""
    tokens = prompts(10, F32.vocab_size)
    want, want_ids, wpc, wc = _jax_serve(
        F32, jax.tree.map(jnp.asarray, f32_params), jnp.asarray(tokens),
        STEPS, jnp.float32)
    params = transformer.params_from_jax(f32_params, device="cpu")
    with torch.no_grad():
        got, got_ids, gpc, gc = _torch_serve(
            F32, params, torch.from_numpy(tokens).long(), STEPS,
            torch.float32)
    for key in ("k", "v"):
        np.testing.assert_allclose(gpc[key].numpy(), np.asarray(wpc[key]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gc[key].numpy(), np.asarray(wc[key]),
                                   rtol=1e-4, atol=1e-5)
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got_ids, want_ids)


def test_bf16_prefill_and_decode_within_bound():
    """bfloat16 compute: max |dlogit| <= 5e-2 * max |logit| over the
    prefill and 8 decode steps fed the same ids (JAX's greedy ones)."""
    tree = numpy_params(CFG, 11)
    tokens = prompts(11, CFG.vocab_size)
    want, feed, _, _ = _jax_serve(CFG, jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(tokens), STEPS, jnp.bfloat16)
    params = transformer.params_from_jax(tree, device="cpu")
    with torch.no_grad():
        got, _, _, _ = _torch_serve(CFG, params,
                                    torch.from_numpy(tokens).long(), STEPS,
                                    torch.bfloat16, feed=feed)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max()


def test_generate_greedy_ids_match_a_jax_greedy_loop(f32_params):
    tokens = prompts(12, F32.vocab_size)
    _, want_ids, _, _ = _jax_serve(
        F32, jax.tree.map(jnp.asarray, f32_params), jnp.asarray(tokens),
        STEPS, jnp.bfloat16)
    params = transformer.params_from_jax(f32_params, device="cpu")
    res = serve.generate(F32, params, torch.from_numpy(tokens), STEPS,
                         device="cpu")
    assert res.ids.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(res.ids.numpy(), want_ids)
    L, KH, hd = F32.num_layers, F32.num_kv_heads, F32.head_dim
    assert res.cache_bytes == 2 * L * B * (PROMPT + STEPS) * KH * hd * 2


def test_serve_cli_runs_reduced_qwen2_moe_on_the_cpu(capsys):
    serve.main(["--arch", "qwen2-moe-a2.7b", "--device", "cpu", "--batch",
                "2", "--prompt-len", "20", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "prefill: 2 x 20 tok" in out and "greedy ids, seq 0:" in out


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def test_params_round_trip_exactly(f32_params):
    back = transformer.params_to_jax(
        transformer.params_from_jax(f32_params, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(f32_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_init_matches_the_reference_layout():
    params = transformer.init(CFG, torch.Generator().manual_seed(0),
                              device="cpu")
    shapes = jax.eval_shape(lambda k: jax_tf.init(CFG, k), jax.random.key(0))
    got = transformer.params_to_jax(params)
    assert jax.tree.structure(got) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(got), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == s.dtype
    assert "mlp" not in got["layers"]
    assert transformer.param_count(params) == jax_tf.param_count(
        jax.tree.map(np.zeros_like, got))


def test_full_width_parameter_count():
    """qwen2-moe-a2.7b at its published widths, counted from the
    reference's shapes: 14,316,308,480 parameters."""
    shapes = jax.eval_shape(lambda k: jax_tf.init(get_config(QWEN.name), k),
                            jax.random.key(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) \
        == 14_316_308_480


def test_init_in_the_compute_dtype_keeps_norms_and_router_float32():
    params = transformer.init(CFG, torch.Generator().manual_seed(0),
                              device="cpu", dtype=torch.bfloat16)
    flat = []
    transformer._tree_map(lambda p, t: flat.append((p, t)), params)
    for path, t in flat:
        keep = any("norm" in k for k in path) or path[-1] == "router"
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), path
    assert any(p[-1] == "router" for p, _ in flat)
    # the draws are LeCun-normal: an expert slice's spread is 1/sqrt(d)
    wg = params["layers"]["moe"]["wg"][1].float()
    assert abs(float(wg.std()) * np.sqrt(CFG.d_model) - 1.0) < 0.05
    assert transformer.param_count(params) == transformer.param_count(
        transformer.init(CFG, torch.Generator().manual_seed(0),
                         device="cpu"))


def test_cast_params_keeps_the_router_float32_and_logits_are_equal():
    """Casting once gives what the reference's per-use casts give: the
    router stays float32 (its product is taken in float32), `sgate` is
    cast like any weight, and prefill logits are bit-equal."""
    params = transformer.params_from_jax(numpy_params(CFG, 13),
                                         device="cpu")
    cast = transformer.cast_params(CFG, params, "cpu")
    m = cast["layers"]["moe"]
    assert m["router"].dtype == torch.float32
    for k in ("wg", "wu", "wd", "swg", "swu", "swd", "sgate"):
        assert m[k].dtype == torch.bfloat16, k
    assert cast["layers"]["norm1"]["scale"].dtype == torch.float32
    tokens = torch.from_numpy(prompts(13, CFG.vocab_size)).long()
    with torch.no_grad():
        a, _ = transformer.prefill(CFG, params, {"tokens": tokens})
        b, _ = transformer.prefill(CFG, cast, {"tokens": tokens})
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
