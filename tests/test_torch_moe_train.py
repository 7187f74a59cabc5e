"""MoE training in the port (`repro_torch.kernels.moe_gmm` backward,
`repro_torch.models.lm.moe`'s dispatch / combine backward, qwen2-moe-a2.7b
through `make_train_step`, `LMTrainer` and the CLI) against the JAX
reference on the CPU.

The reference has no backward kernel: its gradients are `jax.vjp` of the
einsums (`repro/kernels/moe_gmm/ref.py`, `repro/models/lm/moe.py`), which
the plain backward versions and the layer's gradients are held against in
float32 within rtol 1e-5 (sums in another order; the error is scaled by
the largest magnitude of the reference's result, as `_close` does).
Whole train steps agree within rtol 1e-4, as the dense family's do in
`test_torch_lm_train.py`. Inputs and parameters are drawn with numpy and
handed to both packages."""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as RefTrainConfig
from repro.configs.registry import get_config
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_moe_gmm_ref
from repro.models.lm import moe as jax_moe
from repro.models.lm import transformer as jax_tf
from repro.optim import adamw as ref_adamw
from repro.train import train_step as ref_train_step
from repro_torch.analysis import op_audit
from repro_torch.configs import LM_CONFIGS, TrainConfig
from repro_torch.data import pipeline
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm import ref as gmm_ref
from repro_torch.launch import train as train_cli
from repro_torch.models.lm import moe, transformer
from repro_torch.optim import adamw
from repro_torch.train import train_step
from repro_torch.train.lm_loop import LMTrainer
from test_torch_lm_train import _close, numpy_params
from test_torch_moe import moe_params, port_config

ARCH = "qwen2-moe-a2.7b"
CFG = LM_CONFIGS[ARCH].reduced()
F32 = CFG.scaled(dtype="float32")
REF_F32 = get_config(ARCH).reduced().scaled(dtype="float32")
B, S = 4, 32


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# (a) the plain backward versions against jax.vjp of the reference oracle
# ---------------------------------------------------------------------------
def _jax_gated(x, wg, wu):
    return jax.nn.silu(jnp.einsum("ecd,edf->ecf", x, wg)) * \
        jnp.einsum("ecd,edf->ecf", x, wu)


def _gmm_case(E, C, G, d, f, with_rows, seed):
    """x and the output gradients zero past `rows` (as the MoE layer's
    buffer and its gradients are there), LeCun-scaled weights; rows None
    or (E, G) int32 with expert 0 empty and expert 1 full."""
    rng = np.random.default_rng((E, C, G, d, f, seed))
    Cg = C // G
    rows = rng.integers(0, Cg + 1, (E, G))
    rows[0], rows[1] = 0, Cg
    live = (np.arange(C) % Cg)[None, :] < rows[:, np.arange(C) // Cg]
    if not with_rows:
        live[:] = True

    def draw(*shape, scale=1.0, mask=False):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return a * live[..., None] if mask else a
    x, dh, dog = draw(E, C, d, mask=True), draw(E, C, f, mask=True), \
        draw(E, C, d, mask=True)
    wg, wu = draw(E, d, f, scale=d ** -0.5), draw(E, d, f, scale=d ** -0.5)
    wd = draw(E, f, d, scale=f ** -0.5)
    r = torch.as_tensor(rows, dtype=torch.int32) if with_rows else None
    return r, x, wg, wu, wd, dh, dog


@pytest.mark.parametrize("with_rows", [False, True])
@pytest.mark.parametrize("shape", [(3, 24, 1, 16, 8), (4, 40, 2, 24, 12)])
def test_plain_backward_versions_match_jax_vjp(shape, with_rows):
    """float32, rtol 1e-5: `moe_gmm_bwd_dx_ref` / `moe_gmm_bwd_dw_ref`
    against `jax.vjp` of `moe_gmm_ref` (the down product: dh, dwd), and
    `moe_gmm_gated_bwd_ref` then the two-pair dx and two-dy dw against
    `jax.vjp` of silu(einsum) * einsum (dx, dwg, dwu); with `rows` the
    inputs and gradients are zero past them, as in the layer."""
    rows, x, wg, wu, wd, dh, dog = _gmm_case(*shape, with_rows, 0)
    h = np.asarray(_jax_gated(x, wg, wu))
    _, vjp = jax.vjp(jax_moe_gmm_ref, h, wd)
    want_dh, want_dwd = vjp(dog)
    _close(gmm_ref.moe_gmm_bwd_dx_ref(_t(dog), _t(wd), rows=rows),
           want_dh, 1e-5)
    _close(gmm_ref.moe_gmm_bwd_dw_ref(_t(h), _t(dog), rows), want_dwd, 1e-5)
    _, vjp = jax.vjp(_jax_gated, x, wg, wu)
    want_dx, want_dwg, want_dwu = vjp(dh)
    dg, du = gmm_ref.moe_gmm_gated_bwd_ref(_t(x), _t(wg), _t(wu), _t(dh),
                                           rows)
    _close(gmm_ref.moe_gmm_bwd_dx_ref(dg, _t(wg), du, _t(wu), rows),
           want_dx, 1e-5)
    _close(gmm_ref.moe_gmm_bwd_dw_ref(_t(x), dg, rows), want_dwg, 1e-5)
    _close(gmm_ref.moe_gmm_bwd_dw_ref(_t(x), du, rows), want_dwu, 1e-5)
    # the CPU wrappers are these plain versions and count no launch
    before = dict(gmm_kernel.LAUNCHES)
    got = gmm_kernel.moe_gmm_bwd_dw(_t(x), dg, du, rows=rows)
    assert torch.equal(got[1], gmm_ref.moe_gmm_bwd_dw_ref(_t(x), du, rows))
    assert gmm_kernel.LAUNCHES == before


def test_plain_backward_versions_treat_rows_past_rows_as_zero():
    """With garbage past `rows`: dx and the gated backward are zero
    there, and dw equals dw of the inputs zeroed there."""
    rows, x, wg, wu, wd, dh, dog = _gmm_case(4, 40, 2, 24, 12, True, 1)
    mask = gmm_ref.row_mask(rows, 4, 40)
    noise = np.random.default_rng(2).normal(size=dh.shape).astype(np.float32)
    dirty = _t(dh) + torch.where(mask, 0.0, _t(noise))
    dx = gmm_ref.moe_gmm_bwd_dx_ref(dirty, _t(wg), rows=rows)
    assert bool(dx[~mask.expand_as(dx)].eq(0).all())
    dg, du = gmm_ref.moe_gmm_gated_bwd_ref(_t(x), _t(wg), _t(wu), dirty,
                                           rows)
    assert bool(dg[~mask.expand_as(dg)].eq(0).all())
    assert torch.equal(gmm_ref.moe_gmm_bwd_dw_ref(dirty, _t(dog), rows),
                       gmm_ref.moe_gmm_bwd_dw_ref(_t(dh), _t(dog)))


# ---------------------------------------------------------------------------
# (b) moe_ffn's gradients against jax.vjp of the reference's moe_ffn
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# (a') the backward's route, read from shapes and pointers (so it answers
# for CPU tensors too)
# ---------------------------------------------------------------------------
def _route_args(name, pairs, E, C, m, n, dtype, shift):
    """The tensor arguments of backward entry point `name` (dx: dy (E, C,
    n), w (E, m, n), a second pair with `pairs` 2; dw: x (E, C, m), dy
    (E, C, n), a second dy; gated: x (E, C, m), wg, wu (E, m, n), dh (E,
    C, n)) as broadcast views of one element, argument `shift` (an index,
    or None) starting 2 bytes past a 16-byte boundary."""
    def t(i, *shape):
        base = torch.zeros(2, dtype=dtype)
        return (base[1:] if i == shift else base[:1]).expand(shape)
    if name == "moe_gmm_bwd_dx":
        shapes = [(E, C, n), (E, m, n)] * pairs
    elif name == "moe_gmm_bwd_dw":
        shapes = [(E, C, m)] + [(E, C, n)] * pairs
    else:
        shapes = [(E, C, m), (E, m, n), (E, m, n), (E, C, n)]
    return [t(i, *s) for i, s in enumerate(shapes)]


_DX, _DW, _GB = "moe_gmm_bwd_dx", "moe_gmm_bwd_dw", "moe_gmm_gated_bwd"
_BF, _FP = torch.bfloat16, torch.float32


@pytest.mark.parametrize("name, pairs, E, C, m, n, dtype, shift, want", [
    # qwen2-moe-a2.7b's training launches (dh, dxe, dwd, dwg + dwu)
    (_DX, 1, 60, 1376, 1408, 2048, _BF, None, "tensor_core"),
    (_DX, 2, 60, 1376, 2048, 1408, _BF, None, "tensor_core"),
    (_DW, 1, 60, 1376, 1408, 2048, _BF, None, "tensor_core"),
    (_DW, 2, 60, 1376, 2048, 1408, _BF, None, "tensor_core"),
    # the edges of the limits: C 17 and 4096, E 256
    (_DX, 1, 2, 17, 8, 16, _BF, None, "tensor_core"),
    (_DW, 2, 2, 4096, 16, 8, _BF, None, "tensor_core"),
    (_DX, 2, 256, 24, 8, 8, _BF, None, "tensor_core"),
    # C <= 16, C > 4096, E > 256
    (_DX, 1, 2, 16, 8, 16, _BF, None, "mma_sync"),
    (_DW, 1, 2, 16, 8, 16, _BF, None, "mma_sync"),
    (_DX, 1, 2, 4097, 8, 16, _BF, None, "mma_sync"),
    (_DW, 2, 2, 4097, 8, 16, _BF, None, "mma_sync"),
    (_DX, 2, 257, 24, 8, 8, _BF, None, "mma_sync"),
    (_DW, 1, 257, 24, 8, 8, _BF, None, "mma_sync"),
    # a width not a multiple of 8: dx's output (m) or reduction (n), dw's
    # either side
    (_DX, 1, 2, 24, 12, 16, _BF, None, "mma_sync"),
    (_DX, 2, 2, 24, 16, 12, _BF, None, "mma_sync"),
    (_DW, 1, 2, 24, 12, 16, _BF, None, "mma_sync"),
    (_DW, 2, 2, 24, 16, 12, _BF, None, "mma_sync"),
    # an unaligned tensor: dx's dy, its second w; dw's x, its second dy
    (_DX, 1, 2, 24, 16, 16, _BF, 0, "mma_sync"),
    (_DX, 2, 2, 24, 16, 16, _BF, 3, "mma_sync"),
    (_DW, 1, 2, 24, 16, 16, _BF, 0, "mma_sync"),
    (_DW, 2, 2, 24, 16, 16, _BF, 2, "mma_sync"),
    # the gated backward (x (E, C, d), wg, wu (E, d, f), dh (E, C, f)):
    # tensor_core at the training shape and the edges of the limits
    (_GB, 1, 60, 1376, 2048, 1408, _BF, None, "tensor_core"),
    (_GB, 1, 2, 17, 8, 16, _BF, None, "tensor_core"),
    (_GB, 1, 2, 4096, 16, 8, _BF, None, "tensor_core"),
    (_GB, 1, 256, 24, 8, 8, _BF, None, "tensor_core"),
    # ... mma_sync past them: C 16, C 4097, E 257, d or f not a multiple
    # of 8, an unaligned x, wg, wu or dh
    (_GB, 1, 2, 16, 8, 16, _BF, None, "mma_sync"),
    (_GB, 1, 2, 4097, 8, 16, _BF, None, "mma_sync"),
    (_GB, 1, 257, 24, 8, 8, _BF, None, "mma_sync"),
    (_GB, 1, 2, 24, 12, 16, _BF, None, "mma_sync"),
    (_GB, 1, 2, 24, 16, 12, _BF, None, "mma_sync"),
    (_GB, 1, 2, 24, 16, 16, _BF, 0, "mma_sync"),
    (_GB, 1, 2, 24, 16, 16, _BF, 1, "mma_sync"),
    (_GB, 1, 2, 24, 16, 16, _BF, 2, "mma_sync"),
    (_GB, 1, 2, 24, 16, 16, _BF, 3, "mma_sync"),
    # float32: simt, each entry point
    (_DX, 2, 60, 1376, 2048, 1408, _FP, None, "simt"),
    (_DW, 2, 60, 1376, 2048, 1408, _FP, None, "simt"),
    (_GB, 1, 2, 24, 16, 8, _FP, None, "simt"),
])
def test_bwd_route_picks_by_entry_point_dtype_shape_and_alignment(
        name, pairs, E, C, m, n, dtype, shift, want):
    """`kernel.bwd_route(name, *tensors)`: float32 -> simt; bf16 (dx, dw
    and the gated backward alike) -> tensor_core for 16 < C <= 4096, E <=
    256, every width a multiple of 8 and every tensor 16-byte aligned,
    else mma_sync."""
    args = _route_args(name, pairs, E, C, m, n, dtype, shift)
    assert gmm_kernel.bwd_route(name, *args) == want


def test_bwd_route_takes_absent_tensors_and_refuses_unknown_names():
    """None in place of an absent second pair or dy is skipped, as the
    entry points pass it; a name that is no backward entry point raises."""
    dy, w = _route_args(_DX, 1, 2, 24, 16, 16, _BF, None)
    assert gmm_kernel.bwd_route(_DX, dy, w, None, None) == "tensor_core"
    assert gmm_kernel.bwd_route(_DW, dy, dy, None) == "tensor_core"
    with pytest.raises(ValueError):
        gmm_kernel.bwd_route("moe_gmm_fwd", dy, w)


@pytest.mark.parametrize("T,cf", [(64, 1.25), (8192, 1.25), (8192, 0.5)])
def test_moe_ffn_gradients_match_jax_vjp(T, cf):
    """float32, rtol 1e-5: the gradients of x and of every MoE leaf (the
    router through the combine weights and the aux loss, the shared
    expert, wg / wu / wd through the backward's plain versions) for an
    output and an aux gradient drawn with numpy; one dispatch group (T 64)
    and two (T 8192), with capacity drops (factor 0.5) and without."""
    cfg = port_config(ARCH).scaled(capacity_factor=cf)
    jcfg = get_config(ARCH).reduced().scaled(capacity_factor=cf)
    p = moe_params(jcfg, 6)
    rng = np.random.default_rng((T, 6))
    x, dy = (rng.normal(size=(T, cfg.d_model)).astype(np.float32)
             for _ in range(2))
    daux = np.float32(0.75)

    @jax.jit
    def ref(a, q, g, ga):
        out, vjp = jax.vjp(lambda a, q: jax_moe.moe_ffn(a, q, jcfg), a, q)
        return out, vjp((g, ga))

    (want_y, want_aux), (want_dx, want_dp) = ref(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p), jnp.asarray(dy),
        jnp.asarray(daux))
    tx = _t(x).requires_grad_()
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    y, aux = moe.moe_ffn(tx, tp, cfg)
    ((y * _t(dy)).sum() + aux * float(daux)).backward()
    _close(y, want_y, 1e-5)
    _close(tx.grad, want_dx, 1e-5)
    assert set(tp) == set(want_dp)
    for k, t in tp.items():
        _close(t.grad, want_dp[k], 1e-5)


# ---------------------------------------------------------------------------
# (c) the backward scatters nothing with accumulation
# ---------------------------------------------------------------------------
ACCUMULATING = ("aten.index_add", "aten.scatter_add", "aten.index_put",
                "aten._index_put_impl")
# the backward of the router's top-k (`moe.top_k`'s `_Select`: one write
# per selected position, as `torch.topk`'s own backward writes them)
TOPK_BACKWARD = "aten.scatter.src"


def test_moe_backward_scatters_nothing_with_accumulation():
    """The aten ops of the layer's backward (one group with drops, the
    shared expert on), recorded with `op_audit`'s dispatch record: no
    `index_put_` (with or without accumulate: PyTorch's indexing
    backward), `index_add_` or `scatter_add_`; the one scatter is the
    top-k's backward, which writes each selected position once."""
    cfg = F32.scaled(capacity_factor=0.5)
    rng = np.random.default_rng(9)
    p = {k: _t((rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32))
         .requires_grad_() for k, s in moe.moe_shapes(cfg).items()}
    x = _t(rng.normal(size=(128, cfg.d_model)).astype(np.float32)) \
        .requires_grad_()
    y, aux = moe.moe_ffn(x, p, cfg)
    recs, _ = op_audit.record((y.square().sum() + aux).backward)
    names = [r.name for r in recs]
    assert not [n for n in names if n.startswith(ACCUMULATING)], names
    assert [n for n in names if "scatter" in n] == [TOPK_BACKWARD]
    assert "aten.gather.default" in names     # the inverse permutation
    assert x.grad is not None and all(t.grad is not None for t in p.values())


# ---------------------------------------------------------------------------
# (d) train steps against the reference's jitted step
# ---------------------------------------------------------------------------
def _batches(n, seed=0):
    corpus = pipeline.SyntheticTokens(CFG.vocab_size, num_docs=64,
                                      doc_len=2 * S, seed=seed)
    it = iter(pipeline.LMStream(corpus, B, S))
    return [next(it) for _ in range(n)]


def _jax_topi(cfg):
    """A jitted function (params, tokens) -> every layer's top-k expert
    ids, taken by running the reference's layers one by one (its `apply`
    without the scan) with `jax.lax.top_k` wrapped while it traces."""
    def run(params, tokens):
        real, seen = jax.lax.top_k, []

        def spy(v, k):
            out = real(v, k)
            seen.append(out[1].reshape(-1, k))
            return out
        jax.lax.top_k = spy
        try:
            x = jax_tf._embed_tokens(cfg, params, tokens, jnp.float32)
            pos = jnp.broadcast_to(jnp.arange(tokens.shape[1]), tokens.shape)
            for i in range(cfg.num_layers):
                p = jax.tree.map(lambda t: t[i], params["layers"])
                x, _, _ = jax_tf._layer_train(cfg, p, x, pos,
                                              cfg.is_global_layer(i))
        finally:
            jax.lax.top_k = real
        return seen
    return jax.jit(run)


def _port_topi(params, tokens, monkeypatch):
    seen, real = [], moe.route

    def spy(topi, *a):
        seen.append(topi.reshape(-1, topi.shape[-1]))
        return real(topi, *a)
    monkeypatch.setattr(moe, "route", spy)
    with torch.no_grad():
        transformer.apply(F32, params, {"tokens": tokens}, remat=False)
    monkeypatch.setattr(moe, "route", real)
    return seen


@pytest.mark.parametrize("micro", [1, 2])
def test_train_steps_match_the_reference(micro, monkeypatch):
    """5 steps of `make_train_step` on reduced qwen2-moe-a2.7b in float32
    from the same parameters and batches as the reference's jitted step
    (remat, chunked CE, clip, AdamW), microbatches 1 and 2: loss, ce, aux
    and grad_norm within rtol 1e-4, then the parameters. Before each step
    the routing at that step's parameters is checked equal, every layer's
    top-k ids, so that a top-k near-tie shows as a routing difference."""
    tree = numpy_params(REF_F32, 7)
    tk = dict(learning_rate=1e-3, microbatches=micro)
    ref_step, _ = ref_train_step.make_train_step(REF_F32,
                                                 RefTrainConfig(**tk))
    step = train_step.make_train_step(F32, TrainConfig(**tk))
    topi_of = _jax_topi(REF_F32)
    jp = jax.tree.map(jnp.asarray, tree)
    jo = ref_adamw.init(jp)
    tp = transformer.params_from_jax(tree, device="cpu")
    to = adamw.init(tp)
    for toks, labels in _batches(5):
        want_topi = topi_of(jp, jnp.asarray(toks))
        got_topi = _port_topi(tp, torch.from_numpy(toks), monkeypatch)
        assert len(got_topi) == len(want_topi) == F32.num_layers
        for a, b in zip(got_topi, want_topi):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jp, jo, jm = ref_step(jp, jo, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels)})
        tp, to, tm = step(tp, to, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
        for key in ("loss", "ce", "aux", "grad_norm"):
            _close(tm[key], jm[key], 1e-4)
        assert float(tm["aux"]) > 0
    for got, want in zip(adamw.tree_leaves(tp), jax.tree.leaves(jp)):
        _close(got, want, 1e-4)


def test_every_moe_leaf_gets_a_gradient_and_an_update():
    """One step from the reference's parameters: every MoE leaf (router
    float32, wg / wu / wd, the shared expert and its gate) has a nonzero
    gradient and moves under AdamW."""
    tree = transformer.params_from_jax(numpy_params(REF_F32, 8),
                                       device="cpu")
    toks, labels = _batches(1)[0]
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    _, _, grads = train_step.value_and_grad(F32, tree, batch)
    new, _ = adamw.update(grads, adamw.init(tree), tree, lr=1e-3)
    assert set(grads["layers"]["moe"]) == set(moe.moe_shapes(F32))
    for k, g in grads["layers"]["moe"].items():
        assert g.dtype == torch.float32 and bool(g.abs().sum() > 0), k
        assert not torch.equal(new["layers"]["moe"][k],
                               tree["layers"]["moe"][k]), k


# ---------------------------------------------------------------------------
# (e) LMTrainer resume, (f) the CLI
# ---------------------------------------------------------------------------
def _trainer(tmp):
    corpus = pipeline.SyntheticTokens(CFG.vocab_size, num_docs=128,
                                      doc_len=64)
    return LMTrainer(CFG, TrainConfig(learning_rate=3e-3, remat=False),
                     pipeline.LMStream(corpus, batch=4, seq=32),
                     ckpt_dir=tmp, ckpt_every=2, device="cpu")


def test_lm_trainer_resume_is_exact_for_moe():
    """Reduced qwen2-moe-a2.7b (bf16 compute): 4 steps straight against 2,
    a new trainer on the same directory (resumes at step 2, cursor
    included), 2 more: the same losses and parameters, bit for bit."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        a = _trainer(d1)
        ra = a.run(4)
        b = _trainer(d2)
        b.run(2)
        del b
        b2 = _trainer(d2)
        assert b2.step == 2
        rb = b2.run(2)
        assert ra["losses"][2:] == rb["losses"]
        assert all(np.isfinite(ra["losses"]))
        assert all(torch.equal(x, y) for x, y in zip(
            adamw.tree_leaves(a.params), adamw.tree_leaves(b2.params)))


def test_the_cli_trains_reduced_qwen2_moe(capsys):
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "3", "--seq", "16", "--batch", "2"])
    out = capsys.readouterr().out
    assert f"{ARCH}: steps=3 loss" in out and "device: cpu" in out
