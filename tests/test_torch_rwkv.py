"""The port's RWKV serving path (`repro_torch.kernels.rwkv6_chunk`,
`repro_torch.models.lm.rwkv6`, rwkv6-7b through the transformer and
`generate`) against the JAX reference on the CPU.

Inputs and parameters are drawn with numpy from a seed and handed to both
packages. Tolerances, each from float32 sums and exps taken in another
order or by another library:
  - the plain chunked form against the Pallas op in interpret mode and
    against the reference's `wkv6_chunked` (with a non-zero state, output
    and final state): rtol 1e-5 and atol 1e-5 x max |reference|. The
    factored form's e^{+-80} factors turn a one-ulp difference in the
    float32 prefix sum of logw (torch's cumsum against XLA's) into
    ~5e-6 relative error in a factor, so errors scale with the output's
    largest values (observed 1.1e-6 to 2.8e-6 of max |out|);
  - the plain scan against the reference's scan (ragged T 47, and T 1):
    rtol = atol = 2e-4, the reference's own bound between its kernel and
    its scan (`tests/test_kernels.py:179`);
  - the model in float32 (prefill logits, the token shifts, 8 decode
    steps): rtol 1e-4, atol 1e-5; the recurrent state "s" at rtol 1e-4 and
    atol 1e-5 x max |s|: it sums up to 72 outer products of keys and
    values, entries reach 30-50 here, and its float32 rounding alone
    (observed up to 3.7e-5 absolute, 7e-7 of max |s|) exceeds 1e-5;
  - one layer's time mix in bfloat16 (no build-up across layers): r, k
    and v bit-equal to the reference's; g = silu(.) within two bf16
    steps (rtol 2^-6: x * sigmoid(x) in the reference, one op in torch);
    logw (float32, from mix(4) rounded to bf16 first) within rtol 1e-6;
    the WKV output handed to the head norm in bf16 and within one bf16
    step (rtol 2^-7, atol 1e-5 x max) of the reference's; the block's
    output within 2e-2 x max |y| (one to three bf16 steps);
  - the model in bfloat16, on parameters drawn as the reference's `init`
    draws them: max |dlogit| <= 5e-2 x max |logit| against the reference,
    as `tests/test_torch_lm.py` holds the dense model, and no farther from
    the float32 logits than the reference's bf16 logits are, plus 5e-2 x
    max |logit|. At these widths four layers spread bf16 rounding to a
    few percent of max |logit| (the reference's own logits move that far
    when XLA's bf16 excess precision is switched off), so the model bound
    says little about where the port rounds; the one-layer check holds
    the rounding points.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config
from repro.kernels.rwkv6_chunk.ops import wkv6_op as jax_wkv6_op
from repro.kernels.rwkv6_chunk.ref import wkv6_ref as jax_wkv6_ref
from repro.models.lm import rwkv6 as jax_rwkv6
from repro.models.lm import transformer as jax_tf
from repro_torch.configs import LM_CONFIGS, ModelConfig
from repro_torch.kernels.rwkv6_chunk import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_chunk import ref
from repro_torch.kernels.rwkv6_chunk.ops import wkv6
from repro_torch.launch import serve
from repro_torch.models.lm import rwkv6, transformer
from test_torch_lm import STEPS, _jax_serve, _torch_serve

RWKV = LM_CONFIGS["rwkv6-7b"]
CFG = RWKV.reduced()
F32 = CFG.scaled(dtype="float32")
B = 2
FULL_PARAMS, FULL_FLOAT32 = 7_534_546_944, 17_436_672


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a, np.float32)


def assert_close_to_scale(got, want, rel=1e-5):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rel,
                               atol=rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# the WKV recurrence's plain versions
# ---------------------------------------------------------------------------
def wkv_inputs(Bn, T, H, N, seed, state=False):
    """r, k, v unit normal; logw = clip(-exp(z)) with z spread so that
    both ends of the model's clip occur; u the reference's 0.1 x normal;
    s0 normal (or zeros)."""
    rng = np.random.default_rng((Bn, T, H, N, seed))
    r, k, v = (rng.normal(size=(Bn, T, H, N)).astype(np.float32)
               for _ in range(3))
    z = rng.normal(size=(Bn, T, H, N)) * 4.0 - 0.6
    logw = np.clip(-np.exp(z), rwkv6.LOGW_MIN, rwkv6.LOGW_MAX)
    logw = logw.astype(np.float32)
    u = (rng.normal(size=(H, N)) * 0.1).astype(np.float32)
    s0 = rng.normal(size=(Bn, H, N, N)).astype(np.float32) if state else \
        np.zeros((Bn, H, N, N), np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("T", [16, 64, 47])
def test_logw_inputs_hit_both_clip_ends(T):
    logw = wkv_inputs(2, T, 3, 16, 0)[3]
    assert (logw == np.float32(rwkv6.LOGW_MIN)).any()
    assert (logw == np.float32(rwkv6.LOGW_MAX)).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [16, 64])
def test_plain_chunked_matches_the_pallas_op(T, dtype):
    """From a zero state, as the TPU kernel starts: the plain chunked form
    against `wkv6_op` in interpret mode (r/k/v in `dtype`, both read them
    into float32)."""
    r, k, v, logw, u, s0 = wkv_inputs(2, T, 3, 16, 1)
    jr, jk, jv = (jnp.asarray(a).astype(dtype) for a in (r, k, v))
    want = jax_wkv6_op(jr, jk, jv, jnp.asarray(logw), jnp.asarray(u))
    tr, tk, tv = (_t(a).to(getattr(torch, dtype)) for a in (r, k, v))
    got, _ = ref.wkv6_chunked(tr.float(), tk.float(), tv.float(), _t(logw),
                              _t(u), _t(s0))
    assert_close_to_scale(got, want)
    np.testing.assert_allclose(
        ref.wkv6_ref(tr, tk, tv, _t(logw), _t(u)).numpy(),
        _np(jax_wkv6_ref(jr, jk, jv, jnp.asarray(logw), jnp.asarray(u))),
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T", [32, 64])
def test_plain_chunked_matches_the_reference_with_a_state(T):
    r, k, v, logw, u, s0 = wkv_inputs(2, T, 3, 16, 2, state=True)
    want, want_s = jax_rwkv6.wkv6_chunked(*map(jnp.asarray,
                                               (r, k, v, logw, u, s0)))
    got, got_s = ref.wkv6_chunked(*map(_t, (r, k, v, logw, u, s0)))
    assert_close_to_scale(got, want)
    assert_close_to_scale(got_s, want_s)


@pytest.mark.parametrize("T", [47, 1])
def test_plain_scan_matches_the_reference_scan(T):
    """A ragged T (the chunked form falls back to the scan, on both
    sides) and a single step (the decode step's form)."""
    r, k, v, logw, u, s0 = wkv_inputs(2, T, 3, 16, 3, state=True)
    want, want_s = jax_rwkv6.wkv6_scan(*map(jnp.asarray,
                                            (r, k, v, logw, u, s0)))
    for fn in (ref.wkv6_scan, ref.wkv6_chunked):
        got, got_s = fn(*map(_t, (r, k, v, logw, u, s0)))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got_s.numpy(), _np(want_s), rtol=2e-4,
                                   atol=2e-4)


def test_chunked_and_scan_forms_agree():
    r, k, v, logw, u, s0 = (_t(a) for a in wkv_inputs(1, 64, 2, 16, 4,
                                                       state=True))
    a, a_s = ref.wkv6_chunked(r, k, v, logw, u, s0)
    b, b_s = ref.wkv6_scan(r, k, v, logw, u, s0)
    torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(a_s, b_s, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("state", [False, True])
def test_cpu_tensors_take_the_plain_path_and_count_no_launch(state):
    """The wrapper on CPU tensors: `wkv6_chunked` on float32 casts (bf16
    inputs give a float32 output, as the kernel's), zeros for s0=None,
    no launch counted; the op is forward only."""
    wkv_kernel.reset_launches()
    r, k, v, logw, u, s0 = (_t(a) for a in wkv_inputs(2, 32, 2, 16, 5,
                                                       state=state))
    rb, kb, vb = (a.to(torch.bfloat16) for a in (r, k, v))
    out, s_f = wkv_kernel.wkv6_fwd(rb, kb, vb, logw, u,
                                   s0 if state else None)
    want, want_s = ref.wkv6_chunked(rb.float(), kb.float(), vb.float(),
                                    logw, u, s0)
    assert out.dtype == s_f.dtype == torch.float32
    assert torch.equal(out, want) and torch.equal(s_f, want_s)
    assert wkv_kernel.LAUNCHES == {"wkv6_fwd": 0}
    with pytest.raises(RuntimeError, match="forward only"):
        wkv6(r.requires_grad_(), k, v, logw, u)
    with torch.no_grad():
        assert torch.equal(wkv6(r, k, v, logw, u, s0)[0],
                           ref.wkv6_fwd_ref(r, k, v, logw, u, s0)[0])


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
def rwkv_numpy_params(cfg, seed, reference_init=False):
    """A parameter tree in the reference's layout (its `init`'s shapes),
    every leaf drawn with numpy: the mix coefficients uniform in [0, 1];
    w0 spread over [-12, 3], so that the decay clip is hit at both ends;
    the decay LoRA LeCun x 0.1; u 0.1 x normal; ln_x and the norm scales
    (stored as scale - 1) near 1; the embedding at 0.5; other weights
    LeCun-scaled. With `reference_init`, w0 and ln_x are the reference
    init's constants, -0.6 and 1."""
    shapes = jax.eval_shape(lambda k: jax_tf.init(cfg, k), jax.random.key(0))
    rng = np.random.default_rng((seed, 23))

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.normal(size=s.shape)
        if name in ("mu", "mu_c"):
            out = rng.random(s.shape)
        elif name == "w0":
            out = rng.uniform(-12.0, 3.0, s.shape)
            if reference_init:
                out = np.full(s.shape, -0.6)
        elif name in ("wa_decay", "wb_decay"):
            out = z / np.sqrt(s.shape[-2]) * 0.1
        elif name == "u":
            out = z * 0.1
        elif name == "ln_x":
            out = np.ones(s.shape) if reference_init else 1.0 + 0.3 * z
        elif name == "scale":
            out = 0.3 * z
        elif name == "embed":
            out = 0.5 * z
        else:
            out = z / np.sqrt(s.shape[-2])
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _layer0(tree, group):
    return {k: a[0] for k, a in tree["layers"][group].items()}


@pytest.mark.parametrize("chunked", [True, False])
@pytest.mark.parametrize("state", [False, True])
def test_time_and_channel_mix_match_the_reference(state, chunked):
    """Layer 0's time mix and channel mix in float32 over T 32 (a multiple
    of 16: the chunked form runs chunked), from zeros or from a state."""
    tree = rwkv_numpy_params(F32, 1)
    tm, cm = _layer0(tree, "time"), _layer0(tree, "chan")
    rng = np.random.default_rng((2, 23))
    H, N, d = F32.num_heads, F32.head_dim, F32.d_model
    x = rng.normal(size=(B, 32, d)).astype(np.float32)
    st = {"shift": rng.normal(size=(B, 1, d)).astype(np.float32),
          "s": rng.normal(size=(B, H, N, N)).astype(np.float32)} \
        if state else None
    jy, jst = jax_rwkv6.time_mix(
        jnp.asarray(x), jax.tree.map(jnp.asarray, tm), F32,
        state=None if st is None else jax.tree.map(jnp.asarray, st),
        chunked=chunked)
    with torch.no_grad():
        y, tst = rwkv6.time_mix(
            _t(x), {k: _t(a) for k, a in tm.items()}, F32,
            state=None if st is None else {k: _t(a) for k, a in st.items()},
            chunked=chunked)
    np.testing.assert_allclose(y.numpy(), _np(jy), rtol=1e-4, atol=1e-5)
    for key in ("shift", "s"):
        np.testing.assert_allclose(tst[key].numpy(), _np(jst[key]),
                                   rtol=1e-4, atol=1e-5)
    prev = None if st is None else st["shift"]
    jc, jsc = jax_rwkv6.channel_mix(
        jnp.asarray(x), jax.tree.map(jnp.asarray, cm), F32,
        state=None if prev is None else jnp.asarray(prev))
    with torch.no_grad():
        c, sc = rwkv6.channel_mix(_t(x), {k: _t(a) for k, a in cm.items()},
                                  F32,
                                  state=None if prev is None else _t(prev))
    np.testing.assert_allclose(c.numpy(), _np(jc), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(sc.numpy(), _np(jsc))


@pytest.mark.parametrize("chunked", [True, False])
def test_bf16_time_mix_rounds_where_the_reference_does(chunked, monkeypatch):
    """Layer 0's time mix in bfloat16 on the same bf16 input, T 64 from
    zeros, parameters drawn as the reference's init draws them: the
    projections, logw from mix(4) rounded before the upcast, the WKV
    output cast to bf16 before the head norm, and the block's output
    (the bounds of the module docstring)."""
    tree = rwkv_numpy_params(CFG, 14, reference_init=True)
    tm = _layer0(tree, "time")
    d = CFG.d_model
    x = np.random.default_rng((14, 25)).normal(size=(B, 64, d))
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    jtm = jax.tree.map(jnp.asarray, tm)
    jp = jax_rwkv6._project(jx, jtm, CFG, jnp.zeros((B, 1, d), jx.dtype))
    jfn = jax_rwkv6.wkv6_chunked if chunked else jax_rwkv6.wkv6_scan
    jout, _ = jfn(*jp[:3], jp[4], jtm["u"], jnp.zeros(
        (B, CFG.num_heads, CFG.head_dim, CFG.head_dim), jnp.float32))
    jy, _ = jax_rwkv6.time_mix(jx, jtm, CFG, chunked=chunked)
    tx = _t(jx.astype(jnp.float32)).to(torch.bfloat16)
    ttm = {k: _t(a) for k, a in tm.items()}
    seen = []
    real = rwkv6._head_norm
    monkeypatch.setattr(rwkv6, "_head_norm",
                        lambda out, *a: seen.append(out) or real(out, *a))
    with torch.no_grad():
        tp = rwkv6._project(tx, ttm, CFG, torch.zeros(
            (B, 1, d), dtype=torch.bfloat16))
        y, _ = rwkv6.time_mix(tx, ttm, CFG, chunked=chunked)
    for got, want in zip(tp[:4], jp[:4]):
        assert got.dtype == torch.bfloat16
    for got, want in zip(tp[:3], jp[:3]):
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    np.testing.assert_allclose(tp[3].float().numpy(), _np(jp[3]),
                               rtol=2.0 ** -6)
    assert tp[4].dtype == torch.float32
    np.testing.assert_allclose(tp[4].numpy(), _np(jp[4]), rtol=1e-6)
    (out,) = seen
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    jout = _np(jout)
    np.testing.assert_allclose(out.float().numpy(), jout, rtol=2.0 ** -7,
                               atol=1e-5 * np.abs(jout).max())
    assert y.dtype == torch.bfloat16
    jy = _np(jy)
    assert np.abs(y.float().numpy() - jy).max() <= 2e-2 * np.abs(jy).max()


def test_token_shift_matches_the_reference():
    rng = np.random.default_rng((3, 23))
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    prev = rng.normal(size=(2, 1, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        rwkv6.token_shift(_t(x), _t(prev)).numpy(),
        _np(jax_rwkv6.token_shift(jnp.asarray(x), jnp.asarray(prev))))


def test_init_draws_follow_the_reference():
    """`init` draws RWKV's leaves as the reference's `init_time_mix` /
    `init_channel_mix` do: the mix coefficients uniform in [0, 1), w0 at
    -0.6, the decay LoRA LeCun x 0.1, u 0.1 x normal, ln_x ones."""
    cfg = RWKV.reduced().scaled(d_model=256, num_heads=4, head_dim=64,
                                d_ff=512)
    p = transformer.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tm, cm = p["layers"]["time"], p["layers"]["chan"]
    for mu in (tm["mu"], cm["mu_c"]):
        assert 0.0 <= float(mu.min()) and float(mu.max()) < 1.0
        assert abs(float(mu.mean()) - 0.5) < 0.03
    assert torch.all(tm["w0"] == np.float32(-0.6))
    assert torch.all(tm["ln_x"] == 1.0)
    assert abs(float(tm["u"].std()) - 0.1) < 0.01
    assert abs(float(tm["wa_decay"].std()) * np.sqrt(256) - 0.1) < 0.01
    assert abs(float(tm["wb_decay"].std()) * np.sqrt(64) - 0.1) < 0.01
    assert abs(float(tm["wr_t"].std()) * np.sqrt(256) - 1.0) < 0.05
    assert abs(float(cm["wcv"].std()) * np.sqrt(512) - 1.0) < 0.05


def test_init_time_and_channel_mix_draw_the_reference_shapes():
    jcfg = get_config(RWKV.name).reduced()
    for jax_init, init in ((jax_rwkv6.init_time_mix, rwkv6.init_time_mix),
                           (jax_rwkv6.init_channel_mix,
                            rwkv6.init_channel_mix)):
        shapes = jax.eval_shape(lambda k: jax_init(k, jcfg),
                                jax.random.key(0))
        got = init(torch.Generator().manual_seed(0), CFG)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(s.shape) for k, s in shapes.items()}
        assert all(v.dtype == torch.float32 for v in got.values())


def test_init_matches_the_reference_layout():
    params = transformer.init(CFG, torch.Generator().manual_seed(0),
                              device="cpu")
    shapes = jax.eval_shape(lambda k: jax_tf.init(CFG, k), jax.random.key(0))
    got = transformer.params_to_jax(params)
    assert jax.tree.structure(got) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(got), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == s.dtype
    assert transformer.param_count(params) == jax_tf.param_count(
        jax.tree.map(np.zeros_like, got))


def _float32_paths(tree):
    flat = []
    transformer._tree_map(lambda p, t: flat.append((p, t)), tree)
    return flat


def test_full_width_parameter_and_float32_counts():
    """rwkv6-7b at its published widths, counted from the reference's
    shapes (nothing allocated): 7,534,546,944 parameters, of which the
    leaves that stay float32 (`_keeps_float32`: the norms, w0, the decay
    LoRA, u, ln_x) hold 17,436,672."""
    shapes = jax.eval_shape(lambda k: jax_tf.init(get_config(RWKV.name), k),
                            jax.random.key(0))
    flat = jax.tree_util.tree_leaves_with_path(shapes)
    total = sum(int(np.prod(s.shape)) for _, s in flat)
    kept = sum(int(np.prod(s.shape)) for p, s in flat
               if transformer._keeps_float32(
                   tuple(str(getattr(k, "key", k)) for k in p)))
    assert (total, kept) == (FULL_PARAMS, FULL_FLOAT32)


@pytest.mark.parametrize("how", ["init", "cast_params"])
def test_bf16_trees_keep_exactly_the_float32_leaves(how):
    """`init(dtype=bfloat16)` and `cast_params` leave float32 exactly the
    norm scales, w0, wa_decay, wb_decay, u and ln_x; `mu`, `mu_c` and
    every weight are bf16, as the reference casts them at each use."""
    if how == "init":
        tree = transformer.init(CFG, torch.Generator().manual_seed(0),
                                device="cpu", dtype=torch.bfloat16)
    else:
        tree = transformer.cast_params(CFG, transformer.params_from_jax(
            rwkv_numpy_params(CFG, 4), device="cpu"), "cpu")
    kept = {p for p, t in _float32_paths(tree) if t.dtype == torch.float32}
    assert kept == {("final_norm", "scale"), ("layers", "norm1", "scale"),
                    ("layers", "norm2", "scale"), ("layers", "time", "w0"),
                    ("layers", "time", "wa_decay"),
                    ("layers", "time", "wb_decay"),
                    ("layers", "time", "u"), ("layers", "time", "ln_x")}
    assert all(t.dtype == torch.bfloat16 for p, t in _float32_paths(tree)
               if p not in kept)


# ---------------------------------------------------------------------------
# the model: prefill, state cache, decode, generate
# ---------------------------------------------------------------------------
def prompts(seed, n):
    rng = np.random.default_rng((seed, 24))
    return rng.integers(0, CFG.vocab_size, (B, n)).astype(np.int32)


@pytest.fixture(scope="module")
def f32_params():
    return rwkv_numpy_params(F32, 10)


@pytest.mark.parametrize("prompt", [40, 64])
def test_f32_prefill_state_and_decode_match_jax(f32_params, prompt):
    """Reduced rwkv6-7b (4 layers, d 64, 4 heads of 16, d_ff 128): prefill
    logits, the whole state cache after the prefill and after 8 greedy
    decode steps, and every step's logits within rtol 1e-4 / atol 1e-5
    (the state's atol scaled by max |s|: module docstring); the greedy ids
    equal. Prompt 40 takes the scan (16 does not divide
    it), 64 the chunked form, on both sides."""
    tokens = prompts(prompt, prompt)
    want, want_ids, wpc, wc = _jax_serve(
        F32, jax.tree.map(jnp.asarray, f32_params), jnp.asarray(tokens),
        STEPS, jnp.float32)
    params = transformer.params_from_jax(f32_params, device="cpu")
    with torch.no_grad():
        got, got_ids, gpc, gc = _torch_serve(
            F32, params, torch.from_numpy(tokens).long(), STEPS,
            torch.float32)
    assert set(gpc) == set(gc) == {"s", "shift_t", "shift_c"}
    assert gc["s"].shape == (F32.num_layers, B, F32.num_heads,
                             F32.head_dim, F32.head_dim)
    for got_c, want_c in ((gpc, wpc), (gc, wc)):
        for key in got_c:
            want_k = _np(want_c[key])
            scale = np.abs(want_k).max() if key == "s" else 1.0
            np.testing.assert_allclose(got_c[key].numpy(), want_k,
                                       rtol=1e-4, atol=1e-5 * scale)
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got_ids, want_ids)


def test_bf16_prefill_and_decode_within_bound():
    """bfloat16 compute over the prefill and 8 decode steps fed the same
    ids (JAX's greedy ones), parameters drawn as the reference's init
    draws them: the bounds of the module docstring, against the reference
    in bf16 and against float32 logits (the reference's, same parameters
    and ids)."""
    tree = rwkv_numpy_params(CFG, 11, reference_init=True)
    tokens = prompts(11, 48)
    want, feed, _, _ = _jax_serve(CFG, jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(tokens), STEPS, jnp.bfloat16)
    exact, _, _, _ = _jax_serve(F32, jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(tokens), STEPS, jnp.float32,
                                feed=feed)
    params = transformer.params_from_jax(tree, device="cpu")
    with torch.no_grad():
        got, _, _, _ = _torch_serve(CFG, params,
                                    torch.from_numpy(tokens).long(), STEPS,
                                    torch.bfloat16, feed=feed)
    for g, w, e in zip(got, want, exact):
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 5e-2 * scale
        assert np.abs(g - e).max() <= np.abs(w - e).max() + 5e-2 * scale


def test_generate_greedy_ids_match_a_jax_greedy_loop(f32_params):
    """`generate` on the CPU (the state float32, the token shifts bf16,
    as `repro/launch/serve.py` keeps them) gives the greedy ids of the
    same loop in JAX; the state cache's size does not grow with length."""
    tokens = prompts(12, 32)
    _, want_ids, _, _ = _jax_serve(
        F32, jax.tree.map(jnp.asarray, f32_params), jnp.asarray(tokens),
        STEPS, jnp.bfloat16)
    params = transformer.params_from_jax(f32_params, device="cpu")
    res = serve.generate(F32, params, torch.from_numpy(tokens), STEPS,
                         device="cpu")
    assert res.ids.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(res.ids.numpy(), want_ids)
    L, H, N, d = F32.num_layers, F32.num_heads, F32.head_dim, F32.d_model
    assert res.cache_bytes == L * B * (H * N * N * 4 + 2 * d * 2)


def test_prefill_and_decode_match_the_full_forward():
    """The serving contract, torch against torch: prefill's logits equal
    the last position of `apply` (both chunked; the unembedding of one
    position against all, rtol 1e-5), and decoding the prompt token by
    token from a zero state (the scan) gives every position's logits and
    the prefill's state (rtol 1e-4, atol 1e-5; the state's atol scaled by
    max |s|)."""
    T = 32
    params = transformer.params_from_jax(rwkv_numpy_params(F32, 13),
                                         device="cpu")
    tokens = torch.from_numpy(prompts(13, T)).long()
    with torch.no_grad():
        hidden, aux = transformer.apply(F32, params, {"tokens": tokens})
        full = transformer.unembed(F32, params, hidden)
        pf, pcache = transformer.prefill(F32, params, {"tokens": tokens})
        assert float(aux) == 0.0
        torch.testing.assert_close(pf[:, 0], full[:, -1], rtol=1e-5,
                                   atol=1e-6)
        cache = transformer.init_cache(F32, B, T, torch.float32,
                                       device="cpu")
        for t in range(T):
            lg, cache = transformer.decode_step(F32, params, cache,
                                                tokens[:, t:t + 1], t)
            torch.testing.assert_close(lg[:, 0], full[:, t], rtol=1e-4,
                                       atol=1e-5)
    for key in pcache:
        scale = float(pcache[key].abs().max()) if key == "s" else 1.0
        torch.testing.assert_close(cache[key], pcache[key], rtol=1e-4,
                                   atol=1e-5 * scale)


def test_serve_cli_runs_reduced_rwkv_on_the_cpu(capsys):
    serve.main(["--arch", "rwkv6-7b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "32", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "prefill: 2 x 32 tok" in out and "(state)" in out
    assert "greedy ids, seq 0:" in out


def test_port_config_equals_the_reference():
    assert dataclasses.asdict(RWKV) == dataclasses.asdict(
        ModelConfig(**dataclasses.asdict(get_config(RWKV.name))))
