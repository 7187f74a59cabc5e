"""The port's dense LM serving path (`repro_torch.models.lm`,
`repro_torch.launch.serve`) against the JAX reference on the CPU, at
gemma3-1b's reduced widths: 4 layers, d 64, 4 heads over 2 KV heads,
head_dim 16, window 16, layers 1 and 3 global.

Both sides get the same parameters, drawn with numpy (the norm scales
non-zero, so a missing `1 +` in rmsnorm shows), through
`params_from_jax`. Float32 parity: rtol 1e-4, atol 1e-5 (sums in another
order); bfloat16: max |dlogit| <= 5e-2 * max |logit|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config
from repro.models.lm import common as jax_common
from repro.models.lm import transformer as jax_tf
from repro_torch.configs import LM_CONFIGS
from repro_torch.launch import serve
from repro_torch.models.lm import common, transformer

CFG = LM_CONFIGS["gemma3-1b"].reduced()
F32 = CFG.scaled(dtype="float32")
B, PROMPT, STEPS = 2, 40, 8


def numpy_params(cfg, seed):
    """A parameter tree in the reference's layout (from its `init`'s
    shapes), every leaf drawn with numpy: weights LeCun-scaled, the
    embedding at 0.5 so logits spread, norm scales (stored as scale - 1)
    at 0.3."""
    shapes = jax.eval_shape(lambda k: jax_tf.init(cfg, k), jax.random.key(0))
    rng = np.random.default_rng((seed, 17))

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.normal(size=s.shape).astype(np.float32)
        if "norm" in name or name == "scale":
            return z * np.float32(0.3)
        if name == "embed":
            return z * np.float32(0.5)
        return z / np.float32(np.sqrt(s.shape[-2]))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def prompts(seed, vocab):
    rng = np.random.default_rng((seed, 18))
    return rng.integers(0, vocab, (B, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def f32_params():
    return numpy_params(F32, 0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_with_nonzero_scale(dtype):
    rng = np.random.default_rng((1, 17))
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    scale = (rng.normal(size=(64,)) * 0.3).astype(np.float32)
    want = jax_common.rmsnorm(jnp.asarray(x).astype(dtype),
                              jnp.asarray(scale), 1e-6)
    got = common.rmsnorm(_t(x).to(getattr(torch, dtype)), _t(scale), 1e-6)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_rotates_halves(dtype):
    rng = np.random.default_rng((2, 17))
    x = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    want = jax_common.apply_rope(jnp.asarray(x).astype(dtype),
                                 jnp.asarray(pos), 1e4)
    got = common.apply_rope(_t(x).to(getattr(torch, dtype)),
                            torch.from_numpy(pos), 1e4)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    with pytest.raises(NotImplementedError, match="M-RoPE"):
        common.apply_rope(_t(x), torch.zeros((2, 3, 40)), 1e4)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = jax_common.activation("gelu")(jnp.asarray(x))
    got = common.activation("gelu")(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_tokens_scale(dtype):
    """At gemma3-1b's d_model 1152 the sqrt(d) scale is cast to the compute
    dtype first: exactly 34.0 in bf16, not 33.94."""
    cfg = LM_CONFIGS["gemma3-1b"].scaled(dtype=dtype)
    rng = np.random.default_rng((3, 17))
    embed = rng.normal(size=(16, cfg.d_model)).astype(np.float32)
    embed[0] = 1.0
    tokens = np.array([[0, 3, 15]], np.int32)
    want = jax_tf._embed_tokens(cfg, {"embed": jnp.asarray(embed)},
                                jnp.asarray(tokens), jnp.dtype(dtype))
    got = transformer._embed_tokens(cfg, {"embed": _t(embed)},
                                    torch.from_numpy(tokens),
                                    getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    if dtype == "bfloat16":
        assert float(got[0, 0, 0]) == 34.0


# ---------------------------------------------------------------------------
# prefill and decode against JAX
# ---------------------------------------------------------------------------
def _jax_serve(cfg, params, tokens, steps, cache_dtype, feed=None):
    """JAX prefill of `tokens` (B, P), then `steps` decode steps; greedy
    ids, or the ids of `feed` (B, steps + 1) when given. The prefill cache
    is copied as `repro/launch/serve.py:57-66` copies it. Returns (logits
    per token, ids, prefill cache, cache after the steps)."""
    n_seq, n_prompt = tokens.shape
    logits, pcache = jax_tf.prefill(cfg, params, {"tokens": tokens})
    cache = jax_tf.init_cache(cfg, n_seq, n_prompt + steps, cache_dtype)
    if cfg.rwkv:
        cache = jax.tree.map(lambda z, p: p.astype(z.dtype), cache, pcache)
    for key in () if cfg.rwkv else ("k", "v"):
        cache[key] = jax.lax.dynamic_update_slice_in_dim(
            cache[key], pcache[key].astype(cache_dtype), 0, axis=2)
    decode = jax.jit(lambda p, c, t, pos: jax_tf.decode_step(cfg, p, c, t,
                                                             pos))
    out, ids = [np.asarray(logits[:, -1], np.float32)], []
    for t in range(steps + 1):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        if feed is not None:
            tok = jnp.asarray(feed[:, t:t + 1])
        ids.append(np.asarray(tok))
        if t == steps:
            break
        logits, cache = decode(params, cache, tok, n_prompt + t)
        out.append(np.asarray(logits[:, -1], np.float32))
    return out, np.concatenate(ids, 1), pcache, cache


def _torch_serve(cfg, params, tokens, steps, cache_dtype, feed=None):
    """The port's counterpart of `_jax_serve`: the prefill cache goes
    through `transformer.fill_cache`, as `generate` copies it."""
    n_seq, n_prompt = tokens.shape
    logits, pcache = transformer.prefill(cfg, params, {"tokens": tokens})
    cache = transformer.fill_cache(cfg, transformer.init_cache(
        cfg, n_seq, n_prompt + steps, cache_dtype, device="cpu"), pcache)
    out, ids = [logits[:, -1].float().numpy()], []
    for t in range(steps + 1):
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        if feed is not None:
            tok = torch.from_numpy(feed[:, t:t + 1]).long()
        ids.append(tok.numpy())
        if t == steps:
            break
        logits, cache = transformer.decode_step(cfg, params, cache, tok,
                                                n_prompt + t)
        out.append(logits[:, -1].float().numpy())
    return out, np.concatenate(ids, 1), pcache, cache


def test_f32_prefill_caches_and_decode_match_jax(f32_params):
    """Prefill logits, the k (after qk-norm and RoPE) and v caches, and 8
    greedy decode steps' logits within rtol 1e-4 / atol 1e-5; the greedy
    ids equal. The 40-token prompt is longer than the window (16), so the
    local layers (0, 2) mask where the global ones (1, 3) do not, in the
    prefill and in every decode step."""
    tokens = prompts(0, F32.vocab_size)
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
    """The compute dtype bfloat16 rounds at other places in the two
    frameworks: max |dlogit| <= 5e-2 * max |logit| over the prefill and 8
    decode steps fed the same ids (JAX's greedy ones); no id check."""
    tree = numpy_params(CFG, 1)
    tokens = prompts(1, CFG.vocab_size)
    want, feed, _, _ = _jax_serve(CFG, jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(tokens), STEPS, jnp.bfloat16)
    params = transformer.params_from_jax(tree, device="cpu")
    with torch.no_grad():
        got, _, _, _ = _torch_serve(CFG, params,
                                    torch.from_numpy(tokens).long(), STEPS,
                                    torch.bfloat16, feed=feed)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max()


def test_prefill_and_decode_match_the_full_forward():
    """The serving contract, torch against torch (as
    `tests/test_lm_archs.py:41-60` holds the reference): prefill's logits
    equal the last position of `apply`, and decoding the prompt token by
    token from an empty cache gives every position's logits."""
    T = 12
    params = transformer.params_from_jax(numpy_params(CFG, 2), device="cpu")
    tokens = torch.from_numpy(prompts(2, CFG.vocab_size)[:, :T]).long()
    with torch.no_grad():
        hidden, aux = transformer.apply(CFG, params, {"tokens": tokens})
        full = transformer.unembed(CFG, params, hidden).float()
        pf, _ = transformer.prefill(CFG, params, {"tokens": tokens})
        assert float(aux) == 0.0
        assert float((pf[:, 0].float() - full[:, -1]).abs().max()) < 1e-3
        cache = transformer.init_cache(CFG, B, T, torch.float32,
                                       device="cpu")
        errs = []
        for t in range(T):
            lg, cache = transformer.decode_step(CFG, params, cache,
                                                tokens[:, t:t + 1], t)
            errs.append(float((lg[:, 0].float() - full[:, t]).abs().max()))
    assert max(errs) < 1e-2, max(errs)     # one bf16 ulp at |logit|~4


def test_generate_greedy_ids_match_a_jax_greedy_loop(f32_params):
    """`generate` on the CPU (a bf16 cache, as `repro/launch/serve.py`
    keeps) gives the greedy ids of the same loop in JAX."""
    tokens = prompts(3, F32.vocab_size)
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
    assert res.prefill_ms > 0 and res.decode_ms_per_step > 0


def test_sampling_draws_from_the_generator(f32_params):
    """Decode samples from the generator: equal seeds give equal ids, two
    seeds differ after the first token (which is the argmax, drawn from
    no generator)."""
    params = transformer.params_from_jax(f32_params, device="cpu")
    tokens = torch.from_numpy(prompts(4, F32.vocab_size))
    runs = [serve.generate(F32, params, tokens, 4, temperature=100.0,
                           generator=torch.Generator().manual_seed(s),
                           device="cpu").ids for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][:, 0], runs[2][:, 0])
    assert not torch.equal(runs[0][:, 1:], runs[2][:, 1:])


def test_first_token_is_the_argmax_at_any_temperature(f32_params):
    """As in the reference (`repro/launch/serve.py`), the first token is
    the argmax of the prefill's last logits, also at temperature 100,
    where a draw would almost never pick it."""
    params = transformer.params_from_jax(f32_params, device="cpu")
    tokens = torch.from_numpy(prompts(4, F32.vocab_size))
    with torch.no_grad():
        logits, _ = transformer.prefill(
            F32, transformer.cast_params(F32, params, "cpu"),
            {"tokens": tokens})
    want = torch.argmax(logits[:, -1], dim=-1)
    for seed in (5, 6, 7):
        ids = serve.generate(F32, params, tokens, 2, temperature=100.0,
                             generator=torch.Generator().manual_seed(seed),
                             device="cpu").ids
        assert torch.equal(ids[:, 0], want)


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "20",
                "--tokens", "3"])
    out = capsys.readouterr().out
    assert "prefill: 2 x 20 tok" in out and "greedy ids, seq 0:" in out


# ---------------------------------------------------------------------------
# parameters, devices, unported families
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


def test_cast_params_keeps_norms_float32_and_logits_are_bf16():
    """Casting the weights once gives what the reference's per-use
    `.astype(dt)` gives; the norm scales stay float32; prefill returns
    the last position only, in bf16 from the tied `embed.T`."""
    params = transformer.params_from_jax(numpy_params(CFG, 3), device="cpu")
    cast = transformer.cast_params(CFG, params, "cpu")
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["layers"]["attn"]["wq"].dtype == torch.bfloat16
    for leaf in (cast["final_norm"]["scale"],
                 cast["layers"]["norm1"]["scale"],
                 cast["layers"]["attn"]["qnorm"]):
        assert leaf.dtype == torch.float32
    tokens = torch.from_numpy(prompts(3, CFG.vocab_size)).long()
    with torch.no_grad():
        a, _ = transformer.prefill(CFG, params, {"tokens": tokens})
        b, _ = transformer.prefill(CFG, cast, {"tokens": tokens})
    assert a.shape == (B, 1, CFG.padded_vocab) and a.dtype == torch.bfloat16
    assert torch.equal(a, b)


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
    # init's norm scales are zero: (scale - 1) storage
    assert not got["layers"]["norm1"]["scale"].any()


@pytest.mark.parametrize("entry", ["generate", "init", "params_from_jax"])
def test_entry_points_raise_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "generate":
            serve.generate(CFG, {}, torch.zeros((1, 4), dtype=torch.long), 1)
        elif entry == "init":
            transformer.init(CFG, torch.Generator().manual_seed(0))
        else:
            transformer.params_from_jax({"embed": np.zeros((2, 2))})


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen2-vl-72b",
                                  "whisper-large-v3"])
def test_unported_families_raise(arch):
    import dataclasses

    from repro_torch.configs import ModelConfig
    cfg = ModelConfig(**dataclasses.asdict(get_config(arch).reduced()))
    with pytest.raises(NotImplementedError, match="not ported"):
        transformer.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
