"""The generic transformer (`repro/models/lm/transformer.py`), dense, MoE
and RWKV families: `init`, the train forward (`apply`, with remat), the
prefill, the cache (keys and values, or RWKV's recurrent state) and the
decode step. Hybrid SSM,
encoder-decoder, M-RoPE, learned positions and vision tokens belong to
later slices and raise `NotImplementedError`.

Parameters are a dict tree in the reference's layout: layer parameters
stacked on a leading L axis (the reference builds them with `jax.vmap`),
weights `(din, dout)` for `x @ W`, so `params_from_jax` / `params_to_jax`
carry them across without transposes. They are stored float32, and each
use casts a weight to the compute dtype as the reference does
(`.astype(dt)`); `cast_params` does that cast once for serving (same
values; the leaves the reference uses in float32 stay float32:
`_keeps_float32`). `init(dtype=)` builds the tree in the compute dtype
directly, for a model whose float32 tree would not fit. The reference's
sharding constraints (`shd.act_*`) are no-ops off a mesh and are dropped.
The decode step writes the new key and value, or the new RWKV state and
token shifts, into the cache in place.

`apply` is the training forward: the layer weights are cast to the
compute dtype once, before the layer loop (as the reference casts them
before its scan; the float32 masters get the gradients through the
casts), each layer runs under `torch.utils.checkpoint` with `remat`, and
the token embedding's rows come from `gather_rows` on the float32 table,
whose backward is the fixed-order `gather_agg_bwd_dx` scatter-add on the
card. The dense and MoE families train (`check_trainable`); the MoE
layer's backward runs through the grouped matmul's backward kernels and
gathers (`moe.py`). RWKV's chunked WKV kernel has no backward yet.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.kernels.gather_agg.ops import gather_rows
from repro_torch.models.lm import rwkv6
from repro_torch.models.lm.attention import decode_attention, flash_attention
from repro_torch.models.lm.common import (activation, apply_rope, dense_init,
                                          embed_init, norm_apply, norm_init,
                                          rmsnorm)
from repro_torch.models.lm.moe import moe_ffn, moe_shapes

Params = Dict[str, Any]

_NOT_PORTED = ("hybrid", "encoder_decoder", "mrope", "learned_pos",
               "vision_tokens", "mlp_bias")
# leaves used in float32 whatever the compute dtype: the MoE router, whose
# product the reference takes in float32 (`repro/models/lm/moe.py:76`), and
# RWKV's decay LoRA, bonus and per-head norm (`repro/models/lm/rwkv6.py:
# 138-149, 161`)
_FLOAT32_LEAVES = ("router", "w0", "wa_decay", "wb_decay", "u", "ln_x")


def _check_supported(cfg: ModelConfig) -> None:
    on = [f for f in _NOT_PORTED if getattr(cfg, f)]
    if on:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(on)} not ported yet (dense, MoE and "
            f"RWKV LMs only)")


def check_trainable(cfg: ModelConfig) -> None:
    """Raises for a config the port cannot train yet: RWKV training needs
    a backward through `wkv6_fwd`. Dense and MoE LMs train."""
    _check_supported(cfg)
    if cfg.rwkv:
        raise NotImplementedError(
            f"{cfg.name}: training needs a backward through wkv6_fwd, which "
            f"a later slice of the port brings; dense and MoE LMs train")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _tree_map(fn: Callable, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _keeps_float32(path) -> bool:
    """Leaves the compute dtype never rounds: the norms' (any key holding
    "norm") and those named in `_FLOAT32_LEAVES` (by exact key: RWKV's
    "u", not the MLP's "wu")."""
    return any("norm" in k for k in path) or path[-1] in _FLOAT32_LEAVES


def _layer(layers: Params, i: int) -> Params:
    """Layer i's parameters: views into the stacked tree."""
    return _tree_map(lambda _, t: t[i], layers)


# ---------------------------------------------------------------------------
# init and parameter transfer
# ---------------------------------------------------------------------------
def init(cfg: ModelConfig, generator: torch.Generator, max_seq: int = 4096,
         device: DeviceLike = None, dtype: torch.dtype = None) -> Params:
    """A parameter tree drawn from `generator` (on the CPU or the card), on
    `device` (the card unless given). `max_seq` sizes learned position
    tables, which no ported config has.

    Float32 unless `dtype` is given. With `dtype`, every leaf but those of
    `_keeps_float32` (which stay float32, as `cast_params` keeps them) is
    stored in that dtype. Each stacked layer leaf is drawn one layer
    slice at a time into its place on `device`: the peak is the tree plus
    one float32 slice (at qwen2-moe-a2.7b, an expert tensor's 0.69 GB),
    not a float32 tree beside the cast one. RWKV's leaves take the
    reference's draws (`rwkv6.time_mix_init`)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    g = generator
    L, V, d = cfg.num_layers, cfg.padded_vocab, cfg.d_model
    qd, kvd, ff = cfg.q_dim, cfg.kv_dim, cfg.d_ff

    def leaf_dtype(path):
        keep = dtype is None or _keeps_float32(path)
        return torch.float32 if keep else dtype

    def place(path, t):
        return t.to(device=dev, dtype=leaf_dtype(path))

    def dense(path, shape, draw=dense_init):
        """A stacked (L, ...) leaf, LeCun-normal unless `draw` says."""
        out = torch.empty(shape, dtype=leaf_dtype(path), device=dev)
        for i in range(shape[0]):
            out[i].copy_(draw(g, shape[1:]))
        return out

    def stacked(path, tree):
        return _tree_map(lambda p, t: place(path + p, t.expand(
            L, *t.shape).clone()), tree)

    layers: Params = {"norm1": stacked(("norm1",), norm_init(cfg, d)),
                      "norm2": stacked(("norm2",), norm_init(cfg, d))}
    if cfg.rwkv:
        for name, leaves in (("time", rwkv6.time_mix_init(cfg)),
                             ("chan", rwkv6.channel_mix_init(cfg))):
            layers[name] = {k: dense((name, k), (L, *s), draw)
                            for k, (s, draw) in leaves.items()}
    else:
        attn = {k: dense(("attn", k), s) for k, s in (
            ("wq", (L, d, qd)), ("wk", (L, d, kvd)), ("wv", (L, d, kvd)),
            ("wo", (L, qd, d)))}
        if cfg.qkv_bias:
            attn.update(stacked(("attn",), {"bq": torch.zeros((qd,)),
                                            "bk": torch.zeros((kvd,)),
                                            "bv": torch.zeros((kvd,))}))
        if cfg.qk_norm:
            attn.update(stacked(("attn",),
                                {"qnorm": torch.zeros((cfg.head_dim,)),
                                 "knorm": torch.zeros((cfg.head_dim,))}))
        layers["attn"] = attn
        if cfg.moe:
            layers["moe"] = {k: dense(("moe", k), (L, *s))
                             for k, s in moe_shapes(cfg).items()}
        else:
            layers["mlp"] = {k: dense(("mlp", k), s) for k, s in (
                ("wg", (L, d, ff)), ("wu", (L, d, ff)), ("wd", (L, ff, d)))}
    params: Params = {
        "embed": place(("embed",), embed_init(g, (V, d))),
        "layers": layers,
        "final_norm": _tree_map(lambda p, t: place(("final_norm",) + p, t),
                                norm_init(cfg, d)),
    }
    if not cfg.tie_embeddings:
        params["head"] = place(("head",), dense_init(g, (d, V)))
    return params


def param_count(params: Params) -> int:
    total = []
    _tree_map(lambda _, t: total.append(t.numel()), params)
    return sum(total)


def cast_params(cfg: ModelConfig, params: Params,
                device: DeviceLike = None) -> Params:
    """The tree on `device` (the card unless given) with every weight in
    the compute dtype, as each use in the reference casts it; the leaves
    of `_keeps_float32` (norms, the MoE router, RWKV's decay LoRA, bonus
    and head norm) stay float32. A leaf already so is not copied."""
    dev = resolve_device(device)
    dt = _dtype(cfg)

    def f(path, t):
        keep = _keeps_float32(path)
        return t.to(device=dev, dtype=torch.float32 if keep else dt)

    return _tree_map(f, params)


def params_from_jax(tree: Params, device: DeviceLike = None) -> Params:
    """The reference's `init` tree (numpy leaves; layer leaves stacked on
    a leading L axis) -> the port's tree of tensors on `device` (the card
    unless given), same values and dtypes."""
    dev = resolve_device(device)
    return _tree_map(lambda _, a: torch.from_numpy(np.array(a)).to(dev), tree)


def params_to_jax(params: Params) -> Params:
    """The inverse of `params_from_jax`: numpy leaves in the reference's
    layout."""
    return _tree_map(lambda _, t: t.detach().cpu().numpy(), params)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _qkv(cfg, p, x):
    """Project to (B,S,H,hd)/(B,S,KH,hd); q and k normed over the head dim
    when the config has qk_norm."""
    B, S, _ = x.shape
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if "qnorm" in p:
        q = rmsnorm(q, p["qnorm"], cfg.norm_eps)
        k = rmsnorm(k, p["knorm"], cfg.norm_eps)
    return q, k, v


def _attn_train(cfg, p, x, positions, is_global, *, causal=True):
    """Returns (pre-wo output (B,S,q_dim), (k, v) as stored in a cache:
    k after RoPE)."""
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=causal, window=cfg.window,
                          is_global=is_global)
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.q_dim), (k, v)


def _mlp(cfg, p, x):
    """The gated MLP (whisper's biased one is a later slice)."""
    dt = x.dtype
    h = activation(cfg.act)(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
    return h @ p["wd"].to(dt)


def _ffn(cfg, p, x):
    """Returns (out, aux): the MoE FFN over the (B * S, d) tokens, or the
    gated MLP."""
    if cfg.moe:
        B, S, d = x.shape
        y, aux = moe_ffn(x.reshape(B * S, d), p["moe"], cfg)
        return y.reshape(B, S, d), aux
    return _mlp(cfg, p["mlp"], x), torch.zeros((), device=x.device)


def _rwkv_layer(cfg, p, x, state=None, chunked=True):
    """One RWKV layer: time mix and channel mix, each over its normed
    input, from `state` ({"s", "shift_t", "shift_c"} of this layer, or
    None for zeros). Returns (x, the layer's new state)."""
    st = None if state is None else {"shift": state["shift_t"],
                                     "s": state["s"]}
    y, st = rwkv6.time_mix(norm_apply(cfg, x, p["norm1"]), p["time"], cfg,
                           state=st, chunked=chunked)
    x = x + y
    y, sc = rwkv6.channel_mix(
        norm_apply(cfg, x, p["norm2"]), p["chan"], cfg,
        state=None if state is None else state["shift_c"])
    return x + y, {"s": st["s"], "shift_t": st["shift"], "shift_c": sc}


def _layer_train(cfg, p, x, positions, is_global, collect=False):
    """One decoder layer; returns (x, aux, the layer's cache entries or
    None): {"k", "v"}, or RWKV's {"s", "shift_t", "shift_c"}."""
    if cfg.rwkv:
        x, extras = _rwkv_layer(cfg, p, x)
        return x, torch.zeros((), device=x.device), \
            extras if collect else None
    h = norm_apply(cfg, x, p["norm1"])
    attn_out, (k, v) = _attn_train(cfg, p["attn"], h, positions, is_global)
    extras = {"k": k, "v": v} if collect else None
    x = x + attn_out @ p["attn"]["wo"].to(x.dtype)
    h2 = norm_apply(cfg, x, p["norm2"])
    ff, aux = _ffn(cfg, p, h2)
    return x + ff, aux, extras


def _embed_tokens(cfg, params, tokens, dtype):
    """Rows of the embedding in the compute dtype; gemma's tied embeddings
    are scaled by sqrt(d_model) computed in float32 and cast to the compute
    dtype first (34.0 in bf16 at d_model 1152, not 33.94). The rows come
    from `gather_rows` (`table[tokens]`), whose backward, in training, is
    the bwd_dx kernel's fixed-order scatter-add."""
    x = gather_rows(params["embed"], tokens).to(dtype)
    if cfg.tie_embeddings:
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=x.device).to(dtype)
        x = x * scale
    return x


# ---------------------------------------------------------------------------
# full forward (train / prefill)
# ---------------------------------------------------------------------------
def _cast_layers(layers: Params, dtype: torch.dtype) -> Params:
    """The stacked layer tree with every float32 weight in the compute
    dtype but the leaves of `_keeps_float32` (autograd carries the
    gradients back to the float32 masters)."""
    return _tree_map(lambda path, t: t if _keeps_float32(path)
                     or t.dtype != torch.float32 else t.to(dtype), layers)


def apply(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
          remat: bool = True):
    """Train / prefill forward over `batch["tokens"]` (B, S) at positions
    0..S-1 (the reference's `apply`, `transformer.py:282-323`). The layer
    weights are cast to the compute dtype before the loop; with `remat`
    each layer runs under `torch.utils.checkpoint` (its activations are
    recomputed in the backward). Returns (hidden (B,S,d), aux)."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dtype = _dtype(cfg)
    x = _embed_tokens(cfg, params, tokens, dtype)
    positions = torch.arange(S, device=x.device).expand(B, S)
    # one cast of the stacked weights, unbound into per-layer views (the
    # backward of `unbind` stacks the L gradients in one op)
    unbound = _tree_map(lambda _, t: t.unbind(0),
                        _cast_layers(params["layers"], dtype))
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.num_layers):
        p = _tree_map(lambda _, ts: ts[i], unbound)
        glob = cfg.is_global_layer(i)

        def body(x, p=p, glob=glob):
            x, a, _ = _layer_train(cfg, p, x, positions, glob)
            return x, a

        x, a = checkpoint(body, x, use_reentrant=False) if remat \
            else body(x)
        aux = aux + a
    return norm_apply(cfg, x, params["final_norm"]), aux


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """Inference prefill: the forward pass that also materialises the
    cache. Returns (last-position logits (B, 1, V), the cache with a
    leading L axis: {"k", "v"} each (B, S, KH, hd) in the compute dtype,
    or RWKV's {"s": (B, H, N, N) float32, "shift_t", "shift_c": (B, 1, d)
    the last token of each mix's normed input})."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(cfg, params, tokens, _dtype(cfg))
    positions = torch.arange(S, device=x.device).expand(B, S)
    per_layer = []
    for i in range(cfg.num_layers):
        x, _, extras = _layer_train(cfg, _layer(params["layers"], i), x,
                                    positions, cfg.is_global_layer(i),
                                    collect=True)
        per_layer.append(extras)
    x = norm_apply(cfg, x, params["final_norm"])
    logits = unembed(cfg, params, x[:, -1:])
    return logits, {k: torch.stack([e[k] for e in per_layer])
                    for k in per_layer[0]}


def unembed(cfg: ModelConfig, params: Params, hidden) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = hidden @ head.to(hidden.dtype)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# serving: cache init + decode step
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None) -> Params:
    """Zeros: the KV cache (L, B, seq_len, KH, hd) in `dtype`, or RWKV's
    state, whatever `seq_len`: "s" (L, B, H, N, N) float32 and the token
    shifts "shift_t", "shift_c" (L, B, 1, d) in `dtype`."""
    _check_supported(cfg)
    dev = resolve_device(device)
    L, B = cfg.num_layers, batch_size
    if cfg.rwkv:
        N = cfg.head_dim
        return {"s": torch.zeros((L, B, cfg.num_heads, N, N),
                                 dtype=torch.float32, device=dev),
                "shift_t": torch.zeros((L, B, 1, cfg.d_model), dtype=dtype,
                                       device=dev),
                "shift_c": torch.zeros((L, B, 1, cfg.d_model), dtype=dtype,
                                       device=dev)}
    shape = (L, B, seq_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def fill_cache(cfg: ModelConfig, cache: Params, pcache: Params) -> Params:
    """Copy a prefill's cache into a decode cache from `init_cache`, each
    leaf cast to the decode cache's dtype (RWKV's state stays float32):
    the keys and values into positions 0..S-1, RWKV's state whole.
    Returns `cache`."""
    for key, src in pcache.items():
        if cfg.rwkv:
            cache[key].copy_(src)
        else:
            cache[key][:, :, :src.shape[2]] = src
    return cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params, tokens,
                pos: int):
    """One token for the whole batch. tokens: (B, 1); pos: int index.
    Writes the step's k (after RoPE) and v into `cache` at `pos`, in place;
    an RWKV model updates its state and token shifts in place instead, by
    the exact recurrence (no kernel, as in the reference).

    Returns (logits (B, 1, V), cache)."""
    _check_supported(cfg)
    B = tokens.shape[0]
    x = _embed_tokens(cfg, params, tokens, _dtype(cfg))
    positions = torch.full((B, 1), pos, device=x.device)
    for i in range(cfg.num_layers):
        p = _layer(params["layers"], i)
        if cfg.rwkv:
            layer_cache = {k: c[i] for k, c in cache.items()}
            x, new = _rwkv_layer(cfg, p, x, layer_cache, chunked=False)
            for k, c in layer_cache.items():
                c.copy_(new[k])
            continue
        kc, vc = cache["k"][i], cache["v"][i]
        h = norm_apply(cfg, x, p["norm1"])
        q, k, v = _qkv(cfg, p["attn"], h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
        a = decode_attention(q, kc, vc, pos, window=cfg.window,
                             is_global=cfg.is_global_layer(i))
        x = x + a.reshape(B, 1, cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
        h2 = norm_apply(cfg, x, p["norm2"])
        ff, _ = _ffn(cfg, p, h2)
        x = x + ff
    x = norm_apply(cfg, x, params["final_norm"])
    return unembed(cfg, params, x), cache
