"""Group-local sort-based Mixture-of-Experts (`repro/models/lm/moe.py`),
on one device.

Tokens are reshaped into G static dispatch groups (~4096 tokens each).
Each group routes its tokens (softmax router in float32, top-k,
renormalised), sorts its T_g * K assignments by expert (stably) and packs
them into fixed-capacity expert slots; assignments past an expert's
capacity are dropped. The expert matmuls run through the hand-written
grouped matmul (`kernels/moe_gmm`), where the reference writes three
einsums (`moe.py:125-127`): one gated launch gives silu(x wg) * (x wu) in
the compute dtype, one more the down product, both skipping the slots no
token fills. Each token sums its K weighted expert outputs.

Layout. The reference's dispatch buffer is (G, E, C, d); the port's is
(E, G, C, d), viewed as (E, G * C, d), so that one kernel launch covers
every group: group g's slot `e * C + slot` lands at row
`e * (G * C) + g * C + slot`. The buffer is built by one row gather
(each row names the token it holds, or a zero row), and dropped
assignments write their token index to one spare row that is sliced off.

Determinism. The reference combines with a scatter-add in the compute
dtype over the assignments in sorted order, from zeros. Each token's
assignments appear there in ascending expert order, so the port gathers a
token's K contributions in that order and adds them one by one: the same
sums, with no atomics (`index_add_` on CUDA would add bf16 values in a
different order on every run). The reference's sharding constraints
(`shd.act_*`) are no-ops off a mesh and are dropped.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm.ops import moe_gmm, moe_gmm_gated
from repro_torch.models.lm.common import dense_init

GROUP_TOKENS = 4096          # target tokens per dispatch group


def moe_group_count(T: int) -> int:
    """Dispatch groups of ~GROUP_TOKENS tokens. The reference's mesh term
    is 1 off a mesh, which leaves T // 4096 when 4096 divides T, else 1."""
    if T % GROUP_TOKENS == 0:
        return T // GROUP_TOKENS
    return 1


def moe_capacity(T_g: int, cfg) -> int:
    c = int(T_g * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def moe_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """One layer's MoE leaves and their shapes (`moe.py:46-62`); each is
    LeCun-normal over its second-to-last axis."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    shapes = {"router": (d, E), "wg": (E, d, f), "wu": (E, d, f),
              "wd": (E, f, d)}
    if cfg.shared_d_ff:
        sf = cfg.shared_d_ff
        shapes.update(swg=(d, sf), swu=(d, sf), swd=(sf, d), sgate=(d, 1))
    return shapes


def init_moe(gen: torch.Generator, cfg) -> Dict[str, torch.Tensor]:
    """One layer's MoE parameters in float32, drawn from `gen`."""
    return {k: dense_init(gen, s) for k, s in moe_shapes(cfg).items()}


def route(topi: torch.Tensor, num_experts: int, capacity: int):
    """The reference's per-group `route` (`moe.py:90-98`), batched over
    groups. topi (G, T_g, K) -> (order, slot, keep, dest), each
    (G, T_g * K) over the assignments in sorted order: `order` the stable
    argsort of the flattened expert ids, `slot` the position within its
    expert, `keep` slot < capacity, `dest` expert * capacity + slot, or
    E * capacity when dropped."""
    G, Tg, K = topi.shape
    E, C = num_experts, capacity
    dev = topi.device
    flat_e = topi.reshape(G, Tg * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev).expand(G, E).contiguous())
    slot = torch.arange(Tg * K, device=dev) - torch.gather(starts, 1,
                                                           sorted_e)
    keep = slot < C
    dest = torch.where(keep, sorted_e * C + slot, E * C)
    return order, slot, keep, dest


def moe_ffn(x: torch.Tensor, p, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) token-major, in the compute dtype. Returns (out (T, d),
    the load-balancing aux loss, a float32 scalar)."""
    T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    G = moe_group_count(T)
    Tg = T // G
    C = moe_capacity(Tg, cfg)
    GC = G * C
    dt = x.dtype
    dev = x.device

    xr = x.reshape(G, Tg, d)
    logits = xr.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                       # (G,Tg,E)
    topv, topi = torch.topk(probs, K, dim=-1)                   # (G,Tg,K)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # ---- load-balancing aux (Switch-style), per group; exact counts ----
    groups = torch.arange(G, device=dev)
    counts = torch.bincount((topi + E * groups[:, None, None]).reshape(-1),
                            minlength=G * E).reshape(G, E)
    frac_tokens = counts.to(torch.float32) / Tg
    frac_probs = torch.mean(probs, dim=1)
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, -1)) \
        * cfg.router_aux_coef

    # ---- dispatch: each assignment's buffer row, in (token, k) order ----
    order, slot, _, _ = route(topi, E, C)
    slot_f = torch.empty_like(slot).scatter_(1, order, slot)
    keep_f = slot_f < C
    row_f = torch.where(keep_f, topi.reshape(G, Tg * K) * GC
                        + groups[:, None] * C + slot_f, E * GC)
    token_f = groups[:, None] * Tg + torch.arange(Tg * K, device=dev) // K
    src = torch.full((E * GC + 1,), T, dtype=torch.long, device=dev)
    src[row_f.reshape(-1)] = token_f.reshape(-1)    # drops: the spare row
    xe = torch.cat([x, x.new_zeros((1, d))])[src[:-1]].view(E, GC, d)

    # ---- grouped expert matmul: the gated one gives h, then the down
    # product, each output in the compute dtype as the reference's einsums
    # return it. occ[e, g]: group g's occupied slots of expert e (slots
    # fill from 0; past them the buffer is zero, and so is h), built on
    # the device ----
    occ = counts.clamp(max=C).T.contiguous().to(torch.int32)
    h = moe_gmm_gated(xe, p["wg"].to(dt), p["wu"].to(dt), rows=occ)
    og = moe_gmm(h, p["wd"].to(dt), rows=occ, out_dtype=dt).view(E * GC, d)

    # ---- combine: each token's K weighted outputs in ascending expert
    # order, added one by one from zeros in the compute dtype ----
    _, perm = torch.sort(topi, dim=-1)      # a token's experts are distinct
    row_k = torch.gather(row_f.view(G, Tg, K), 2, perm)
    keep_k = torch.gather(keep_f.view(G, Tg, K), 2, perm)
    w_k = torch.gather(topv, 2, perm).to(dt)
    y = torch.zeros((G, Tg, d), dtype=dt, device=dev)
    for j in range(K):
        kept = keep_k[..., j]
        yj = og[torch.where(kept, row_k[..., j], 0)] * kept[..., None].to(dt)
        y = y + yj * w_k[..., j, None]
    y = y.reshape(T, d)

    # ---- shared expert (qwen2-moe) ----
    if cfg.shared_d_ff:
        hs = F.silu(x @ p["swg"].to(dt)) * (x @ p["swu"].to(dt))
        ys = hs @ p["swd"].to(dt)
        gate = torch.sigmoid((x @ p["sgate"].to(dt)).to(torch.float32))
        y = y + ys * gate.to(dt)
    return y, aux


def _mm(a, b):
    """a @ b in the promoted dtype, as jnp's matmul promotes mixed ones."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def moe_ref(x, p, cfg):
    """Dense per-expert oracle (no capacity drops) for small-shape tests
    (`moe.py:155-174`)."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        h = F.silu(_mm(x, p["wg"][e])) * _mm(x, p["wu"][e])
        oe = _mm(h, p["wd"][e])
        w = torch.sum(torch.where(topi == e, topv, 0.0), dim=-1)
        y = y + oe.to(torch.float32) * w[:, None]
    if cfg.shared_d_ff:
        hs = F.silu(_mm(x, p["swg"])) * _mm(x, p["swu"])
        ys = _mm(hs, p["swd"])
        gate = torch.sigmoid(_mm(x, p["sgate"]))
        y = y + ys * gate
    return y.to(x.dtype)
