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

Training. A buffer row holds at most one (token, k) assignment, so the
dispatch and the combine are each other's transposes, and both backward
passes are gathers (`_Dispatch`, `_Combine`): the dispatch's gradient
adds a token's kept rows one by one in ascending expert order from zeros
in the compute dtype (the order in which the reference's scatter-add over
the sorted assignments meets them); the combine's gives each occupied row
its one assignment's weight times its token's gradient, each weight the
dot product of its token's gradient and its row. A token's weights in
ascending expert order are a permutation of its top-k weights
(`_PermuteLast`), whose backward is the inverse permutation. Nothing in
the layer's backward scatters with accumulation; the router's top-k
(`top_k`, in `jax.lax.top_k`'s order among ties) writes each selected
position's gradient once. The expert
products' backward is the grouped matmul's (`kernels/moe_gmm/ops.py`).
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


class _Dispatch(torch.autograd.Function):
    """xe = [x; 0][src]: each buffer row the token it holds, or zeros. Its
    backward: dx[t] = the sum of dxe over the token's kept rows row_k[t, j]
    (ascending expert order), added one by one from zeros."""

    @staticmethod
    def forward(ctx, x, src, row_k, keep_k):
        ctx.save_for_backward(row_k, keep_k)
        return torch.cat([x, x.new_zeros((1, x.shape[1]))])[src]

    @staticmethod
    def backward(ctx, dxe):
        row_k, keep_k = ctx.saved_tensors
        dx = dxe.new_zeros((row_k.shape[0], dxe.shape[1]))
        for j in range(row_k.shape[1]):
            kept = keep_k[:, j, None]
            rows = dxe.index_select(0, torch.where(keep_k[:, j], row_k[:, j],
                                                   0))
            dx = dx + torch.where(kept, rows, torch.zeros_like(rows))
        return dx, None, None, None


class _Combine(torch.autograd.Function):
    """y[t] = sum over j of keep_k[t, j] * og[row_k[t, j]] * w_k[t, j], added
    one by one in j order from zeros in og's dtype. Its backward: dog[r] =
    w * dy[token] for the assignment row r holds (`asg[r]`, the flat (t, j)
    index, or T * K for an empty row, which gets zeros), and dw_k[t, j] =
    <dy[t], og[row_k[t, j]]> summed in float32 (zero when dropped)."""

    @staticmethod
    def forward(ctx, og, w_k, row_k, keep_k, asg):
        ctx.save_for_backward(og, w_k, row_k, keep_k, asg)
        y = og.new_zeros((row_k.shape[0], og.shape[1]))
        for j in range(row_k.shape[1]):
            kept = keep_k[:, j]
            yj = og[torch.where(kept, row_k[:, j], 0)] * \
                kept[:, None].to(og.dtype)
            y = y + yj * w_k[:, j, None]
        return y

    @staticmethod
    def backward(ctx, dy):
        og, w_k, row_k, keep_k, asg = ctx.saved_tensors
        T, K = row_k.shape
        dy = dy.contiguous()
        held = asg < T * K
        a = torch.where(held, asg, 0)
        dyr = dy.index_select(0, a // K) * w_k.reshape(-1)[a][:, None]
        dog = torch.where(held[:, None], dyr, torch.zeros_like(dyr))
        del dyr
        dyf = dy.to(torch.float32)
        dw = torch.zeros((T, K), dtype=torch.float32, device=dy.device)
        for j in range(K):
            kept = keep_k[:, j]
            rows = og.index_select(0, torch.where(kept, row_k[:, j], 0))
            dot = (dyf * rows.to(torch.float32)).sum(-1)
            dw[:, j] = torch.where(kept, dot, torch.zeros_like(dot))
        return dog, dw.to(w_k.dtype), None, None, None


class _Select(torch.autograd.Function):
    """t gathered along its last axis at `idx` (distinct per row); the
    backward writes each gradient to its one position, zeros elsewhere
    (a scatter with no accumulation, as `torch.topk`'s own backward)."""

    @staticmethod
    def forward(ctx, t, idx):
        ctx.save_for_backward(idx)
        ctx.shape = t.shape
        return torch.gather(t, -1, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return g.new_zeros(ctx.shape).scatter(-1, idx, g), None


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row of `probs`
    (float32, >= 0) along its last axis: values descending, the lower
    index first among equal values, as `jax.lax.top_k` returns them.
    `torch.topk` promises no order among ties, and a tie across the k-th
    place changes a token's expert set, so it selects on keys made
    distinct: each value's bits (monotone for non-negative floats) above
    E - 1 - its index. The values are `probs` gathered at the indices, bit
    for bit."""
    E = probs.shape[-1]
    shift = max(E - 1, 1).bit_length()
    rank = torch.arange(E - 1, -1, -1, dtype=torch.int64,
                        device=probs.device)
    keys = (probs.view(torch.int32).to(torch.int64) << shift) | rank
    idx = torch.topk(keys, k, dim=-1)[1]
    return _Select.apply(probs, idx), idx


class _PermuteLast(torch.autograd.Function):
    """t gathered along its last axis by `perm` (a permutation of it per
    row); the backward gathers by the inverse permutation."""

    @staticmethod
    def forward(ctx, t, perm):
        ctx.save_for_backward(perm)
        return torch.gather(t, -1, perm)

    @staticmethod
    def backward(ctx, g):
        perm, = ctx.saved_tensors
        return torch.gather(g, -1, torch.argsort(perm, dim=-1)), None


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
    topv, topi = top_k(probs, K)                                # (G,Tg,K)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # ---- load-balancing aux (Switch-style), per group; exact counts ----
    groups = torch.arange(G, device=dev)
    counts = torch.bincount((topi + E * groups[:, None, None]).reshape(-1),
                            minlength=G * E).reshape(G, E)
    frac_tokens = counts.to(torch.float32) / Tg
    frac_probs = torch.mean(probs, dim=1)
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, -1)) \
        * cfg.router_aux_coef

    # ---- dispatch: each assignment's buffer row, in (token, k) order;
    # then per token in ascending expert order (a token's experts are
    # distinct), and for each buffer row its assignment's flat index in
    # that order (T * K: empty; drops all land on the spare row) ----
    order, slot, _, _ = route(topi, E, C)
    slot_f = torch.empty_like(slot).scatter_(1, order, slot)
    keep_f = slot_f < C
    row_f = torch.where(keep_f, topi.reshape(G, Tg * K) * GC
                        + groups[:, None] * C + slot_f, E * GC)
    _, perm = torch.sort(topi, dim=-1)
    row_k = torch.gather(row_f.view(G, Tg, K), 2, perm).reshape(T, K)
    keep_k = torch.gather(keep_f.view(G, Tg, K), 2, perm).reshape(T, K)
    asg = torch.full((E * GC + 1,), T * K, dtype=torch.long, device=dev)
    asg[row_k.reshape(-1)] = torch.arange(T * K, device=dev)
    asg = asg[:-1]
    xe = _Dispatch.apply(x, asg // K, row_k, keep_k).view(E, GC, d)

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
    w_k = _PermuteLast.apply(topv, perm).reshape(T, K).to(dt)
    y = _Combine.apply(og, w_k, row_k, keep_k, asg)

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
    topv, topi = top_k(probs, cfg.top_k)
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
