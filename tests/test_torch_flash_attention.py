"""The port's flash-attention forward (`repro_torch.kernels.flash_attention`)
against the JAX reference on the CPU, where the wrapper takes its plain
version (`ref.attention_ref`): the Pallas op in interpret mode, as
`tests/test_kernels.py` runs it, the reference's `attention_ref`, and its
jnp `flash_attention` twin for lengths the Pallas tiles do not divide.
Tolerances are the reference's own: 2e-5 in float32, 2e-2 in bfloat16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_op as jax_op
from repro.models.lm import attention as jax_attention
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention_bwd_ref)
from repro_torch.models.lm.attention import flash_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, sq, skv, h, kh, d, dtype):
    """q, k, v as (jax, torch) pairs of the same values."""
    rng = np.random.default_rng((seed, 16))
    arrs = [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for s, n in ((sq, h), (skv, kh), (skv, kh))]
    jx = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]
    tc = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tc


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# (b, s, h, g, d, causal): each of the reference's values (b {1,2},
# s {32,64}, h {2,4}, g {1,2}, d {16,32}, causal on and off) in both dtypes
CASES = [(1, 32, 2, 1, 16, True), (2, 64, 4, 2, 32, True),
         (1, 64, 4, 2, 16, False), (2, 32, 2, 2, 32, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_op(case, dtype):
    b, s, h, g, d, causal = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(sum(case), b, s, s, h, h // g, d,
                                         dtype)
    want = jax_op(jq, jk, jv, causal=causal, bq=32, bk=32)
    _close(flash_attention_op(tq, tk, tv, causal=causal), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliding_window_matches_pallas_op(dtype):
    """The reference's window case: local layer, window 16 of 64."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 2, 64, 64, 4, 2, 16, dtype)
    kw = dict(causal=True, window=16, is_global=False)
    want = jax_op(jq, jk, jv, bq=32, bk=32, **kw)
    _close(flash_attention_op(tq, tk, tv, **kw), want, dtype)


@pytest.mark.parametrize("is_global", [True, False])
def test_q_offset_with_a_longer_key_sequence(is_global):
    """Sq < Skv: the queries are the last 32 positions of 64."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 2, 32, 64, 4, 1, 16, "float32")
    kw = dict(causal=True, window=16, is_global=is_global, q_offset=32)
    want = jax_op(jq, jk, jv, bq=32, bk=32, **kw)
    _close(flash_attention_op(tq, tk, tv, **kw), want, "float32")
    _close(flash_attention_op(tq, tk, tv, **kw),
           jax_attention.attention_ref(jq, jk, jv, **kw), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [40, 47])
@pytest.mark.parametrize("is_global", [True, False])
def test_ragged_lengths_match_attention_ref_and_jnp_twin(s, is_global, dtype):
    """Lengths the Pallas tiles do not divide (it asserts): held against
    `attention_ref` and the jnp `flash_attention` the model calls."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(s, 2, s, s, 4, 2, 16, dtype)
    kw = dict(causal=True, window=16, is_global=is_global)
    got = flash_attention(tq, tk, tv, **kw)
    _close(got, jax_attention.attention_ref(jq, jk, jv, **kw), dtype)
    _close(got, jax_attention.flash_attention(jq, jk, jv, **kw), dtype)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    kernel.reset_launches()
    _, (q, k, v) = _inputs(3, 1, 40, 40, 4, 1, 16, "bfloat16")
    kw = dict(window=16, is_global=False)
    out = kernel.flash_attention_fwd(q, k, v, **kw)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert kernel.LAUNCHES == {"flash_attention_fwd": 0,
                               "flash_attention_bwd": 0}
    assert kernel.ROUTES == {"tensor_core": 0, "simt": 0}
    kernel.flash_attention_bwd(q, k, v, out, attention_lse_ref(q, k, **kw),
                               torch.ones_like(out), **kw)
    assert kernel.BWD_ROUTES == {"tensor_core": 0, "simt": 0}
    assert kernel.LAUNCHES["flash_attention_bwd"] == 0


def test_the_op_trains_through_its_backward():
    """An input that requires grad no longer raises: the op trains
    through its backward (plain versions on the CPU) and q's gradient
    equals `flash_attention_bwd_ref`'s; under no_grad it is the forward
    alone, the same output."""
    _, (q, k, v) = _inputs(4, 1, 32, 32, 2, 1, 16, "float32")
    q.requires_grad_(True)
    out = flash_attention(q, k, v)
    out.backward(torch.ones_like(out))
    with torch.no_grad():
        assert torch.equal(flash_attention(q, k, v), out.detach())
    lse = attention_lse_ref(q.detach(), k)
    dq, _, _ = flash_attention_bwd_ref(q.detach(), k, v, out.detach(), lse,
                                       torch.ones_like(out))
    torch.testing.assert_close(q.grad, dq, rtol=0, atol=0)


# The emulation of the tensor-core kernel's rounding points
# (`attention_ref(..., p_bf16=True)`): p rounded to bf16 before P V, l from
# the unrounded p. Each weight then carries a relative error of at most
# 2^-8 (bf16 keeps 8 significant bits), so the output moves by at most
# 2^-8 max|v| from the float32 softmax; a bf16 output adds its own
# rounding, at most 2^-8 of each side (2^-7 |ref| in all). kv_tile None
# rounds at the row's final max, 32 at the running max of 32-key tiles.
def _bound(ref, v, dtype):
    b = 2.0 ** -8 * float(v.float().abs().max()) + 1e-6
    return b + (2.0 ** -7 * ref.float().abs() if dtype == "bfloat16" else 0)


@pytest.mark.parametrize("kv_tile", [None, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False),
    dict(causal=True, window=16, is_global=False),
    dict(causal=True, window=16, is_global=False, q_offset=32),
    dict(causal=False, window=8, is_global=False, q_offset=60)])
def test_p_bf16_emulation_within_its_bound_of_attention_ref(kw, dtype,
                                                            kv_tile):
    """Lengths no tile divides (47 queries over 71 keys); the last case
    has rows that see no key (the reference's uniform average)."""
    _, (q, k, v) = _inputs(7, 2, 47, 71, 4, 2, 16, dtype)
    ref = attention_ref(q, k, v, **kw)
    emu = attention_ref(q, k, v, p_bf16=True, kv_tile=kv_tile, **kw)
    assert emu.dtype == q.dtype and emu.shape == q.shape
    diff = (emu.float() - ref.float()).abs()
    assert bool((diff <= _bound(ref, v, dtype)).all())
    assert float(diff.max()) > 0          # it does round


@pytest.mark.parametrize("case", CASES)
def test_p_bf16_emulation_matches_pallas_op_on_bf16_values(case):
    """q, k, v rounded to bf16 first, then given in float32 to the Pallas
    op in interpret mode (float32 p, as on the CPU) and to the emulation:
    within 2^-8 max|v| plus the reference's float32 tolerance."""
    b, s, h, g, d, causal = case
    rng = np.random.default_rng((sum(case), 17))
    arrs = [torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(
        np.float32)).bfloat16().float() for n in (h, h // g, h // g)]
    want = jax_op(*(jnp.asarray(a.numpy()) for a in arrs), causal=causal,
                  bq=32, bk=32)
    emu = attention_ref(*arrs, causal=causal, p_bf16=True, kv_tile=32)
    diff = np.abs(emu.numpy() - np.asarray(want, np.float32))
    assert diff.max() <= 2.0 ** -8 * float(arrs[2].abs().max()) + TOL[
        "float32"]


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=16,
                                     is_global=False, q_offset=32)])
def test_p_bf16_off_is_attention_ref_bit_for_bit(kw):
    for dtype in ("float32", "bfloat16"):
        _, (q, k, v) = _inputs(8, 2, 32, 64, 4, 1, 16, dtype)
        assert torch.equal(attention_ref(q, k, v, p_bf16=False, **kw),
                           attention_ref(q, k, v, **kw))
    with pytest.raises(ValueError, match="p_bf16"):
        attention_ref(q, k, v, kv_tile=32, **kw)


def test_route_picks_the_kernel_from_dtype_head_dim_and_alignment():
    """The choice is made from the tensors alone, so it is tested here:
    bf16 at D 64, 128 and 256 with 16-byte aligned pointers takes the
    tensor-core kernel; float32, other head dims and a pointer off a
    16-byte boundary take the SIMT kernel."""
    def qkv(d, dtype=torch.bfloat16, offset=0):
        flat = torch.zeros(offset + 4 * 8 * 4 * d, dtype=dtype)
        q = flat[offset:].view(4, 8, 4, d)
        k = torch.zeros((4, 8, 2, d), dtype=dtype)
        return q, k, k.clone()

    for d in kernel.TC_HEAD_DIMS:
        assert kernel.route(*qkv(d)) == "tensor_core"
        assert kernel.route(*qkv(d, torch.float32)) == "simt"
        assert kernel.route(*qkv(d, offset=1)) == "simt"
    for d in (16, 32, 100, 192):
        assert kernel.route(*qkv(d)) == "simt"
    assert [kernel.tc_kv_tile(d) for d in kernel.TC_HEAD_DIMS] == [128, 128,
                                                                   64]


def test_bwd_route_picks_the_kernel_as_the_forward_does():
    """The backward's choice: the forward's rule on q, k, v, with out and
    dout 16-byte aligned too (TMA reads dout; the tensor-core kernel takes
    every pointer aligned)."""
    def t(d, dtype=torch.bfloat16, offset=0, heads=4):
        flat = torch.zeros(offset + 4 * 8 * heads * d, dtype=dtype)
        return flat[offset:].view(4, 8, heads, d)

    for d in kernel.TC_HEAD_DIMS:
        q, k, v, out, dout = t(d), t(d, heads=2), t(d, heads=2), t(d), t(d)
        assert kernel.bwd_route(q, k, v, out, dout) == "tensor_core"
        assert kernel.bwd_route(q, k, v, out, t(d, offset=1)) == "simt"
        assert kernel.bwd_route(q, k, v, t(d, offset=1), dout) == "simt"
        assert kernel.bwd_route(t(d, offset=1), k, v, out, dout) == "simt"
        f = [x.float() for x in (q, k, v, out, dout)]
        assert kernel.bwd_route(*f) == "simt"
    for d in (16, 48, 100, 192):
        assert kernel.bwd_route(t(d), t(d, heads=2), t(d, heads=2), t(d),
                                t(d)) == "simt"
