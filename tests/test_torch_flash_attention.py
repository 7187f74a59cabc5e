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
    out = kernel.flash_attention_fwd(q, k, v, window=16, is_global=False)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert kernel.LAUNCHES == {"flash_attention_fwd": 0}


def test_an_input_that_requires_grad_raises():
    """Forward only: training through the kernel is a later slice."""
    _, (q, k, v) = _inputs(4, 1, 32, 32, 2, 1, 16, "float32")
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape
