"""The port's LM training path (`repro_torch.train.{train_step,lm_loop}`,
`train.losses.chunked_cross_entropy`, `optim.{adamw,compression}`,
`data.pipeline`, the flash backward's plain version, `launch.train`'s LM
branch) against the JAX reference on the CPU, at gemma3-1b's reduced
widths (4 layers, d 64, 4 heads over 2 KV heads, head_dim 16, window 16).

Float32 parity: the chunked CE's value and grads within rtol 1e-5; the
flash backward within 1e-5 of `jax.vjp`; 5 train steps' losses and grad
norms within rtol 1e-4 (sums in another order); batches, clipping,
compression and checkpoints exactly equal. Port against port: remat on
and off, and resume, bit for bit."""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as RefTrainConfig
from repro.configs.registry import get_config
from repro.data import pipeline as ref_pipeline
from repro.models.lm import attention as jax_attention
from repro.models.lm import transformer as jax_tf
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_compression
from repro.train import losses as ref_losses
from repro.train import train_step as ref_train_step
from repro.train.lm_loop import LMTrainer as RefLMTrainer
from repro_torch.configs import LM_CONFIGS, TrainConfig
from repro_torch.data import pipeline
from repro_torch.kernels.flash_attention.ref import (_mask,
                                                     attention_lse_ref,
                                                     flash_attention_bwd_ref)
from repro_torch.launch import train as train_cli
from repro_torch.models.lm import transformer
from repro_torch.models.lm.attention import flash_attention
from repro_torch.optim import adamw, compression
from repro_torch.train import train_step
from repro_torch.train.losses import chunked_cross_entropy
from repro_torch.train.lm_loop import LMTrainer

CFG = LM_CONFIGS["gemma3-1b"].reduced()
F32 = CFG.scaled(dtype="float32")
REF_F32 = get_config("gemma3-1b").reduced().scaled(dtype="float32")
B, S = 4, 32


def numpy_params(cfg, seed):
    """The reference's tree (its `init`'s shapes), drawn with numpy:
    weights LeCun-scaled, the embedding at 0.5, norm scales at 0.3."""
    shapes = jax.eval_shape(lambda k: jax_tf.init(cfg, k), jax.random.key(0))
    rng = np.random.default_rng((seed, 31))

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.normal(size=s.shape).astype(np.float32)
        if "norm" in name or name == "scale":
            return z * np.float32(0.3)
        if name == "embed":
            return z * np.float32(0.5)
        return z / np.float32(np.sqrt(s.shape[-2]))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def batches(n, batch=B, seq=S, seed=0):
    corpus = pipeline.SyntheticTokens(CFG.vocab_size, num_docs=64,
                                      doc_len=2 * seq, seed=seed)
    it = iter(pipeline.LMStream(corpus, batch, seq))
    return [next(it) for _ in range(n)]


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() + 1e-30))


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", [1024, 48])
def test_chunked_cross_entropy_matches_the_reference(seq):
    """Value and grads (hidden, head) in float32, S a multiple of the
    512-token chunk (two chunks) and not (one), with a mask."""
    rng = np.random.default_rng((seq, 1))
    h = rng.normal(size=(2, seq, 16)).astype(np.float32)
    head = rng.normal(size=(16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, seq)).astype(np.int32)
    mask = (rng.random((2, seq)) < 0.8).astype(np.float32)
    want, (gh, ghead) = jax.value_and_grad(
        lambda a, b: ref_losses.chunked_cross_entropy(a, b, labels, mask),
        argnums=(0, 1))(h, head)
    th = torch.tensor(h, requires_grad=True)
    thead = torch.tensor(head, requires_grad=True)
    got = chunked_cross_entropy(th, thead, torch.from_numpy(labels),
                                torch.from_numpy(mask))
    got.backward()
    _close(got, want, 1e-5)
    _close(th.grad, gh, 1e-5)
    _close(thead.grad, ghead, 1e-5)


# ---------------------------------------------------------------------------
# the flash backward's plain version and the op's autograd
# ---------------------------------------------------------------------------
# (B, S, H, KH, D, causal, window, is_global): G 1, 2 and 4, causal / window
# / global / non-causal, lengths no tile divides, D 16 and 64, and S 1024
# (the reference's backward then walks two 512-key chunks)
BWD_CASES = [(2, 40, 4, 4, 16, True, 16, False),
             (2, 40, 4, 2, 16, True, 16, False),
             (1, 33, 4, 1, 64, True, 1 << 30, True),
             (1, 47, 4, 1, 16, True, 8, False),
             (1, 1024, 2, 1, 16, True, 100, False),
             (1, 24, 2, 2, 64, False, 1 << 30, True)]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_matches_jax_vjp(case):
    """`flash_attention` (the op's autograd: the plain forward with lse,
    then `flash_attention_bwd_ref`) against `jax.vjp` of the reference's
    custom-VJP `flash_attention`, float32, 1e-5 of the largest value."""
    b, s, h, kh, d, causal, window, is_global = case
    rng = np.random.default_rng((s, h, kh, d))
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, kh, d)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, is_global=is_global)
    out, vjp = jax.vjp(lambda x, y, z: jax_attention.flash_attention(
        x, y, z, **kw), q, k, v)
    want = vjp(do)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    got = flash_attention(*leaves, **kw)
    got.backward(torch.from_numpy(do))
    _close(got, out, 1e-5)
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w, 1e-5)
    # the plain backward called directly gives the same gradients
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    direct = flash_attention_bwd_ref(tq, tk, tv, got.detach(),
                                     attention_lse_ref(tq, tk, **kw),
                                     torch.from_numpy(do), **kw)
    for leaf, g in zip(leaves, direct):
        assert torch.equal(leaf.grad, g)
    # the emulation flag off is the same function, bit for bit
    off = flash_attention_bwd_ref(tq, tk, tv, got.detach(),
                                  attention_lse_ref(tq, tk, **kw),
                                  torch.from_numpy(do), pds_bf16=False, **kw)
    assert all(torch.equal(a, b) for a, b in zip(off, direct))


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_emulation_stays_near_jax_vjp(case):
    """`flash_attention_bwd_ref(..., pds_bf16=True)`, the tensor-core
    kernel's rounding points, on bf16-valued float32 inputs against
    `jax.vjp` of the reference's `flash_attention` on the same values:
    within 1e-2 of the largest |grad|. Rounding p and ds to bf16 moves
    each term of the dv, dk and dq sums by at most 2^-9 of itself; summed
    with mixed signs that stays far below 1e-2 of the largest gradient.
    The flag must change the result (it rounds something)."""
    b, s, h, kh, d, causal, window, is_global = case
    rng = np.random.default_rng((s, h, kh, d, 2))

    def bf16_values(shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.to(torch.bfloat16).float()

    tq, tdo = bf16_values((b, s, h, d)), bf16_values((b, s, h, d))
    tk, tv = bf16_values((b, s, kh, d)), bf16_values((b, s, kh, d))
    kw = dict(causal=causal, window=window, is_global=is_global)
    out, vjp = jax.vjp(lambda x, y, z: jax_attention.flash_attention(
        x, y, z, **kw), tq.numpy(), tk.numpy(), tv.numpy())
    want = vjp(tdo.numpy())
    tout = torch.from_numpy(np.array(out))
    lse = attention_lse_ref(tq, tk, **kw)
    emu = flash_attention_bwd_ref(tq, tk, tv, tout, lse, tdo, pds_bf16=True,
                                  **kw)
    plain = flash_attention_bwd_ref(tq, tk, tv, tout, lse, tdo, **kw)
    for g, w in zip(emu, want):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-2 * float(np.abs(w).max()), err
    assert not all(torch.equal(a, b) for a, b in zip(emu, plain))


def _visited(Sq, Skv, BQ, BK, causal, window, is_global, q_offset):
    """The (Q tile, KV tile) pairs that `csrc/flash_attention_bwd.cu`'s two
    kernels visit (its skip arithmetic, written out): dkdv's row range per
    KV tile and dq's tile range per Q tile, and whether the last row sees
    no key (then both keep every tile)."""
    p_last = q_offset + Sq - 1
    hi = min(Skv - 1, p_last) if causal else Skv - 1
    lo = 0 if is_global else max(0, p_last - window + 1)
    keep_all = lo > hi
    nq, nk = -(-Sq // BQ), -(-Skv // BK)
    kv = np.zeros((nq, nk), bool)
    qd = np.zeros((nq, nk), bool)
    for t in range(nk):
        k0, k1 = t * BK, min(t * BK + BK, Skv) - 1
        i_lo, i_hi = 0, Sq - 1
        if not keep_all:
            if causal:
                i_lo = max(i_lo, k0 - q_offset)
            if not is_global:
                i_hi = min(i_hi, k1 + window - 1 - q_offset)
        if i_lo <= i_hi:
            kv[i_lo // BQ:i_hi // BQ + 1, t] = True
    for qb in range(nq):
        q0 = qb * BQ
        p_first, p_end = q_offset + q0, q_offset + min(q0 + BQ, Sq) - 1
        if keep_all:
            qd[qb] = True
            continue
        hi = min(Skv - 1, p_end) if causal else Skv - 1
        lo = 0 if is_global else max(0, p_first - window + 1)
        if lo <= hi:
            qd[qb, lo // BK:hi // BK + 1] = True
    return kv, qd, keep_all


def _needed(Sq, Skv, BQ, BK, causal, window, is_global, q_offset):
    """(Q tile, KV tile) pairs of BQ x BK tiles that hold an unmasked
    pair, and those whose pairs within (Sq, Skv) are all unmasked (a row
    or key past the end reads zeros and is never written)."""
    m = _mask(q_offset + torch.arange(Sq), torch.arange(Skv), causal=causal,
              window=window, is_global=is_global).numpy()
    nq, nk = -(-Sq // BQ), -(-Skv // BK)
    out = []
    for fill in (False, True):
        pad = np.full((nq * BQ, nk * BK), fill)
        pad[:Sq, :Skv] = m
        out.append(pad.reshape(nq, BQ, nk, BK))
    return out[0].any(axis=(1, 3)), out[1].all(axis=(1, 3))


def _check_skips(case, kv_tiles, q_tiles):
    """The dk / dv kernel on `kv_tiles` (BQ, BK) and the dq kernel on
    `q_tiles` visit every tile pair that holds an unmasked pair; when some
    row sees no key, every tile. Returns dk / dv's visited and needed."""
    Sq, Skv, _, causal, window, is_global, q_offset = case
    kv, _, keep_all = _visited(Sq, Skv, *kv_tiles, causal, window,
                               is_global, q_offset)
    _, qd, _ = _visited(Sq, Skv, *q_tiles, causal, window, is_global,
                        q_offset)
    kv_need, _ = _needed(Sq, Skv, *kv_tiles, causal, window, is_global,
                         q_offset)
    q_need, _ = _needed(Sq, Skv, *q_tiles, causal, window, is_global,
                        q_offset)
    if keep_all:                # some row sees no key: nothing is skipped
        assert kv.all() and qd.all()
    assert not (kv_need & ~kv).any() and not (q_need & ~qd).any()
    return kv, kv_need


SKIP_CASES = [
    (4096, 4096, 32, True, 512, False, 0), (4096, 4096, 32, True, 1 << 30,
                                            True, 0),
    (130, 130, 32, True, 48, False, 0), (97, 161, 64, True, 1 << 30, True,
                                         64),
    (150, 120, 64, False, 40, False, 100), (33, 20, 64, True, 1, False, 30),
    (300, 300, 64, True, 1, False, 0), (70, 90, 32, False, 1 << 30, True,
                                        0)]


@pytest.mark.parametrize("case", SKIP_CASES)
def test_backward_kernel_tile_skips_drop_only_masked_pairs(case):
    """Every (query, key) pair the mask lets through lies in a tile pair
    that both SIMT backward kernels visit (64-row Q tiles, BK-key tiles:
    the kernel's own skip arithmetic, emulated); at gemma's local layers
    (S 4096, window 512) they visit about a quarter of the causal tile
    pairs."""
    BK = case[2]
    kv, _ = _check_skips(case, (64, BK), (64, BK))
    if case[:6] == (4096, 4096, 32, True, 512, False):
        nq, nk = kv.shape
        assert kv.sum() < 0.3 * np.tril(np.ones((nq, nk))).sum() * 2


def _tc_edges(Sq, Skv, BQ, BK, causal, window, is_global, q_offset,
              keep_all, dq):
    """The tile pairs that the tensor-core kernels mask element by element
    (`flash_attention_bwd.cu`'s `edge` rules written out): dk / dv (BQ-row
    Q tiles against a BK-key tile) and dq (BQ-row blocks, whose ragged last
    block is bounded by Sq)."""
    nq, nk = -(-Sq // BQ), -(-Skv // BK)
    edge = np.zeros((nq, nk), bool)
    for qt in range(nq):
        q0 = qt * BQ
        p_first = q_offset + q0
        p_last = q_offset + (min(q0 + BQ, Sq) if dq else q0 + BQ) - 1
        for t in range(nk):
            k0 = t * BK
            edge[qt, t] = (keep_all or k0 + BK > Skv
                           or (not dq and q0 + BQ > Sq)
                           or (causal and k0 + BK - 1 > p_first)
                           or (not is_global and p_last - k0 >= window))
    return edge


@pytest.mark.parametrize("case", SKIP_CASES)
def test_tensor_core_tile_skips_and_masks_drop_only_masked_pairs(case):
    """The tensor-core route's tiles: dk / dv over 64-key tiles and 64-row
    Q tiles, dq over 128-row blocks and BK-key tiles (64, or 32 at D 256:
    BK stands for the head dim). No unmasked pair falls in a skipped tile,
    and every visited tile that the kernels do not mask element by element
    holds only unmasked pairs in range."""
    Sq, Skv, BK, causal, window, is_global, q_offset = case
    kv, _ = _check_skips(case, (64, 64), (128, BK))
    keep_all = _visited(Sq, Skv, 64, 64, causal, window, is_global,
                        q_offset)[2]
    for (bq, bk), visited, dq in (((64, 64), kv, False),
                                  ((128, BK), _visited(
                                      Sq, Skv, 128, BK, causal, window,
                                      is_global, q_offset)[1], True)):
        _, full = _needed(Sq, Skv, bq, bk, causal, window, is_global,
                          q_offset)
        edge = _tc_edges(Sq, Skv, bq, bk, causal, window, is_global,
                         q_offset, keep_all, dq)
        assert not (visited & ~edge & ~full).any()


# ---------------------------------------------------------------------------
# the model forward, the step, the optimizer
# ---------------------------------------------------------------------------
def test_apply_remat_equals_no_remat_bit_for_bit():
    tree = transformer.params_from_jax(numpy_params(REF_F32, 1),
                                       device="cpu")
    toks = torch.from_numpy(batches(1)[0][0])
    outs = []
    for remat in (False, True):
        live = adamw.tree_map(lambda t: t.clone().requires_grad_(True), tree)
        h, aux = transformer.apply(F32, live, {"tokens": toks}, remat=remat)
        (h.square().sum() + aux).backward()
        outs.append((h.detach(), [t.grad for t in adamw.tree_leaves(live)]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("micro", [1, 2])
def test_train_steps_match_the_reference(micro):
    """5 steps of `make_train_step` from the same float32 parameters and
    batches: losses and grad norms within rtol 1e-4 of the reference's
    jitted step (remat, chunked CE, clip, AdamW), and the parameters
    after them."""
    tree = numpy_params(REF_F32, 2)
    tk = dict(learning_rate=1e-3, microbatches=micro)
    ref_step, _ = ref_train_step.make_train_step(REF_F32,
                                                 RefTrainConfig(**tk))
    step = train_step.make_train_step(F32, TrainConfig(**tk))
    jp = jax.tree.map(jnp.asarray, tree)
    jo = ref_adamw.init(jp)
    tp = transformer.params_from_jax(tree, device="cpu")
    to = adamw.init(tp)
    for toks, labels in batches(5):
        jp, jo, jm = ref_step(jp, jo, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels)})
        tp, to, tm = step(tp, to, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
        for key in ("loss", "ce", "grad_norm"):
            _close(tm[key], jm[key], 1e-4)
        assert int(to["count"]) == int(jo["count"])
    for got, want in zip(adamw.tree_leaves(tp), jax.tree.leaves(jp)):
        _close(got, want, 1e-4)


def test_microbatches_give_the_whole_batch_gradient():
    """`value_and_grad` with 2 microbatches: the mean loss and the
    gradient of the whole batch (sums in another order)."""
    tree = transformer.params_from_jax(numpy_params(REF_F32, 4),
                                       device="cpu")
    toks, labels = batches(1)[0]
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    one = train_step.value_and_grad(F32, tree, batch, True, 1)
    two = train_step.value_and_grad(F32, tree, batch, True, 2)
    _close(two[0], one[0].numpy(), 1e-5)
    for a, b in zip(adamw.tree_leaves(two[2]), adamw.tree_leaves(one[2])):
        _close(a, b.numpy(), 1e-4)


def test_clip_and_adamw_on_a_dict_tree_match_the_reference():
    rng = np.random.default_rng(5)
    tree = {"b": rng.normal(size=(3, 4)).astype(np.float32) * 4,
            "a": {"y": rng.normal(size=(7,)).astype(np.float32),
                  "x": rng.normal(size=(2, 2)).astype(np.float32)}}
    grads = jax.tree.map(lambda x: x * 3, tree)
    tg = adamw.tree_map(torch.from_numpy, grads)
    for max_norm in (1.0, 1e3):
        want, wn = ref_adamw.clip_by_global_norm(grads, max_norm)
        got, gn = adamw.clip_by_global_norm(tg, max_norm)
        _close(gn, wn, 1e-6)
        for a, b in zip(adamw.tree_leaves(got), jax.tree.leaves(want)):
            _close(a, b, 1e-6)
    tp = adamw.tree_map(torch.from_numpy, tree)
    new_p, state = adamw.update(tg, adamw.init(tp), tp, lr=1e-2,
                                weight_decay=5e-4)
    want_p, want_s = ref_adamw.update(grads, ref_adamw.init(tree), tree,
                                      lr=1e-2, weight_decay=5e-4)
    assert set(new_p) == set(tree) and set(state["m"]["a"]) == {"x", "y"}
    for a, b in zip(adamw.tree_leaves(new_p) + adamw.tree_leaves(state["v"]),
                    jax.tree.leaves(want_p) + jax.tree.leaves(want_s["v"])):
        _close(a, b, 1e-6)


def test_compression_matches_the_reference():
    """Two rounds of error-feedback int8 compression: the dequantized
    grads, the error buffers and the payload model equal the
    reference's."""
    rng = np.random.default_rng(6)
    grads = {"w": rng.normal(size=(31, 9)).astype(np.float32) * 50,
             "v": rng.normal(size=(256,)).astype(np.float32),
             "z": np.zeros((3,), np.float32)}
    terr, jerr = compression.init_error_feedback(
        adamw.tree_map(torch.from_numpy, grads)), \
        ref_compression.init_error_feedback(grads)
    for _ in range(2):
        tdeq, terr = compression.compress_decompress(
            adamw.tree_map(torch.from_numpy, grads), terr)
        jdeq, jerr = ref_compression.compress_decompress(grads, jerr)
        for a, b in zip(adamw.tree_leaves(tdeq) + adamw.tree_leaves(terr),
                        jax.tree.leaves(jdeq) + jax.tree.leaves(jerr)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    assert compression.compressed_bytes(
        adamw.tree_map(torch.from_numpy, grads)) == \
        ref_compression.compressed_bytes(grads)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["rand", "block", "none"])
def test_block_shuffler_matches_the_reference(mode):
    for epoch in (0, 3):
        got = pipeline.BlockShuffler(1000, 64, mode=mode, seed=2)
        want = ref_pipeline.BlockShuffler(1000, 64, mode=mode, seed=2)
        np.testing.assert_array_equal(got.epoch_order(epoch),
                                      want.epoch_order(epoch))


def test_lm_stream_batches_and_cursor_match_the_reference():
    got = pipeline.LMStream(pipeline.SyntheticTokens(512, 40, 48, seed=1),
                            4, 32)
    want = ref_pipeline.LMStream(
        ref_pipeline.SyntheticTokens(512, 40, 48, seed=1), 4, 32)
    for (gt, gl), (wt, wl) in zip(
            (next(it) for it in [iter(got)] * 13),
            (next(it) for it in [iter(want)] * 13)):
        assert gt.dtype == wt.dtype == np.int32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)
        assert got.cursor.state() == want.cursor.state()
    assert got.cursor.epoch == 1
    assert pipeline.Cursor.from_state({"epoch": 2, "pos": 4}).state() == \
        ref_pipeline.Cursor.from_state({"epoch": 2, "pos": 4}).state()


# ---------------------------------------------------------------------------
# the fault-tolerant trainer and the CLI
# ---------------------------------------------------------------------------
def _trainer(tmp, **tk):
    tcfg = TrainConfig(learning_rate=3e-3, remat=False, **tk)
    corpus = pipeline.SyntheticTokens(CFG.vocab_size, num_docs=128,
                                      doc_len=64)
    return LMTrainer(CFG, tcfg, pipeline.LMStream(corpus, batch=4, seq=32),
                     ckpt_dir=tmp, ckpt_every=4, device="cpu")


def test_lm_trainer_resume_is_exact():
    """8 steps straight against 4, a new trainer on the same directory
    (resumes at step 4, cursor included), 4 more: the same losses, bit for
    bit, and the same parameters."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        a = _trainer(d1)
        ra = a.run(8)
        b = _trainer(d2)
        b.run(4)
        del b
        b2 = _trainer(d2)
        assert b2.step == 4 and b2.stream.cursor.state() == \
            {"epoch": 0, "pos": 16}
        rb = b2.run(4)
        assert ra["losses"][4:] == rb["losses"]
        assert all(torch.equal(x, y) for x, y in zip(
            adamw.tree_leaves(a.params), adamw.tree_leaves(b2.params)))
        assert set(ra) == {"loss_first", "loss_last", "losses",
                           "straggler_fraction"}


def test_lm_checkpoint_is_the_reference_format():
    """A port checkpoint of `{"params", "opt", "err"}` restores in the
    reference's trainer: it resumes at the same step and cursor with the
    same parameters."""
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d, grad_compression=True)
        tr.run(2)
        ref_cfg = get_config("gemma3-1b").reduced()
        ref = RefLMTrainer(
            ref_cfg, RefTrainConfig(remat=False, grad_compression=True),
            ref_pipeline.LMStream(ref_pipeline.SyntheticTokens(
                ref_cfg.vocab_size, num_docs=128, doc_len=64), 4, 32),
            ckpt_dir=d)
        assert ref.step == 2
        assert ref.stream.cursor.state() == tr.stream.cursor.state()
        for a, b in zip(adamw.tree_leaves(tr.params),
                        jax.tree.leaves(ref.params)):
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


def test_fail_hook_retries_then_recovers():
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d)
        calls = {"n": 0}

        def hook(step):
            if step == 2 and calls["n"] < 2:
                calls["n"] += 1
                raise RuntimeError("injected")

        r = tr.run(4, fail_hook=hook)
        assert calls["n"] == 2 and tr.step == 4
        assert np.isfinite(r["loss_last"])


def test_rwkv_and_a_mesh_do_not_train_and_moe_does():
    """RWKV raises (its kernel has no backward yet) through
    `value_and_grad` and the CLI, and so does a mesh; the MoE config
    trains (`check_trainable` admits it; one CLI step)."""
    cfg = LM_CONFIGS["rwkv6-7b"].reduced()
    with pytest.raises(NotImplementedError, match="later slice"):
        train_step.value_and_grad(cfg, {}, {})
    with pytest.raises(NotImplementedError, match="later slice"):
        train_cli.main(["--arch", "rwkv6-7b", "--reduced", "--device",
                        "cpu", "--steps", "1"])
    transformer.check_trainable(LM_CONFIGS["qwen2-moe-a2.7b"])
    train_cli.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device",
                    "cpu", "--steps", "1", "--seq", "16", "--batch", "2"])
    with pytest.raises(NotImplementedError, match="distributed"):
        _trainer(None).__class__(CFG, TrainConfig(), None, mesh=object(),
                                 device="cpu")


def test_lm_cli_on_the_cpu(capsys, tmp_path):
    argv = ["--arch", "gemma3-1b", "--device", "cpu", "--reduced",
            "--steps", "3", "--seq", "16", "--batch", "2", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    train_cli.main(argv)
    out = capsys.readouterr().out
    assert "gemma3-1b: steps=3 loss" in out and "resumed" not in out
    train_cli.main(argv)
    assert "resumed from step 3" in capsys.readouterr().out
