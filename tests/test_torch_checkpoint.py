"""The port's checkpoints (`repro_torch.train.checkpoint`) have the
reference's on-disk format in both directions: for SAGE, GCN and GAT
(whose `w_out=None` layers make no leaf) and for a state holding a
`DynamicCacheState`, the port writes the same leaf paths, order, shapes,
dtypes and CRCs as `repro.train.checkpoint.save` for the same values; the
reference restores the port's files and the port the reference's, into
equal arrays. Corruption is detected as the reference detects it (bit
rot, a truncated leaf, a missing manifest, a leaf-count mismatch), and a
quote flipped in a `.npy` header — which makes numpy raise
`tokenize.TokenError` — is `CheckpointCorrupt` too."""
import json
import os
import tokenize

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.featcache.dynamic import DynamicCacheState as DynamicCacheStateJ
from repro.train import checkpoint as ckpt_j
from repro_torch.configs import GNNConfig
from repro_torch.featcache.dynamic import DynamicCacheState
from repro_torch.models.gnn.models import init_gnn, param_tree
from repro_torch.resilience import corrupt_checkpoint
from repro_torch.train import checkpoint as ckpt

EXTRA = {"cursor": {"epoch": 1, "pos": 3}, "fit": None, "cache_epoch": 1}


def _states(model: str, with_cache: bool, seed: int = 0):
    """The same trainer state as the port holds it (tensors in its
    `param_tree` layout) and as the reference holds it (jnp arrays)."""
    rng = np.random.default_rng((seed, 11))
    cfg = GNNConfig("t", model, 2, 8, 5, 3, fanout=(2, 2))
    net = init_gnn(cfg, torch.Generator().manual_seed(seed), "cpu")
    params = [p.detach() for p in net.parameters()]
    m = [torch.as_tensor(rng.normal(size=p.shape), dtype=torch.float32)
         for p in params]
    v = [torch.as_tensor(rng.random(p.shape), dtype=torch.float32)
         for p in params]
    best = [p + 1 for p in params]
    count = torch.tensor(7, dtype=torch.int32)
    port = {"params": param_tree(net, params),
            "opt": {"m": param_tree(net, m), "v": param_tree(net, v),
                    "count": count},
            "best": param_tree(net, best)}

    def jtree(ts):
        return {"layers": [{k: None if t is None else jnp.asarray(t.numpy())
                            for k, t in layer.items()}
                           for layer in param_tree(net, ts)["layers"]]}

    ref = {"params": jtree(params),
           "opt": {"m": jtree(m), "v": jtree(v),
                   "count": jnp.asarray(7, jnp.int32)},
           "best": jtree(best)}
    if with_cache:
        n, c, f = 20, 6, 5
        fields = {"cache": rng.normal(size=(c, f)).astype(np.float32),
                  "pos": np.where(np.arange(n) < c, np.arange(n), -1)
                  .astype(np.int32),
                  "slot_ids": np.arange(c, dtype=np.int32),
                  "refbit": rng.integers(0, 2, c).astype(np.int32),
                  "slot_freq": rng.integers(0, 9, c).astype(np.int32),
                  "freq": rng.integers(0, 9, n).astype(np.int32),
                  "hand": np.asarray(4, np.int32)}
        port["cache"] = DynamicCacheState(
            **{k: torch.as_tensor(a) for k, a in fields.items()},
            capacity=c, policy="t")
        ref["cache"] = DynamicCacheStateJ(
            **{k: jnp.asarray(a) for k, a in fields.items()},
            capacity=c, policy="t")
    return port, ref


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


CASES = [("sage", False), ("gcn", False), ("gat", False), ("sage", True)]


@pytest.mark.parametrize("model,with_cache", CASES)
def test_same_files_in_both_directions(tmp_path, model, with_cache):
    port, ref = _states(model, with_cache)
    dp, dr = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(dp, 5, port, extra=EXTRA)
    ckpt_j.save(dr, 5, ref, extra=EXTRA)
    mp, mr = _manifest(dp, 5), _manifest(dr, 5)
    assert mp == mr                      # paths, order, shapes, dtypes, CRCs
    if model == "gat":                   # layer 0's w_out is None: no leaf
        paths = [leaf["path"] for leaf in mp["leaves"]]
        assert "['params']['layers'][1]['w_out']" in paths
        assert "['params']['layers'][0]['w_out']" not in paths
    if with_cache:
        assert "['cache'].hand" in [leaf["path"] for leaf in mp["leaves"]]
    # the reference reads the port's files ...
    tree, extra = ckpt_j.restore(dp, 5, ref)
    assert extra == EXTRA
    got, want = jax.tree.leaves(tree), jax.tree.leaves(ref)
    assert len(got) == len(want) == len(mp["leaves"])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # ... and the port the reference's, as tensors of the `like` dtypes
    like = _states(model, with_cache, seed=1)[0]
    tree, extra = ckpt.restore(dr, 5, like)
    assert extra == EXTRA
    got, paths = ckpt.flatten_with_paths(tree)
    want, _ = ckpt.flatten_with_paths(port)
    assert len(got) == len(want) == len(mp["leaves"])
    for a, b, p in zip(got, want, paths):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype, p
        assert torch.equal(a, b), p
    if with_cache:
        assert isinstance(tree["cache"], DynamicCacheState)
        assert tree["cache"].hand.shape == () and \
            tree["cache"].pos.dtype == torch.int32


def test_restore_casts_to_the_like_dtype(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": torch.arange(6.0).reshape(2, 3)})
    like = {"w": torch.zeros((2, 3), dtype=torch.float64)}
    tree, _ = ckpt.restore(d, 1, like)
    assert tree["w"].dtype == torch.float64
    assert torch.equal(tree["w"], torch.arange(6.0, dtype=torch.float64)
                       .reshape(2, 3))


# ---------------------------------------------------------------------------
# corruption (mirrors tests/test_resilience_gnn.py:233-300)
# ---------------------------------------------------------------------------
def _tree(s):
    return {"w": torch.arange(12.0).reshape(3, 4) * (s + 1),
            "b": torch.full((5,), s, dtype=torch.int32)}


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(ckpt.flatten_with_paths(a)[0],
                   ckpt.flatten_with_paths(b)[0]))


def test_restore_rejects_bit_rot(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(1))
    leaf = os.path.join(d, "step_000000001", "leaf_0.npy")
    with open(leaf, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ckpt.CheckpointCorrupt, match="checksum"):
        ckpt.restore(d, 1, _tree(1))


@pytest.mark.parametrize("damage", ["truncated_leaf", "missing_manifest",
                                    "leaf_count"])
def test_restore_rejects_damage(tmp_path, damage):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(1))
    step = os.path.join(d, "step_000000001")
    like = _tree(1)
    if damage == "truncated_leaf":
        corrupt_checkpoint(step, np.random.default_rng((0, 1)),
                           mode="truncate", target="leaf_1.npy")
    elif damage == "missing_manifest":
        os.remove(os.path.join(step, "manifest.json"))
    else:
        like = {"only": torch.zeros(3)}
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore(d, 1, like)


def test_npy_header_quote_flip_is_corrupt(tmp_path):
    """A fixed case: the first quote of leaf 0's header flipped. numpy's
    header parser raises `tokenize.TokenError` on it; the port's restore
    turns that into `CheckpointCorrupt` (the reference lets it escape)."""
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(1))
    leaf = os.path.join(d, "step_000000001", "leaf_0.npy")
    with open(leaf, "rb") as f:
        data = bytearray(f.read())
    i = data.index(b"'")
    data[i] ^= 0xFF
    with open(leaf, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(tokenize.TokenError):
        np.load(leaf)
    with pytest.raises(ckpt.CheckpointCorrupt, match="unreadable"):
        ckpt.restore(d, 1, _tree(1))
    assert ckpt.restore_latest(d, _tree(0)) == (None, None, None)


def test_restore_latest_falls_back_past_corrupt(tmp_path):
    """Newest checkpoint corrupt -> restore_latest lands on the next
    valid one, invoking on_corrupt per skip; all corrupt -> (None,)*3."""
    d = str(tmp_path)
    for s in (1, 2, 3):
        ckpt.save(d, s, _tree(s), extra={"s": s})
    rng = np.random.default_rng((0, 2))
    skipped = []
    corrupt_checkpoint(os.path.join(d, "step_000000003"), rng,
                       mode="truncate", target="manifest.json")
    step, tree, extra = ckpt.restore_latest(
        d, _tree(0), on_corrupt=lambda s, e: skipped.append(s))
    assert (step, extra["s"]) == (2, 2)
    assert _leaves_equal(tree, _tree(2))
    assert skipped == [3]
    corrupt_checkpoint(os.path.join(d, "step_000000002"), rng,
                       mode="flip", target="leaf_1.npy")
    step, tree, extra = ckpt.restore_latest(d, _tree(0))
    assert (step, extra["s"]) == (1, 1)
    corrupt_checkpoint(os.path.join(d, "step_000000001"), rng,
                       mode="truncate", target="leaf_0.npy")
    assert ckpt.restore_latest(d, _tree(0)) == (None, None, None)


def test_latest_step_and_gc_ignore_litter(tmp_path):
    """`.tmp_save_*` crash litter and malformed step_* names neither
    break latest_step/_gc nor survive the next save's sweep; keep-N
    garbage collection keeps the newest N."""
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(1))
    os.makedirs(os.path.join(d, ".tmp_save_dead"))
    with open(os.path.join(d, ".tmp_save_dead", "leaf_0.npy"), "wb") as f:
        f.write(b"partial")
    os.makedirs(os.path.join(d, "step_garbage"))
    assert ckpt.latest_step(d) == 1
    ckpt.save(d, 2, _tree(2), keep=2)       # _gc sweeps the litter
    assert not [x for x in os.listdir(d) if x.startswith(".tmp_save_")]
    assert os.path.isdir(os.path.join(d, "step_garbage"))  # ignored
    assert ckpt.latest_step(d) == 2
    ckpt.save(d, 3, _tree(3), keep=2)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_0")) == \
        ["step_000000002", "step_000000003"]
