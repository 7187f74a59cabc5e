"""Fault-tolerant checkpointing: atomic, keep-N, verified resume-latest —
the on-disk format of `repro/train/checkpoint.py:72-201`, so that either
package restores the other's checkpoints.

Layout:  <dir>/step_<N:09d>/manifest.json + leaf_<i>.npy (one per leaf).
The manifest holds `step`, `extra` (JSON) and `leaves`, each leaf with
`i`, `path`, `shape`, `dtype` and `crc32` (CRC32 of the raw array bytes).
Leaves are ordered, and named, as JAX's `tree_flatten_with_path` and
`keystr` would for the same state: dict keys sorted, list items by index
(`['params']['layers'][0]['w_self']`), `None` no leaf, and a dataclass
that names its `DATA_FIELDS` (the dynamic cache state) field by field in
that order (`['cache'].pos`). `flatten_with_paths` is the port's own walk
of that tree; it needs no `jax`.

Writes go to a `tempfile.mkdtemp` directory, then `os.rename` (atomic on
POSIX): a crash mid-save never corrupts the latest checkpoint, and `_gc`
sweeps any `.tmp_save_*` litter such a crash leaves behind.

`restore` verifies the manifest, every leaf's presence, shape, dtype,
path and CRC32, raising `CheckpointCorrupt` on any mismatch — including a
`.npy` header numpy cannot parse, which can raise `tokenize.TokenError`
(a flipped quote byte) where the reference lets that escape. It returns
tensors on the device and with the dtype of the `like` tree's leaves.
`restore_latest` walks checkpoints newest to oldest and falls back past
corrupt or partial ones to the newest VALID step.

Fault injection: the `ckpt_truncate` site (`repro_torch.resilience`) —
`save` deterministically corrupts the checkpoint it just wrote, which is
exactly the failure `restore_latest`'s fallback must absorb. There is no
mesh in the port yet, so the reference's `shardings=` is not ported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import tokenize
import warnings
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.resilience import faults


class CheckpointCorrupt(RuntimeError):
    """A checkpoint directory failed verification (missing/truncated
    files, checksum or shape mismatch, unparseable manifest)."""


# ---------------------------------------------------------------------------
# the tree walk (JAX's leaf order and key paths, without jax)
# ---------------------------------------------------------------------------
def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(path suffix, child) pairs of an inner node, None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    fields = getattr(type(node), "DATA_FIELDS", None)
    if fields is not None:
        return [(f".{f}", getattr(node, f)) for f in fields]
    return None


def flatten_with_paths(tree) -> Tuple[List[Any], List[str]]:
    """(leaves, key paths) in JAX's order; `None` is an empty subtree."""
    leaves: List[Any] = []
    paths: List[str] = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            leaves.append(node)
            paths.append(path)
            return
        for suffix, child in kids:
            walk(child, path + suffix)

    walk(tree, "")
    return leaves, paths


def unflatten_like(tree, leaves: List[Any]):
    """`tree` with its leaves replaced, in `flatten_with_paths` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        fields = getattr(type(node), "DATA_FIELDS", None)
        if fields is not None:
            # build in DATA_FIELDS order, which is the leaf order
            return dataclasses.replace(
                node, **{f: build(getattr(node, f)) for f in fields})
        return next(it)

    return build(tree)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _step_dirs(ckpt_dir: str) -> List[Tuple[int, str]]:
    """(step, dirname) for every well-formed step_* entry, ascending.
    Malformed names (step_garbage) and `.tmp_save_*` litter are skipped
    rather than crashing `int(...)`."""
    out = []
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_"):
            continue
        try:
            out.append((int(d.split("_", 1)[1]), d))
        except ValueError:
            continue
    return sorted(out)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------
def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomically write `tree` (+ JSON-able `extra`) as step `step`. The
    copy of each device leaf to the host is one of the trainer's
    sanctioned host reads (traced as a cat="sync" span)."""
    with obs_trace.span("ckpt_save", cat="sync", step=step):
        return _save(ckpt_dir, step, tree, extra, keep)


def _save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict],
          keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, paths = flatten_with_paths(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_")
    try:
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for i, (leaf, path) in enumerate(zip(leaves, paths)):
            arr = _to_numpy(leaf)
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            manifest["leaves"].append(
                {"i": i, "path": path, "shape": list(arr.shape),
                 "dtype": str(arr.dtype), "crc32": _crc(arr)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:09d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    spec = faults.fire("ckpt_truncate", step=step)
    if spec is not None:
        # chaos site: damage the checkpoint we just wrote (torn write /
        # bit rot) — restore_latest must fall back past it
        faults.corrupt_checkpoint(final, faults.active().payload_rng(spec))
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = _step_dirs(ckpt_dir)
    for _, d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    for d in os.listdir(ckpt_dir):
        # a crash between mkdtemp and rename leaves .tmp_save_* litter;
        # our own tmp dir is already renamed away by the time _gc runs
        if d.startswith(".tmp_save_"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _step_dirs(ckpt_dir)
    return steps[-1][0] if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> tuple:
    """Restore into the structure of `like`, verifying the manifest and
    every leaf (presence, shape/dtype, path, CRC32) — raises
    `CheckpointCorrupt` instead of returning silently wrong state. Each
    leaf comes back as a tensor on the device, and with the dtype, of
    the `like` leaf in its place. Returns (tree, extra)."""
    with obs_trace.span("ckpt_restore", cat="ckpt", step=step):
        return _restore(ckpt_dir, step, like)


def _restore(ckpt_dir: str, step: int, like: Any) -> tuple:
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        refs = manifest["leaves"]
        extra = manifest["extra"]
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointCorrupt(f"{path}: unreadable manifest: {e}") from e
    leaves, paths = flatten_with_paths(like)
    if not isinstance(refs, list) or len(leaves) != len(refs):
        raise CheckpointCorrupt(
            f"{path}: leaf count mismatch: restore target has "
            f"{len(leaves)}, manifest has "
            f"{len(refs) if isinstance(refs, list) else refs!r}")
    out = []
    for i, ref in enumerate(leaves):
        try:
            arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        except (OSError, ValueError, EOFError, tokenize.TokenError) as e:
            # a flipped byte in the .npy header can make numpy's header
            # parser raise tokenize.TokenError, not ValueError
            raise CheckpointCorrupt(
                f"{path}: leaf_{i}.npy unreadable: {e}") from e
        meta = refs[i]
        if not isinstance(meta, dict):
            raise CheckpointCorrupt(f"{path}: leaf {i}: bad manifest entry")
        if tuple(arr.shape) != tuple(meta.get("shape", arr.shape)) or \
                str(arr.dtype) != meta.get("dtype", str(arr.dtype)):
            raise CheckpointCorrupt(
                f"{path}: leaf {i} shape/dtype {arr.shape}/{arr.dtype} "
                f"!= manifest {meta.get('shape')}/{meta.get('dtype')}")
        if "crc32" in meta and _crc(arr) != meta["crc32"]:
            raise CheckpointCorrupt(f"{path}: leaf {i} checksum mismatch")
        if meta.get("path", paths[i]) != paths[i]:
            raise CheckpointCorrupt(
                f"{path}: leaf {i} is {meta.get('path')}, the restore "
                f"target's is {paths[i]}")
        if tuple(arr.shape) != tuple(ref.shape):
            raise CheckpointCorrupt(
                f"{path}: shape mismatch at leaf {i}: {arr.shape} vs "
                f"{tuple(ref.shape)}")
        t = torch.from_numpy(np.asarray(arr, order="C"))  # keeps 0-d
        if isinstance(ref, torch.Tensor):
            t = t.to(device=ref.device, dtype=ref.dtype)
        out.append(t)
    return unflatten_like(like, out), extra


def restore_latest(ckpt_dir: str, like: Any,
                   on_corrupt: Optional[Callable[[int, Exception],
                                                 None]] = None):
    """Restore the newest VALID checkpoint, falling back past corrupt or
    partial ones (each skip warns and invokes `on_corrupt(step, err)` for
    metering). Returns (None, None, None) when no valid checkpoint
    exists — same as an empty directory."""
    if not os.path.isdir(ckpt_dir):
        return None, None, None
    for step, _ in reversed(_step_dirs(ckpt_dir)):
        try:
            tree, extra = restore(ckpt_dir, step, like)
        except CheckpointCorrupt as e:
            warnings.warn(f"skipping corrupt checkpoint step {step}: {e}",
                          RuntimeWarning, stacklevel=2)
            if on_corrupt is not None:
                on_corrupt(step, e)
            continue
        return step, tree, extra
    return None, None, None
