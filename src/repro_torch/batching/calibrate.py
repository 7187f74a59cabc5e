"""Cap calibration with an on-disk cache (`repro/batching/calibrate.py`).

`calibrate_caps` (core.minibatch) probes an epoch with the exact numpy
batch construction to size the static per-level unique caps — a pure
function of (graph, policy, batch size, fanouts, probe params), but an
expensive one on real graphs. `CapsCalibrator` memoizes it in a JSON file
keyed by a graph fingerprint + the policy knobs, so repeated runs and
benchmark sweeps skip the probe entirely. The key string and the file are
the reference's, so a caps file written by either package hits in the
other.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch import sampling
from repro_torch.batching.policy import as_policy
from repro_torch.core import minibatch as mb
from repro_torch.graphs.csr import Graph


def graph_fingerprint(graph: Graph) -> str:
    """Cheap content hash: identity + strided samples of the topology,
    communities and split — enough to invalidate on any preprocessing
    change without hashing the full edge list."""
    h = hashlib.sha1()
    h.update(f"{graph.name}|{graph.num_nodes}|{graph.num_edges}|"
             f"{len(graph.train_ids)}".encode())
    for arr in (graph.indptr, graph.indices, graph.communities,
                graph.train_ids):
        if arr is None:
            continue
        a = np.asarray(arr)
        stride = max(1, len(a) // 256)
        h.update(np.ascontiguousarray(a[::stride]).tobytes())
    return h.hexdigest()[:16]


@dataclass
class CapsCalibrator:
    """Wraps `calibrate_caps` with a write-through JSON cache.

    cache_path=None disables the disk cache (every call probes). The cache
    key covers the graph fingerprint, the policy description (root_mode /
    mix / p), the bound sampler's description (caps are a per-sampler
    property), the batch size, the fanouts, and every probe parameter.
    """
    cache_path: Optional[str] = None
    n_probe: int = 6
    margin: float = 1.15
    seed: int = 0
    align: int = 128

    def key(self, graph: Graph, policy, batch_size: int, fanouts) -> str:
        pol = as_policy(policy)
        return "|".join([
            graph_fingerprint(graph), type(pol).__name__, pol.describe(),
            sampling.for_policy(pol).describe(),
            str(batch_size), ",".join(str(f) for f in fanouts),
            f"n{self.n_probe}", f"m{self.margin:g}", f"s{self.seed}",
            f"a{self.align}"])

    def _load(self) -> dict:
        """Read the caps cache, treating ANY corruption as a cache miss:
        a truncated/garbled file (crash mid-write on a non-atomic
        filesystem, bit rot), valid JSON that isn't a dict, binary
        garbage (UnicodeDecodeError is a ValueError) — all discard and
        recalibrate rather than crash. The write side (`_store`) is
        atomic; the read side has to assume the worst anyway."""
        if not self.cache_path or not os.path.exists(self.cache_path):
            return {}
        try:
            with open(self.cache_path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        return data if isinstance(data, dict) else {}

    def _store(self, cache: dict) -> None:
        folder = os.path.dirname(os.path.abspath(self.cache_path))
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, prefix=".caps_",
                                   suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(cache, f, indent=1)
            os.replace(tmp, self.cache_path)   # atomic on POSIX
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def caps_for(self, graph: Graph, policy, batch_size: int,
                 fanouts) -> Tuple[int, ...]:
        key = self.key(graph, policy, batch_size, fanouts)
        cache = self._load()
        if key in cache:
            try:
                caps = tuple(int(c) for c in cache[key])
                if len(caps) == len(tuple(fanouts)) and \
                        all(c > 0 for c in caps):
                    return caps
            except (TypeError, ValueError):
                pass                   # corrupt entry: fall through, reprobe
        caps = mb.calibrate_caps(
            graph, as_policy(policy), batch_size, tuple(fanouts),
            n_probe=self.n_probe, margin=self.margin, seed=self.seed,
            align=self.align)
        if self.cache_path:
            cache = self._load()               # re-read: last writer merges
            cache[key] = list(caps)
            self._store(cache)
        return caps
