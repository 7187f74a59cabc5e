#!/usr/bin/env python3
"""Time the CLOCK walk (`kernels/clock_refill`) of whichever `repro_torch`
comes first on the path, on the synthetic ogbn-products-scale state with
uniform counts (`ref.PRODUCTS`, seed 0), so that two trees' kernels can be
timed in turns on one card:

    PYTHONPATH=<tree>/src python3 tools/clock_walk_ab.py [--label NAME]

The state comes from this script's own tree (its `ref.py`, loaded by
path); the kernel, its wrapper and the candidate sort from the path's
tree, through the wrapper's call, which every tree with the kernel has.
`chip_smoke.py` of this tree does the timing (`cuda_ms`: CUDA events
around back-to-back calls) and prints the card; run it in the same call.
Prints one JSON line: the walk's ms (the median of five rounds), the
admitted rows, the steps and a digest of the outputs, which two trees'
walks must share.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _own_ref():
    """This tree's `ref.py`, whichever `repro_torch` is on the path."""
    path = ROOT / "src/repro_torch/kernels/clock_refill/ref.py"
    spec = importlib.util.spec_from_file_location("clock_walk_ab_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(walk) -> str:
    """sha256 of a walk's fields (the admissions up to their count)."""
    n = int(walk.n_admitted)
    h = hashlib.sha256()
    for f in walk._fields:
        t = getattr(walk, f)
        h.update((t[:n] if f.startswith("adm") else t).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="a name for the tree")
    label = ap.parse_args().label
    import torch
    if not torch.cuda.is_available():
        print("clock_walk_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms
    from repro_torch.kernels.clock_refill import kernel
    ref = _own_ref()
    args = ref.walk_args(ref.clock_state(*ref.PRODUCTS, 0, "cuda"))
    walk = kernel.clock_refill(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernel.clock_refill(*args)
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    reps = max(1, int(100 / max(once, 1e-3)))
    ms = cuda_ms(torch, lambda: kernel.clock_refill(*args), reps=reps,
                 rounds=5, warmup=1)
    print(json.dumps({
        "tree": label, "state": "products-scale synthetic, uniform counts",
        "N": int(args[0].shape[0]), "C": int(args[1].shape[0]),
        "admitted": int(walk.n_admitted), "steps": int(walk.steps),
        "walk_ms": ms, "reps": reps, "digest": digest(walk),
        "homes": {k: v for k, v in kernel.SMEM.items() if v},
        "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
