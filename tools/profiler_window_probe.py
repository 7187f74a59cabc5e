#!/usr/bin/env python3
"""How often a short `torch.profiler` window on the card loses kernel
events, and whether the op audit's padded window (`op_audit._profiled`)
keeps them:

    PYTHONPATH=src python3 tools/profiler_window_probe.py [--seconds 120]

Each round ages the process (large matmuls, a profiled window of 3,000
small launches), then profiles the `gather_agg` and `gather_cached`
calls of the op audit's kernels section twice: (old) a ~50 ms sleep
kernel leads the calls and the window closes at once after them; (new)
the audit's own `_profiled`, the calls `pad_s` inside each edge. It
then times one tiny kernel launched on an idle card: its start in the
trace less the host's clock read just before the launch (the skew; a
negative value is a kernel stamped before it was launched), with a
sleep kernel leading the window as a marker whose loss is counted.
Prints one JSON line a round and a summary line last.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import op_audit
from repro_torch.kernels.gather_agg.ops import gather_agg
from repro_torch.kernels.gather_cached.ops import gather_cached

NAMES = {"gather_agg": ("fwd_kernel", "bwd_dx", "bwd_dw_kernel"),
         "gather_cached": ("gather_cached_kernel", "bwd_dx")}


def calls(dev):
    """The op audit's two kernel calls at its shapes."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((64, 32), generator=gen).to(dev)
    w = torch.rand((16, 4), generator=gen).to(dev)
    idx = torch.randint(0, 64, (16, 4), generator=gen,
                        dtype=torch.int32).to(dev)
    cache = torch.randn((8, 32), generator=gen).to(dev)
    pos = torch.full((64,), -1, dtype=torch.int32)
    pos[:8] = torch.arange(8, dtype=torch.int32)
    pos = pos.to(dev)
    ids = torch.randint(-1, 64, (64,), generator=gen,
                        dtype=torch.int32).to(dev)

    def agg():
        xg = x.clone().requires_grad_(True)
        wg = w.clone().requires_grad_(True)
        torch.autograd.grad(gather_agg(xg, idx, wg).sum(), (xg, wg))

    def cached():
        cg = cache.clone().requires_grad_(True)
        fg = x.clone().requires_grad_(True)
        rows, _, _ = gather_cached(cg, fg, pos, ids)
        torch.autograd.grad(rows.sum(), (cg, fg))

    return {"gather_agg": agg, "gather_cached": cached}


def device_names(prof):
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def old_window(fn, reps: int = 5):
    """The audit's window before padding: a sleep kernel, then the calls;
    the window closes right after them."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000_000)
        op_audit.record(lambda: [fn() for _ in range(reps)])
        torch.cuda.synchronize()
    return device_names(prof)


def skew_ns():
    """(trace start of one tiny kernel less the host clock at its launch,
    whether the leading marker kernel is in the trace)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000_000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t = time.time_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.3)
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA)
    return starts[-1] - t, len(starts) == 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    args = ap.parse_args()
    dev = torch.device("cuda")
    fns = calls(dev)
    for fn in fns.values():                     # builds the libraries
        fn()
    a = torch.randn(8192, 8192, device=dev)
    v = torch.zeros(1024, device=dev)
    tot = {"rounds": 0, "old_missing": 0, "new_missing": 0,
           "new_retaken": 0, "marker_lost": 0, "skew_ns": []}
    t0 = time.time()
    while time.time() - t0 < args.seconds:
        for _ in range(40):
            a = (a @ a).mul_(1e-4)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for _ in range(3000):
                v.add_(1)
            torch.cuda.synchronize()
        row = {"round": tot["rounds"], "age_s": round(time.time() - t0, 1)}
        for name, fn in fns.items():
            old = old_window(fn)
            _, new, windows = op_audit._profiled(fn)
            miss_old = [n for n in NAMES[name]
                        if not any(n in k for k in old)]
            miss_new = [n for n in NAMES[name]
                        if not any(n in k for k in new)]
            row[name] = {"old_missing": miss_old, "old_kernels": len(old),
                         "new_missing": miss_new, "new_kernels": len(new),
                         "new_windows": windows}
            tot["old_missing"] += bool(miss_old)
            tot["new_missing"] += bool(miss_new)
            tot["new_retaken"] += windows > 1
        skew, marker = skew_ns()
        row["skew_ns"] = skew
        row["marker_lost"] = not marker
        tot["skew_ns"].append(skew)
        tot["marker_lost"] += not marker
        tot["rounds"] += 1
        print(json.dumps(row), flush=True)
    sk = tot.pop("skew_ns")
    tot["windows_each"] = tot["rounds"] * len(fns)
    tot["skew_ns_min"] = min(sk)
    tot["skew_ns_max"] = max(sk)
    tot["skew_ns_median"] = sorted(sk)[len(sk) // 2]
    print(json.dumps({"summary": tot}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
