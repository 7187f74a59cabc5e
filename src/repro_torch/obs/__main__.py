"""`python -m repro_torch.obs` — analyze a span trace, optionally gate on it
(`repro/obs/__main__.py`).

    python -m repro_torch.obs trace.jsonl                  # print the report
    python -m repro_torch.obs trace.jsonl --json r.json    # also serialize it
    python -m repro_torch.obs trace.jsonl --chrome t.json  # Perfetto-openable
                                                     #  traceEvents file
    python -m repro_torch.obs trace.jsonl --require-overlap \
                                    --forbid-mid-epoch-sync
                                                     # gate: exit 1 if
                                                     #  overlap <= 0 or
                                                     #  any sync fired
                                                     #  mid-epoch

The report (see `obs/report.py`) carries producer/consumer overlap
fraction, per-stage stall attribution, host-sync placement, and
per-epoch span rollups. Open the --chrome output at ui.perfetto.dev for
the interactive timeline.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.obs import report as rpt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-obs",
        description="trace analyzer: overlap, stalls, sync placement, "
                    "per-epoch rollups")
    ap.add_argument("trace", help="JSONL trace written by obs.trace.Tracer")
    ap.add_argument("--json", default=None, help="serialize the report")
    ap.add_argument("--chrome", default=None,
                    help="write a {'traceEvents': ...} file Perfetto opens")
    ap.add_argument("--require-overlap", action="store_true",
                    help="exit 1 unless producer/consumer overlap > 0")
    ap.add_argument("--forbid-mid-epoch-sync", action="store_true",
                    help="exit 1 if any host-sync span fired mid-epoch")
    args = ap.parse_args(argv)

    events = rpt.load_trace(args.trace)
    r = rpt.analyze(events)

    ov, st = r["overlap"], r["stalls"]
    print(f"trace: {r['n_events']} events, {r['n_threads']} threads, "
          f"{r['wall_s']:.3f}s wall")
    if r["conformance_problems"]:
        for p in r["conformance_problems"][:10]:
            print(f"  CONFORMANCE: {p}")
    print(f"overlap: producer busy {ov['producer_busy_s']:.3f}s, "
          f"consumer busy {ov['consumer_busy_s']:.3f}s, "
          f"overlap {ov['overlap_s']:.3f}s "
          f"(frac {ov['overlap_frac']:.3f})")
    for name, e in sorted(st.items()):
        print(f"stall: {name:18s} x{e['count']:<4d} {e['total_s']:.3f}s "
              f"({e['frac_of_wall']:.1%} of wall)")
    for name, e in sorted(r["sync_sites"].items()):
        print(f"sync:  {name:18s} x{e['count']:<4d} {e['total_s']:.3f}s")
    for ep in r["epochs"]:
        top = sorted(ep["spans"].items(), key=lambda kv: -kv[1]["total_s"])
        tops = " ".join(f"{n}={e['total_s']:.3f}s" for n, e in top[:4])
        print(f"epoch {ep['epoch']}: {ep['n_steps']} steps "
              f"{ep['dur_s']:.3f}s, mid-epoch syncs "
              f"{ep['mid_epoch_syncs']} | {tops}")
    print(f"mid-epoch syncs total: {r['mid_epoch_sync_count']}")

    if args.json:
        Path(args.json).write_text(json.dumps(r, indent=1) + "\n")
        print(f"report -> {args.json}")
    if args.chrome:
        rpt.to_chrome(events, args.chrome)
        print(f"perfetto -> {args.chrome} (open at ui.perfetto.dev)")

    ok = not r["conformance_problems"]
    if args.require_overlap and not ov["overlap_frac"] > 0:
        print("GATE FAIL: producer/consumer overlap is 0")
        ok = False
    if args.forbid_mid_epoch_sync and r["mid_epoch_sync_count"] > 0:
        print(f"GATE FAIL: {r['mid_epoch_sync_count']} mid-epoch sync(s)")
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
