"""`MetricsHub`: one registry for every runtime metric the stack emits
(`repro/obs/metrics.py`, copied; `run_metadata` names torch, CUDA and the
card where the reference names jax).

Three primitive types:

  Counter    monotonically increasing int (cache hits, skipped steps)
  Gauge      last-written value (straggler fraction, hit rate)
  Histogram  value distribution with count/sum/min/max + percentiles
             (step dispatch times)

The trainer's meters (`train.monitor`: `HitRateMeter`, `ResilienceMeter`,
`StragglerMonitor`) keep their own fields but accept `hub=`; attached,
every mutation mirrors into the reference's series names ("cache/hits",
"resilience/rollbacks", "straggler/fraction", ...).

Per-epoch snapshots: `mark_epoch(epoch)` closes a window — the deltas of
every counter since the previous mark plus current gauge values — and
appends it to `hub.epochs`.

Export schema (versioned — consumers check `schema`): `export()` returns
`{"schema": OBS_SCHEMA_VERSION, "meta": run_metadata(), "metrics": ...,
"epochs": [...]}`.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional

OBS_SCHEMA_VERSION = 1


def _card() -> Dict:
    """The CUDA card's name and `nvidia-smi`'s power limit; nulls (never a
    raise) on a machine without a card."""
    import torch
    if not torch.cuda.is_available():
        return {"backend": "cpu", "device": None, "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
            capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return {"backend": "cuda",
            "device": torch.cuda.get_device_name(torch.cuda.current_device()),
            "power_limit": out or None}


def run_metadata() -> Dict:
    """The shared run-metadata header: who/what/where produced an
    artifact. Keys: schema, backend, torch, cuda, device, power_limit,
    git_commit, hostname, python (cuda, device and power_limit are null
    on a CPU-only machine)."""
    import torch
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        commit = ""
    card = _card()
    return {"schema": OBS_SCHEMA_VERSION,
            "backend": card["backend"],
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": card["device"],
            "power_limit": card["power_limit"],
            "git_commit": commit or "unknown",
            "hostname": socket.gethostname(),
            "python": sys.version.split()[0]}


class Counter:
    """Monotonic counter. `inc` rejects negative deltas — a decreasing
    'counter' is a gauge and would corrupt per-epoch deltas."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Keeps every observation (one value per step or epoch) and
    summarizes with exact percentiles."""
    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    def percentile(self, q: float) -> float:
        """Exact nearest-rank percentile (q in [0, 100]) — 0 when empty."""
        if not self.values:
            return 0.0
        vs = sorted(self.values)
        idx = min(len(vs) - 1, max(0, round(q / 100.0 * (len(vs) - 1))))
        return vs[idx]

    def summary(self) -> Dict:
        if not self.values:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": self.sum,
                "min": min(self.values), "max": max(self.values),
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


class MetricsHub:
    """Get-or-create registry of named metrics + per-epoch snapshots.

    A name is bound to ONE type for the lifetime of the hub: asking for
    `counter("x")` after `gauge("x")` raises instead of shadowing."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self.epochs: List[Dict] = []
        self._epoch_mark: Dict[str, int] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # -- snapshots ----------------------------------------------------------
    def snapshot(self) -> Dict:
        """Current value of every metric (histograms summarized)."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            out[name] = m.summary() if isinstance(m, Histogram) \
                else m.value
        return out

    def mark_epoch(self, epoch: int) -> Dict:
        """Close the per-epoch window: counter DELTAS since the previous
        mark, current gauges, and histogram summaries. Appends (and
        returns) the entry on `self.epochs`."""
        entry: Dict = {"epoch": int(epoch)}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                entry[name] = m.value - self._epoch_mark.get(name, 0)
                self._epoch_mark[name] = m.value
            elif isinstance(m, Gauge):
                entry[name] = m.value
            else:
                entry[name] = m.summary()
        self.epochs.append(entry)
        return entry

    def export(self, extra: Optional[Dict] = None) -> Dict:
        """Versioned, JSON-ready export of the whole hub."""
        out = {"schema": OBS_SCHEMA_VERSION, "meta": run_metadata(),
               "metrics": self.snapshot(), "epochs": list(self.epochs)}
        if extra:
            out.update(extra)
        return out
