"""Runtime meters of the GNN trainer (`repro/train/monitor.py:84-150`).

`HitRateMeter` accumulates the feature-cache hit/miss counters the trainer
measures per batch (`repro_torch.featcache`) into per-epoch and per-run
hit rates. The reference's metrics-hub mirror is not ported (there is no
`obs` package in the port yet); the `refills` and `degraded_at` fields are
kept for the dynamic cache, which only adds to them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class HitRateMeter:
    """Feature-cache hit/miss accumulator.

    The trainer feeds it the device counters `gather_cached` mirrors (one
    observe per batch, after a host read it makes anyway, so metering never
    adds a sync); `mark()` / `rate_since` carve the running totals into
    per-epoch windows, and `note_epoch` records each epoch's hit rate on
    `trajectory`."""
    hits: int = 0
    misses: int = 0
    refills: int = 0                  # admitted rows, all epochs (churn)
    degraded_at: Optional[int] = None  # step the cache was dropped, if any
    trajectory: List[dict] = field(default_factory=list)

    def observe(self, hits, misses) -> None:
        self.hits += int(hits)
        self.misses += int(misses)

    @property
    def total(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.total, 1)

    def mark(self):
        """Window marker: pass the result to `rate_since` / `note_epoch`."""
        return (self.hits, self.misses, self.refills)

    def rate_since(self, mark) -> float:
        h0, m0 = mark[0], mark[1]
        return (self.hits - h0) / max(self.total - h0 - m0, 1)

    def note_epoch(self, mark) -> dict:
        """Close the epoch window opened at `mark`: append (and return)
        `{"hit_rate", "refills"}` on the trajectory."""
        entry = {"hit_rate": self.rate_since(mark),
                 "refills": self.refills - (mark[2] if len(mark) > 2
                                            else 0)}
        self.trajectory.append(entry)
        return entry
