"""Runtime meters of the GNN trainer (`repro/train/monitor.py`).

`StragglerMonitor` keeps an EMA of step time and flags outliers;
`resilient_step` retries a step function and escalates to a give-up
callback after repeated failures. `HitRateMeter` accumulates the
feature-cache hit/miss counters the GNN trainer measures per batch
(`repro_torch.featcache`) into per-epoch hit rates, plus — for dynamic
CLOCK admission — the per-epoch refill churn and the hit-rate trajectory
across epochs. `ResilienceMeter` counts the recovery actions the guarded
GNN path takes (skipped non-finite steps, rollbacks, corrupt-checkpoint
fallbacks, cache degradations, async producer restarts) so chaos runs
(`repro_torch.resilience`) can assert that the expected recovery — and
ONLY the expected recovery — happened.

All three meters keep their standalone behaviour but accept an optional
`hub=` (`repro_torch.obs.MetricsHub`): when attached, every mutation
mirrors into the reference's series names ("cache/hits",
"resilience/rollbacks", "straggler/fraction", ...), so that hub counters
equal the meter's own fields at every point.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class StragglerMonitor:
    """EMA step-time tracker. `threshold` x EMA flags a straggler step."""
    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 3
    ema: float = 0.0
    count: int = 0
    events: List[dict] = field(default_factory=list)
    hub: Optional[object] = None      # repro_torch.obs.MetricsHub mirror

    def observe(self, dt: float, step: int) -> bool:
        self.count += 1
        if self.count <= self.warmup:
            self.ema = dt if self.ema == 0 else \
                (self.alpha * dt + (1 - self.alpha) * self.ema)
            self._mirror(dt, False)
            return False
        slow = dt > self.threshold * self.ema
        if slow:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
        else:
            self.ema = self.alpha * dt + (1 - self.alpha) * self.ema
        self._mirror(dt, slow)
        return slow

    def _mirror(self, dt: float, slow: bool) -> None:
        if self.hub is None:
            return
        self.hub.counter("straggler/steps").inc()
        if slow:
            self.hub.counter("straggler/events").inc()
        self.hub.histogram("straggler/step_time_s").observe(dt)
        self.hub.gauge("straggler/fraction").set(self.straggler_fraction)

    @property
    def straggler_fraction(self) -> float:
        return len(self.events) / max(self.count - self.warmup, 1)

    def mark(self) -> tuple:
        """Window marker for per-epoch fractions (`fraction_since`)."""
        return (len(self.events), self.count)

    def fraction_since(self, mark: tuple) -> float:
        """Straggler fraction of the window opened at `mark` (observed
        steps only; the warmup steps burn off in the first window)."""
        ev0, n0 = mark
        denom = self.count - max(n0, self.warmup)
        return (len(self.events) - ev0) / max(denom, 1)


@dataclass
class HitRateMeter:
    """Feature-cache hit/miss accumulator.

    The trainer feeds it the device counters `gather_cached` mirrors (one
    observe per batch, after a host read it makes anyway, so metering never
    adds a sync); `mark()` / `rate_since` carve the running totals into
    per-epoch windows. With DYNAMIC admission (`featcache.dynamic`) it
    also counts refill churn (`observe_refill`, once per epoch boundary),
    and `note_epoch` records the per-epoch (hit rate, admitted rows)
    trajectory."""
    hits: int = 0
    misses: int = 0
    refills: int = 0                  # admitted rows, all epochs (churn)
    degraded_at: Optional[int] = None  # step the cache was dropped, if any
    trajectory: List[dict] = field(default_factory=list)
    hub: Optional[object] = None      # repro_torch.obs.MetricsHub mirror

    def observe(self, hits, misses) -> None:
        self.hits += int(hits)
        self.misses += int(misses)
        if self.hub is not None:
            self.hub.counter("cache/hits").inc(int(hits))
            self.hub.counter("cache/misses").inc(int(misses))
            self.hub.gauge("cache/hit_rate").set(self.hit_rate)

    def observe_refill(self, admitted) -> None:
        """Count one epoch boundary's refill churn (admitted rows)."""
        self.refills += int(admitted)
        if self.hub is not None:
            self.hub.counter("cache/refills").inc(int(admitted))

    def note_degraded(self, step: int) -> None:
        """Record that the trainer dropped a corrupt cache and fell back
        to the uncached gather (graceful degradation — the trajectory
        keeps a visible marker, hit counting simply stops)."""
        self.degraded_at = step
        self.trajectory.append({"degraded": True, "step": step})
        if self.hub is not None:
            self.hub.counter("cache/degradations").inc()

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


@dataclass
class ResilienceMeter:
    """Recovery-action counters for the guarded GNN path.

    Each `note(kind, **info)` bumps the matching counter and appends the
    event (with its context) to `events`, so tests can assert both the
    count and the shape of every recovery a chaos run took."""
    skipped_steps: int = 0            # non-finite steps whose update was
    #                                   dropped by the on-device select
    rollbacks: int = 0                # skip budget exceeded -> restore
    producer_restarts: int = 0        # AsyncBatchStream watchdog restarts
    ckpt_fallbacks: int = 0           # corrupt checkpoints skipped over
    cache_degradations: int = 0       # dynamic cache dropped to uncached
    events: List[dict] = field(default_factory=list)
    hub: Optional[object] = None      # repro_torch.obs.MetricsHub mirror

    _KINDS = ("skipped_steps", "rollbacks", "producer_restarts",
              "ckpt_fallbacks", "cache_degradations")

    def note(self, kind: str, **info) -> None:
        if kind not in self._KINDS:
            raise ValueError(f"unknown resilience event {kind!r}; "
                             f"known: {self._KINDS}")
        setattr(self, kind, getattr(self, kind) + 1)
        self.events.append({"kind": kind, **info})
        if self.hub is not None:
            self.hub.counter(f"resilience/{kind}").inc()

    def counts(self) -> dict:
        return {k: getattr(self, k) for k in self._KINDS}


class StepFailure(RuntimeError):
    pass


def resilient_step(fn: Callable, *args, max_retries: int = 2,
                   backoff_s: float = 0.0,
                   on_give_up: Optional[Callable] = None):
    """Run `fn(*args)`; retry transient failures; escalate after retries.

    Returns (result, attempts). `on_give_up` (e.g. restore-from-checkpoint
    and rebuild step) is invoked before the final re-raise.
    """
    attempt = 0
    while True:
        try:
            return fn(*args), attempt + 1
        except Exception:  # noqa: BLE001 — deliberately broad: device loss
            attempt += 1
            if attempt > max_retries:
                if on_give_up is not None:
                    on_give_up()
                raise
            if backoff_s:
                time.sleep(backoff_s * attempt)
