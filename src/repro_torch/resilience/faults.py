"""Deterministic, seeded fault injection for the GNN training stack — a
copy of `repro/resilience/faults.py` (pure numpy), so that a plan seeded
in either package arms the same invocations and draws the same payloads.

Chaos testing is only useful if every scenario REPLAYS: a fault that
fires at a nondeterministic point produces a nondeterministic recovery
path, and "recovered" stops being checkable bit-for-bit. This module
keeps the whole story deterministic:

  * a `FaultPlan` arms named sites with `FaultSpec`s whose trigger points
    are *invocation indices* (the N-th time the site is reached), drawn
    either explicitly or from a seeded schedule (`FaultPlan.seeded`);
  * production code calls `fire(site)` at each injection point — a
    module-global check that is a single `is None` test when no plan is
    installed, so the hooks cost nothing in normal runs;
  * corruption payloads (which file to truncate, which byte to flip,
    which cache entry to scramble) come from `payload_rng(spec)`, a
    generator seeded by (plan seed, site, trigger) — the damage itself
    replays too.

The five sites (`FAULT_SITES`; all five stay, so that seeded draws equal
the reference's). The port wires three of them:

  step_nonfinite  the GNN train step's loss is poisoned to NaN (and so
                  are its grads) for the armed invocations
  ckpt_truncate   `train.checkpoint.save` corrupts the checkpoint it
                  just wrote (torn write / bit rot)
  cache_corrupt   `featcache.dynamic.refill` returns a state whose
                  residency invariants are violated

`batch_build` (a producer-thread build failure) and `producer_hang` (a
hung producer) belong to the async pipeline, which the port does not
have yet.

Every fire is recorded on `plan.events` so tests can assert the fault
actually happened (a chaos test whose fault never fired proves nothing).
Counters are lock-protected, for sites that fire from another thread.
"""
from __future__ import annotations

import os
import threading
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

FAULT_SITES = ("batch_build", "producer_hang", "step_nonfinite",
               "ckpt_truncate", "cache_corrupt")


class InjectedFault(RuntimeError):
    """The exception `maybe_raise` raises at an armed site."""

    def __init__(self, site: str, invocation: int):
        super().__init__(f"injected fault at site {site!r} "
                         f"(invocation {invocation})")
        self.site = site
        self.invocation = invocation


@dataclass(frozen=True)
class FaultSpec:
    """Arm `site` for invocations [start, start + count)."""
    site: str
    start: int
    count: int = 1

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"known: {FAULT_SITES}")
        if self.start < 0 or self.count < 1:
            raise ValueError(f"bad trigger window ({self.start}, "
                             f"{self.count})")

    def armed_at(self, invocation: int) -> bool:
        return self.start <= invocation < self.start + self.count


@dataclass
class FaultPlan:
    """A set of armed fault sites plus the runtime counters/events of one
    injected run. `fire` is how sites consult the plan; the same plan
    object replayed over the same deterministic call sequence fires at
    exactly the same points."""
    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0
    counters: Dict[str, int] = field(default_factory=dict)
    events: List[dict] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    @classmethod
    def seeded(cls, seed: int, windows: Dict[str, Tuple[int, int]],
               counts: Optional[Dict[str, int]] = None) -> "FaultPlan":
        """Draw one trigger per site from a seeded schedule: `windows`
        maps site -> inclusive (lo, hi) invocation range, `counts` maps
        site -> how many consecutive invocations stay armed (default 1).
        Sites are visited in `FAULT_SITES` order so the draws are a pure
        function of (seed, windows)."""
        rng = np.random.default_rng((seed, 0))  # salt 0: legacy slot
        counts = counts or {}
        specs = []
        for site in FAULT_SITES:
            if site not in windows:
                continue
            lo, hi = windows[site]
            specs.append(FaultSpec(site, int(rng.integers(lo, hi + 1)),
                                   counts.get(site, 1)))
        return cls(specs=tuple(specs), seed=seed)

    def fire(self, site: str, **ctx) -> Optional[FaultSpec]:
        """Count one invocation of `site`; return the armed spec if this
        invocation is inside its trigger window (else None)."""
        with self._lock:
            i = self.counters.get(site, 0)
            self.counters[site] = i + 1
            for spec in self.specs:
                if spec.site == site and spec.armed_at(i):
                    self.events.append({"site": site, "invocation": i,
                                        **ctx})
                    return spec
        return None

    def fired(self, site: Optional[str] = None) -> List[dict]:
        return [e for e in self.events
                if site is None or e["site"] == site]

    def payload_rng(self, spec: FaultSpec) -> np.random.Generator:
        """Deterministic generator for the fault's corruption payload."""
        return np.random.default_rng(
            (self.seed, zlib.crc32(spec.site.encode()), spec.start))


# ---------------------------------------------------------------------------
# the installed plan (module global, one per process)
# ---------------------------------------------------------------------------
_PLAN: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    global _PLAN
    _PLAN = plan


def active() -> Optional[FaultPlan]:
    return _PLAN


@contextmanager
def inject(plan: FaultPlan):
    """Install `plan` for the duration of the block (not reentrant —
    chaos scenarios run one plan at a time)."""
    prev = _PLAN
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def fire(site: str, **ctx) -> Optional[FaultSpec]:
    """The hook production code calls at an injection point: a no-op
    (single global read) unless a plan is installed AND armed here."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.fire(site, **ctx)


def maybe_raise(site: str, **ctx) -> None:
    """`fire`, then raise `InjectedFault` if armed (raising sites)."""
    plan = _PLAN
    if plan is None:
        return
    spec = plan.fire(site, **ctx)
    if spec is not None:
        raise InjectedFault(site, plan.counters[site] - 1)


# ---------------------------------------------------------------------------
# corruption payloads
# ---------------------------------------------------------------------------
def corrupt_file(path: str, rng: np.random.Generator,
                 mode: Optional[str] = None) -> dict:
    """Deterministically damage one file: `truncate` (torn write — keep a
    prefix) or `flip` (bit rot — invert one byte). Returns what was done."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if mode is None:
        mode = "truncate" if rng.integers(2) else "flip"
    if mode == "truncate" or not data:
        keep = int(rng.integers(0, max(len(data) // 2, 1)))
        data = data[:keep]
    else:
        i = int(rng.integers(len(data)))
        data[i] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    return {"file": os.path.basename(path), "mode": mode,
            "size": len(data)}


def corrupt_checkpoint(step_dir: str, rng: np.random.Generator,
                       mode: Optional[str] = None,
                       target: Optional[str] = None) -> dict:
    """Damage one file of a `step_*` checkpoint directory (manifest or a
    random leaf) — the `ckpt_truncate` payload, also used directly by the
    corruption property tests."""
    files = sorted(f for f in os.listdir(step_dir)
                   if f == "manifest.json" or f.startswith("leaf_"))
    if target is None:
        target = files[int(rng.integers(len(files)))]
    return corrupt_file(os.path.join(step_dir, target), rng, mode)
