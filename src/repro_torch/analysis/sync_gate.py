"""The host-sync gate and its allowance.

The trainer promises host reads only in named places (its docstring's
"Host reads" paragraph). Each such read sits inside `allowed_sync(name)`,
which counts it under `name` whether or not a gate is on: a dict
increment, nothing more, so the trainer's hot loop pays nothing for it.

`sync_gate()` turns CUDA's sync debug mode to "error" for a block
(`torch.cuda.set_sync_debug_mode`: a synchronizing CUDA call — a blocking
copy between host and device, `.item()`, `nonzero`, a stream sync —
raises) and restores the previous mode after it. Inside the gate each
`allowed_sync` window lowers the mode for the length of the window, so
only the named reads may sync. The mode is process-wide, so the gate
also covers the async pipeline's producer thread; a sync the producer
made while the consumer held a window open would pass unseen, which is
why the op audit (`op_audit`) also holds the builder alone to no sync.
What the debug mode sees is PyTorch's own CUDA calls, not what a kernel
library does inside: the port's `csrc/` sources are held to no blocking
runtime call by reading them (`op_audit.audit_kernels`).

    with sync_gate() as gate:
        trainer.train_steps(10)
    assert gate.counts() == trainer.promised_reads(10)  # (taken before)

`WINDOWS` names every window the port opens. The module imports nothing
of the package and torch only when a gate starts, so any module may
import it first.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional

# every allowance window the port opens, and the read it covers
WINDOWS: Dict[str, str] = {
    "drain": "`GNNTrainer._drain`: losses, integer metrics, guard flags "
             "and cache counters in one copy per `train_steps` call or "
             "epoch",
    "guard": "`GNNTrainer._guard_check`: the device skip counter, every "
             "`check_every` steps and before a due checkpoint",
    "refill": "`clock_refill`: the refill's admitted count, which sizes "
              "its row copy (once per epoch boundary, dynamic cache)",
    "integrity": "`dynamic.integrity_ok`: the residency check's bool "
                 "(once per epoch boundary, dynamic cache)",
    "checkpoint": "a checkpoint's copy to the host (save) or from it "
                  "(resume, rollback)",
    "eval": "`GNNTrainer._evaluate`: the summed loss, accuracy and count "
            "of an evaluation pass, once per pass",
}

_lock = threading.Lock()
_counts: Dict[str, int] = {}
_depth = [0]                    # open windows, all threads together
_gates: List[object] = []       # the debug mode each open gate set
_local = threading.local()      # this thread's stack of open windows


def counts() -> Dict[str, int]:
    """A copy of the windows entered so far in this process, by name."""
    with _lock:
        return dict(_counts)


def current_window() -> Optional[str]:
    """The innermost window this thread holds open, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def _set_mode(mode) -> None:
    import torch
    torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def allowed_sync(name: str) -> Iterator[None]:
    """A named host read: counted, and let through an open gate."""
    if name not in WINDOWS:
        raise ValueError(f"unknown allowance window {name!r}; the port's "
                         f"windows are {sorted(WINDOWS)}")
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    with _lock:
        _counts[name] = _counts.get(name, 0) + 1
        _depth[0] += 1
        lower = bool(_gates) and _depth[0] == 1
    if lower:
        _set_mode("default")
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()
        with _lock:
            _depth[0] -= 1
            raise_again = _gates[-1] if _gates and _depth[0] == 0 \
                else None
        if raise_again is not None:
            _set_mode(raise_again)


class GateRun:
    """What one `sync_gate` block saw: the windows entered inside it."""

    def __init__(self):
        self._start = counts()
        self._end: Optional[Dict[str, int]] = None

    def counts(self) -> Dict[str, int]:
        """Windows entered since the gate started, by name (those with a
        count of 0 left out)."""
        now = self._end if self._end is not None else counts()
        return {k: n - self._start.get(k, 0) for k, n in sorted(now.items())
                if n - self._start.get(k, 0)}


@contextlib.contextmanager
def sync_gate(mode: str = "error") -> Iterator[GateRun]:
    """CUDA's sync debug mode at `mode` ("error" raises on a sync, "warn"
    warns) for the block, the previous mode restored after it. Needs a
    CUDA device."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("the sync gate needs a CUDA device (it sets "
                           "torch.cuda.set_sync_debug_mode)")
    prev = torch.cuda.get_sync_debug_mode()
    run = GateRun()
    with _lock:
        _gates.append(mode)
        open_windows = _depth[0]
    if not open_windows:
        _set_mode(mode)
    try:
        yield run
    finally:
        run._end = counts()
        with _lock:
            _gates.pop()
        _set_mode(prev)
