"""Op-level contract audit: the port's counterpart of the reference's
jaxpr auditor (`repro/analysis/jaxpr_audit.py`).

JAX traces a jaxpr and the auditor walks it; eager PyTorch has no trace,
so this audit RUNS the real artifacts — the guarded train step with the
dynamic cache, the eval pass, `DeviceBatchBuilder.build`, the device
epoch-order programs, the `gather_agg` / `gather_cached` ops forward and
backward — under a `TorchDispatchMode` (`OpRecorder`) that records every
aten op they issue:

  * the op's overload name ("aten.mul.Tensor");
  * each tensor argument's shape, dtype and device type;
  * each int or bool argument's value, and only the type of each float
    argument (so an lr or a poison value never enters the record).

Over the record it checks what the reference checks over a jaxpr:

  * hygiene — no synchronizing op outside an `allowed_sync` window
    (`_local_scalar_dense`, `nonzero`, `masked_select`, `unique*`,
    `repeat_interleave` without `output_size`, a bool-mask `index`, a
    blocking copy between devices, any op that hands back a host number)
    and no float64 output: the counterparts of "no callback" and "no
    f64 cast / aval";
  * the record's sha1 is the same across (batch, epoch, poison, lr,
    dropout generators, a fresh builder or trainer): an op whose integer
    argument carries the cursor or a word would change it, and such a
    value is what a CUDA graph of the step would freeze — the
    counterpart of the recompile guard;
  * the declared kernels run: on CUDA tensors each op launches its
    hand-written kernel (the wrappers' `LAUNCHES`, the profiler's kernel
    names) and no feature-shaped `index_select` / `index` / `index_add`
    fallback runs; the `csrc/` sources make no blocking runtime call —
    the counterparts of `pallas_calls >= 1` and `feature_gathers == 0`;
  * the builder's epoch-order buffer keeps its `data_ptr` across epochs
    (the counterpart of `_pad_into`'s donation).

Without a card (`device="cpu"`) the kernels' launch checks cannot run:
that section reports `"skipped": "needs a CUDA device"` (and the source
scan), never a silent ok. The sharded step waits for the port's `dist`
(ROADMAP item 10).
"""
from __future__ import annotations

import hashlib
import re
import time
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.sync_gate import counts as window_counts
from repro_torch.analysis.sync_gate import current_window
from repro_torch.devices import DeviceLike, resolve_device

POLICIES = ("rand", "norand", "comm_rand", "clustergcn", "labor")
# tiny's audit shapes (the reference's): batch, fanouts, caps
BATCH, FANOUTS, CAPS = 128, (5, 5), (512, 1024)

# ops that wait for the device whatever their arguments
_SYNC_OPS = {"aten._local_scalar_dense.default", "aten.nonzero.default",
             "aten.masked_select.default", "aten.equal.default",
             "aten.is_nonzero.default"}
_INDEX_OPS = {"aten.index.Tensor", "aten.index_put.default",
              "aten.index_put_.default", "aten._index_put_impl_.default"}
# ops that hand back host metadata without reading the device
_METADATA = ("aten.sym_", "aten.dim", "aten.is_same_size",
             "aten.is_contiguous", "aten.size", "aten.stride",
             "aten.numel", "aten.is_complex", "aten.is_floating_point",
             "aten.is_pinned")
# allocator bookkeeping, not device work: left out of the hash, so that a
# build on a side stream hashes like one on the default stream
_HASH_SKIP = {"aten.record_stream.default"}
# a feature-shaped operand of these is the gather the kernels replace
_GATHER_OPS = ("aten.index_select", "aten.index.Tensor", "aten.index_add",
               "aten.index_put", "aten._index_put_impl_", "aten.gather",
               "aten.embedding", "aten.scatter_add")

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# runtime calls that block the host or implicitly synchronize the device
_BLOCKING = re.compile(
    r"\b(cudaMemcpy|cudaMemcpy2D|cudaMemcpy3D|cudaMemcpyToSymbol|"
    r"cudaMemcpyFromSymbol|cudaMemset|cudaDeviceSynchronize|"
    r"cudaStreamSynchronize|cudaEventSynchronize|cudaMalloc|"
    r"cudaMallocHost|cudaMallocManaged|cudaMallocPitch|cudaHostAlloc|"
    r"cudaFree|cudaFreeHost)\s*\(")
_COMMENTS = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------
def _arg_sig(a) -> str:
    if isinstance(a, torch.Tensor):
        return f"T{tuple(a.shape)}:{str(a.dtype)[6:]}:{a.device.type}"
    if isinstance(a, bool):
        return f"b{a}"
    if isinstance(a, int):
        return f"i{a}"
    if isinstance(a, float):
        return "f"
    if isinstance(a, complex):
        return "c"
    if a is None:
        return "None"
    if isinstance(a, torch.device):
        return f"dev:{a.type}"
    if isinstance(a, (torch.dtype, torch.layout, torch.memory_format,
                      str)):
        return str(a)
    return type(a).__name__


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _sync_reason(name: str, args, kwargs, out) -> Optional[str]:
    """Why this op waits for the device, or None."""
    if name in _SYNC_OPS:
        return name
    if name.startswith(("aten._unique", "aten.unique")):
        return f"{name} (data-dependent size)"
    if name.startswith("aten.repeat_interleave") and \
            name != "aten.repeat_interleave.self_int" and \
            kwargs.get("output_size") is None:
        return f"{name} without output_size"
    if name in _INDEX_OPS and len(args) > 1:
        if any(t.dtype in (torch.bool, torch.uint8)
               for t in _tensors(args[1])):
            return f"{name} with a bool mask (a nonzero inside)"
    if name == "aten._to_copy.default" and args:
        src, dst = args[0].device, kwargs.get("device")
        if dst is not None and torch.device(dst) != src and \
                not kwargs.get("non_blocking", False):
            return f"blocking copy {src.type} -> {torch.device(dst).type}"
    if name == "aten.copy_.default" and len(args) > 1:
        non_blocking = args[2] if len(args) > 2 else \
            kwargs.get("non_blocking", False)
        if args[0].device != args[1].device and not non_blocking:
            return (f"blocking copy {args[1].device.type} -> "
                    f"{args[0].device.type}")
    if isinstance(out, (bool, int, float)) and \
            not name.startswith(_METADATA):
        return f"{name} returns a host value"
    return None


@dataclass
class OpRecord:
    name: str                   # "aten.mul.Tensor"
    sig: str                    # the arguments' signatures
    window: Optional[str]       # the `allowed_sync` window it ran in
    sync: Optional[str]         # why it waits for the device, or None
    f64: bool                   # it produced a float64 tensor
    # (floating point?, shape) of its first tensor argument
    first: Optional[Tuple[bool, tuple]] = None

    def line(self) -> str:
        return f"{self.name}({self.sig})"


class OpRecorder(TorchDispatchMode):
    """Records every aten op issued inside the block (on this thread and
    the autograd engine's), with its signature, window and verdicts."""

    def __init__(self):
        super().__init__()
        self.records: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        sig = ", ".join([_arg_sig(a) for a in tree_flatten(args)[0]] +
                        [f"{k}={_arg_sig(v)}"
                         for k, v in sorted(kwargs.items())])
        self.records.append(OpRecord(
            name, sig, current_window(), _sync_reason(name, args, kwargs,
                                                      out),
            any(t.dtype == torch.float64 for t in _tensors(out)),
            next(((t.is_floating_point(), tuple(t.shape))
                  for t in _tensors(args)), None)))
        return out


def record(fn: Callable, *args, **kwargs) -> Tuple[List[OpRecord], object]:
    """(the ops `fn(*args, **kwargs)` issued, its result)."""
    with OpRecorder() as rec:
        out = fn(*args, **kwargs)
    return rec.records, out


def record_hash(records: List[OpRecord]) -> str:
    """sha1 over the op lines in order: stable iff the op stream is."""
    text = "\n".join(r.line() for r in records if r.name not in _HASH_SKIP)
    return hashlib.sha1(text.encode()).hexdigest()


def hygiene(records: List[OpRecord]) -> dict:
    """The common checks; `ok` is their conjunction. Syncs inside an
    `allowed_sync` window are counted by window, not failed."""
    bad = [r for r in records if r.sync and r.window is None]
    f64 = [r for r in records if r.f64]
    allowed = Counter(r.window for r in records if r.sync and r.window)
    return {"ops": len(records), "syncs": len(bad),
            "sync_ops": sorted({r.sync for r in bad}),
            "allowed_syncs": dict(sorted(allowed.items())),
            "f64": len(f64), "f64_ops": sorted({r.name for r in f64}),
            "ok": not bad and not f64}


def feature_gathers(records: List[OpRecord], feat_dim: int) -> List[str]:
    """Gather / scatter ops over a feature-shaped (rows, F) float operand:
    the materialised fallback the kernels exist to avoid. Integer
    lookups and other shapes are not flagged."""
    out = []
    for r in records:
        if not r.name.startswith(_GATHER_OPS) or r.first is None:
            continue
        floating, shape = r.first
        if floating and len(shape) == 2 and shape[1] == feat_dim:
            out.append(r.line())
    return out


def _stable(hashes: List[str]) -> dict:
    return {"hash": hashes[0], "stable": len(set(hashes)) == 1}


def _all_ok(rep: dict) -> dict:
    rep["ok"] = all(v["ok"] for k, v in rep.items() if k != "ok")
    return rep


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------
def _tiny():
    from repro_torch.core.reorder import prepare
    from repro_torch.graphs import synthetic
    return prepare(synthetic.load("tiny"), oracle=True)


def audit_donation(graph, device: DeviceLike = None) -> dict:
    """The epoch-order buffer is allocated once and refreshed in place:
    its `data_ptr` is the same in every epoch, for the async builder and
    for the sync stream's copy of the numpy order."""
    from repro_torch.batching import BatchStream
    from repro_torch.pipeline.builder import DeviceBatchBuilder
    dev = resolve_device(device)
    b = DeviceBatchBuilder(graph, "comm_rand", BATCH, FANOUTS, CAPS, seed=7,
                           device=dev)
    s = BatchStream(graph, "comm_rand", BATCH, FANOUTS, CAPS, seed=7,
                    device=dev)
    builder = {b.epoch_roots(e).data_ptr() for e in range(3)}
    stream = {s.epoch_roots(e).data_ptr() for e in range(3)}
    return {"builder_order_reused": len(builder) == 1,
            "stream_order_reused": len(stream) == 1,
            "ok": len(builder) == 1 and len(stream) == 1}


def scan_sources(csrc: Path = CSRC) -> dict:
    """Blocking CUDA runtime calls in the kernels' sources (comments
    stripped): the sync debug mode cannot see inside them."""
    found = []
    files = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    for path in files:
        text = path.read_text()
        code = _COMMENTS.sub(lambda m: "\n" * m.group(0).count("\n"), text)
        for i, line in enumerate(code.splitlines(), start=1):
            for m in _BLOCKING.finditer(line):
                found.append({"file": path.name, "line": i,
                              "call": m.group(1)})
    return {"files": len(files), "blocking_calls": found, "ok": not found}


# the CUDA kernel names each op's launches show in the profiler
_KERNEL_NAMES = {"gather_agg_fwd": "fwd_kernel",
                 "gather_agg_bwd_dx": "bwd_dx",
                 "gather_agg_bwd_dw": "bwd_dw_kernel",
                 "gather_cached_fwd": "gather_cached_kernel"}


def _profiled(fn: Callable, reps: int = 5, pad_s: float = 0.25,
              tries: int = 3) -> Tuple[List[OpRecord], List[str], int]:
    """(ops, CUDA kernel names, windows taken) of `reps` calls of `fn`.

    The profiler drops a device event whose timestamp, read on the
    card's clock, falls outside the window the host's clock opened and
    closed; on the H100 a kernel has been stamped over a millisecond
    before the host's clock read at its launch
    (`tools/profiler_window_probe.py`). The calls therefore run `pad_s`
    seconds inside each edge of the window.
    A window whose trace holds no device event at all lost the trace,
    not the kernels, and is taken again, up to `tries` windows; a trace
    that holds kernels but not ours is returned as it is."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            records, _ = record(lambda: [fn() for _ in range(reps)])
            torch.cuda.synchronize()
            time.sleep(pad_s)
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return records, names, attempt


def audit_kernels(device: DeviceLike = None, *, n_src: int = 64,
                  n_dst: int = 16, r: int = 4, feat_dim: int = 32,
                  capacity: int = 8) -> dict:
    """`gather_agg` and `gather_cached`, forward and backward, on CUDA
    tensors: each launches its hand-written kernels (`LAUNCHES` and the
    profiler's kernel names), issues no sync and no float64, and runs no
    feature-shaped gather or scatter fallback; and the `csrc/` sources
    make no blocking runtime call."""
    from repro_torch.kernels.gather_agg import kernel as agg_kernel
    from repro_torch.kernels.gather_agg.ops import gather_agg
    from repro_torch.kernels.gather_cached import kernel as cached_kernel
    from repro_torch.kernels.gather_cached.ops import gather_cached
    dev = resolve_device(device)
    out = {"sources": scan_sources()}
    if dev.type != "cuda":
        out["skipped"] = "needs a CUDA device"
        out["ok"] = out["sources"]["ok"]
        return out
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((n_src, feat_dim), generator=gen).to(dev)
    w = torch.rand((n_dst, r), generator=gen).to(dev)
    idx = torch.randint(0, n_src, (n_dst, r), generator=gen,
                        dtype=torch.int32).to(dev)
    cache = torch.randn((capacity, feat_dim), generator=gen).to(dev)
    pos = torch.full((n_src,), -1, dtype=torch.int32)
    pos[:capacity] = torch.arange(capacity, dtype=torch.int32)
    pos = pos.to(dev)
    ids = torch.randint(-1, n_src, (n_dst * r,), generator=gen,
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

    agg()                                       # builds the libraries
    cached()
    for name, fn, mod, want in (
            ("gather_agg", agg, agg_kernel,
             ("gather_agg_fwd", "gather_agg_bwd_dx", "gather_agg_bwd_dw")),
            ("gather_cached", cached, cached_kernel,
             ("gather_cached_fwd",))):
        before = dict(agg_kernel.LAUNCHES, **cached_kernel.LAUNCHES)
        records, kernels, windows = _profiled(fn)
        after = dict(agg_kernel.LAUNCHES, **cached_kernel.LAUNCHES)
        if name == "gather_cached":             # its backward is bwd_dx's
            want = want + ("gather_agg_bwd_dx",)
        launches = {k: after[k] - before[k] for k in want}
        shown = {k: any(_KERNEL_NAMES[k] in n for n in kernels)
                 for k in want}
        rep = hygiene(records)
        rep["launches"] = launches
        rep["profiled"] = shown
        rep["trace_kernels"] = len(kernels)
        rep["windows"] = windows
        rep["feature_gathers"] = len(feature_gathers(records, feat_dim))
        rep["indexing_backward"] = sum("indexing_backward" in n
                                       for n in kernels)
        rep["ok"] = (rep["ok"] and all(n >= 1 for n in launches.values())
                     and all(shown.values()) and not rep["feature_gathers"]
                     and not rep["indexing_backward"])
        out[name] = rep
    return _all_ok(out)


def _policy(name: str):
    from repro_torch.batching import make_policy
    return make_policy(name)


def audit_device_order(graph, device: DeviceLike = None, *,
                       seed: int = 7) -> dict:
    """Per policy: the device epoch-order program passes hygiene and its
    record hashes the same across epochs and seeds and for a fresh
    `OrderSpec` (resume): only the two epoch words' values vary, and they
    ride in as a tensor."""
    from repro_torch.pipeline.device_order import (OrderSpec,
                                                   device_epoch_order,
                                                   epoch_words_for)
    dev = resolve_device(device)
    out = {}
    for name in POLICIES:
        policy = _policy(name)
        spec = OrderSpec.for_policy(graph, policy, dev)
        spec2 = OrderSpec.for_policy(graph, policy, dev)
        runs = [record(device_epoch_order, s, epoch_words_for(sd, e))[0]
                for s, sd, e in ((spec, seed, 0), (spec, seed, 1),
                                 (spec, seed + 1, 0), (spec2, seed, 0))]
        rep = hygiene(runs[0])
        rep.update(_stable([record_hash(r) for r in runs]))
        rep["ok"] = rep["ok"] and rep["stable"]
        out[name] = rep
    return _all_ok(out)


def audit_fused_build(graph, device: DeviceLike = None, *,
                      seed: int = 7) -> dict:
    """Per policy: `DeviceBatchBuilder.build` passes hygiene and hashes
    the same across pos, epoch and a fresh builder (resume). The epoch's
    order and shared sampler state are made before the record, as the
    reference traces its fused build with them as arguments. The sync
    stream's `_take` must issue the very same ops."""
    from repro_torch.batching import BatchStream
    from repro_torch.pipeline.builder import DeviceBatchBuilder
    dev = resolve_device(device)
    out = {}
    for name in POLICIES:
        policy = _policy(name)
        b, b2 = (DeviceBatchBuilder(graph, policy, BATCH, FANOUTS, CAPS,
                                    seed=seed, device=dev) for _ in "ab")
        s = BatchStream(graph, policy, BATCH, FANOUTS, CAPS, seed=seed,
                        device=dev)
        runs = []
        for bb, e, p in ((b, 0, 0), (b, 0, 1), (b, 1, 0), (b2, 0, 0)):
            bb.epoch_roots(e)
            bb.epoch_ranks(e)
            runs.append(record(bb.build, e, p)[0])
        s.epoch_roots(0)
        s.epoch_ctx(0)
        sync = record(s._take, 0, 1)[0]
        rep = hygiene(runs[0])
        rep.update(_stable([record_hash(r) for r in runs]))
        rep["sync_stream_same_ops"] = record_hash(sync) == rep["hash"]
        rep["ok"] = rep["ok"] and rep["stable"] and \
            rep["sync_stream_same_ops"] and hygiene(sync)["ok"]
        out[name] = rep
    return _all_ok(out)


def make_trainer(graph, device: DeviceLike = None, *, seed: int = 3,
                 cache="dynamic:degree_hot", pipeline: str = "sync", **kw):
    """The audit's trainer: 2-layer SAGE at width 16 with dropout, the
    guard on, comm_rand batches of 128 at the reference's caps, and the
    dynamic cache (the richest step)."""
    from repro_torch.configs import GNNConfig, TrainConfig
    from repro_torch.train.gnn_loop import GNNTrainer
    cfg = GNNConfig("sage-audit", "sage", 2, 16, graph.feat_dim,
                    graph.num_classes, fanout=FANOUTS)
    tcfg = TrainConfig(batch_size=BATCH, max_epochs=1)
    return GNNTrainer(graph, cfg, tcfg, _policy("comm_rand"), caps=CAPS,
                      eval_caps=CAPS, seed=seed, cache=cache,
                      pipeline=pipeline, guard=True,
                      device=resolve_device(device), **kw)


def step_record(tr, batch, *, poison: float = 1.0, lr: float = 1e-3,
                gen_seed: int = 0) -> List[OpRecord]:
    """The ops of one guarded train step on `batch` and its fold of the
    batch's reads into the dynamic cache (`_train_one`'s device work),
    with the dropout generators of `gen_seed` made before the record."""
    from repro_torch.batching.stream import SALT_DROPOUT, cursor_generator
    from repro_torch.featcache import dynamic
    gens = [cursor_generator(tr.device, gen_seed, 0, 0, i, SALT_DROPOUT)
            for i in range(tr.cfg.num_layers - 1)]

    def step():
        tr.train_step(batch, lr, gens, poison)
        if isinstance(tr.cache, dynamic.DynamicCacheState):
            tr._set_cache(dynamic.with_refs(
                tr.cache, dynamic.ref_updates(tr.cache, batch.node_ids)))

    return record(step)[0]


def audit_train_step(graph, device: DeviceLike = None) -> dict:
    """The guarded train step with the dynamic cache: hygiene, and one
    record hash across poison on and off, a changed lr with other dropout
    generators, another batch and a fresh trainer (resume). The eval pass
    passes hygiene (its one read in the "eval" window), and `train_steps`
    opens exactly the windows `promised_reads` promises."""
    from repro_torch.pipeline.builder import DeviceBatchBuilder
    dev = resolve_device(device)
    tr = make_trainer(graph, dev)
    b = DeviceBatchBuilder.from_stream(tr.stream)
    batch0, batch1 = b.build(0, 0), b.build(0, 1)
    tr.train_steps(1)                           # first use: libraries
    base = step_record(tr, batch0)
    runs = [base, step_record(tr, batch0, poison=float("nan")),
            step_record(tr, batch0, lr=3e-4, gen_seed=5),
            step_record(tr, batch1)]
    tr2 = make_trainer(graph, dev)              # resume: rebuilt
    runs.append(step_record(tr2, DeviceBatchBuilder.from_stream(
        tr2.stream).build(0, 0)))
    rep = hygiene(base)
    rep.update(_stable([record_hash(r) for r in runs]))
    rep["eval"] = hygiene(record(tr.evaluate, graph.val_ids[:BATCH])[0])
    promised = tr.promised_reads(2)
    start = window_counts()
    loop = hygiene(record(tr.train_steps, 2)[0])
    end = window_counts()
    loop["windows"] = {k: end[k] - start.get(k, 0) for k in sorted(end)
                       if end[k] - start.get(k, 0)}
    loop["promised"] = promised
    loop["ok"] = loop["ok"] and loop["windows"] == promised
    rep["loop"] = loop
    rep["ok"] = rep["ok"] and rep["stable"] and rep["eval"]["ok"] and \
        loop["ok"]
    return rep


def audit_sharded_step() -> dict:
    """The data-parallel step waits for the port's `dist` (ROADMAP item
    10): reported by name, neither run nor passed."""
    return {"waiting": "ROADMAP item 10: the port has no repro_torch.dist "
                       "yet", "ok": True}


SECTIONS = ("donation", "kernels", "device_order", "fused_build",
            "train_step", "sharded_step")


def audit_all(graph=None, device: DeviceLike = None) -> dict:
    """Every section on `device` (the CUDA device unless the caller asks
    for the CPU); `graph` defaults to the `tiny` synthetic dataset."""
    dev = resolve_device(device)
    graph = _tiny() if graph is None else graph
    report = {
        "device": dev.type,
        "donation": audit_donation(graph, dev),
        "kernels": audit_kernels(dev, feat_dim=graph.feat_dim),
        "device_order": audit_device_order(graph, dev),
        "fused_build": audit_fused_build(graph, dev),
        "train_step": audit_train_step(graph, dev),
        "sharded_step": audit_sharded_step(),
    }
    report["ok"] = all(report[k]["ok"] for k in SECTIONS)
    return report


def section_status(rep: dict) -> str:
    """"ok", "FAIL", "skipped (...)" or "waiting (...)"."""
    if "waiting" in rep:
        return "waiting (ROADMAP item 10)"
    if not rep["ok"]:
        return "FAIL"
    if "skipped" in rep:
        return f"skipped ({rep['skipped']})"
    return "ok"
