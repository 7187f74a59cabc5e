"""`repro_torch.obs`: the tracer's JSONL round trip and Perfetto
conformance, the analyzer's arithmetic on synthetic span sets, the
MetricsHub primitives and export schema, each meter's hub mirror — the
unit tests of the reference's `tests/test_obs.py`, run on the port — and
the port held against the reference: `analyze` and `validate_events` give
the same dicts on the same events (synthetic, and a trace the port's
trainer wrote). Then the trainer: its span taxonomy beside the
reference's, traced against untraced losses bit for bit, meter
absorption on a real run, and `python -m repro_torch.obs` on a trace."""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import report as R_ref
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic
from repro_torch.obs import metrics as M
from repro_torch.obs import report as R
from repro_torch.obs import trace as T
from repro_torch.obs.__main__ import main as obs_cli
from repro_torch.resilience.guard import GuardConfig
from repro_torch.train.gnn_loop import GNNTrainer
from repro_torch.train.monitor import (HitRateMeter, ResilienceMeter,
                                       StragglerMonitor)

SRC = Path(__file__).resolve().parents[1] / "src"
BATCH, FANOUTS, CAPS = 128, (5, 5), (512, 1024)


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    """Every test starts and ends with tracing disabled."""
    T.uninstall()
    yield
    T.uninstall()


@pytest.fixture(scope="module")
def tiny_t():
    return prepare(synthetic.load("tiny"), oracle=True)


def _trainer(g, guard=GuardConfig(max_consecutive_skips=2, check_every=1,
                                  max_rollbacks=4), pipeline="sync", **kw):
    """The reference soak's shape (2-layer SAGE, comm_rand, dynamic
    degree_hot cache, guard read every step) with the biased sampler: the
    port has no LABOR yet."""
    cfg = GNNConfig("sage-obs", "sage", 2, 16, g.feat_dim, g.num_classes,
                    fanout=FANOUTS)
    return GNNTrainer(g, cfg, TrainConfig(batch_size=BATCH, max_epochs=4),
                      "comm_rand", caps=CAPS, eval_caps=CAPS, seed=3,
                      cache="dynamic:degree_hot", pipeline=pipeline,
                      guard=guard, device="cpu", **kw)


# ---------------------------------------------------------------------------
# tracer: JSONL round trip + conformance
# ---------------------------------------------------------------------------
def test_trace_jsonl_roundtrip(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with T.enabled(p, run="unit") as tr:
        with T.span("alpha", cat="step", step=3):
            pass
        with T.span("beta", cat="sync") as s:
            s.set(found=7)
        T.instant("tick", cat="host", k=1)
        tr.flush()
    evs = R.load_trace(p)
    assert [e["name"] for e in evs] == ["alpha", "beta", "tick"]
    a, b, i = evs
    assert a["cat"] == "step" and a["ph"] == "X" and a["dur"] >= 0
    assert a["args"]["step"] == 3
    assert b["args"]["found"] == 7          # set() attached mid-span
    assert i["ph"] == "i"
    with_meta = R.load_trace(p, include_meta=True)
    assert with_meta[0]["ph"] == "M"
    assert with_meta[0]["args"]["schema_version"] == T.TRACE_SCHEMA_VERSION
    assert with_meta[0]["args"]["run"] == "unit"
    # the reference's loader reads the port's file to the same events
    assert R_ref.load_trace(p, include_meta=True) == with_meta


def test_trace_conformance_and_chrome_wrapper(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with T.enabled(p) as tr:
        for i in range(5):
            with T.span(f"s{i}", cat="step"):
                pass
        tr.flush()
    evs = R.load_trace(p)
    assert R.validate_events(evs) == []
    out = str(tmp_path / "chrome.json")
    R.to_chrome(evs, out)
    wrapped = json.loads(open(out).read())
    assert set(wrapped) == {"traceEvents", "displayTimeUnit"}
    assert len(wrapped["traceEvents"]) == 5
    for ev in wrapped["traceEvents"]:       # the Perfetto-required keys
        assert {"name", "cat", "ph", "ts", "pid", "tid",
                "dur"} <= set(ev)


def test_validate_events_flags_malformed():
    bad = [{"name": "x", "cat": "c", "ph": "X", "ts": 0.0, "pid": 1,
            "tid": 1},                       # X without dur
           {"cat": "c", "ph": "i", "ts": 0.0, "pid": 1, "tid": 1},  # no name
           {"name": "y", "cat": "c", "ph": "X", "ts": 0.0, "pid": 1,
            "tid": 1, "dur": -3.0},          # negative dur
           {"name": "z", "cat": "c", "ph": "i", "ts": 0.0, "pid": 1,
            "tid": 1, "args": [1]}]          # args not a dict
    problems = R.validate_events(bad)
    assert len(problems) == 4
    assert problems == R_ref.validate_events(bad)


def test_load_trace_raises_on_torn_line(tmp_path):
    p = tmp_path / "torn.jsonl"
    p.write_text('{"name": "ok", "cat": "c", "ph": "i", "ts": 0, '
                 '"pid": 1, "tid": 1}\n{"name": "torn", "ca\n')
    with pytest.raises(ValueError, match="bad trace line"):
        R.load_trace(str(p))


def test_disabled_tracing_is_noop_singleton():
    assert T.current() is None
    s = T.span("anything", cat="step", x=1)
    assert s is T.NOOP                      # no allocation when disabled
    with s as inner:
        inner.set(y=2)                      # chainable, does nothing
    T.instant("nothing")                    # no tracer: swallowed


def test_tracer_multithread_tids():
    with T.enabled(None) as tr:
        with T.span("main_work", cat="step"):
            pass

        def worker():
            with T.span("thread_work", cat="producer"):
                pass

        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        evs = tr.events()
    tids = {e["name"]: e["tid"] for e in evs}
    assert tids["main_work"] != tids["thread_work"]


def test_device_step_timer_disabled_and_enabled():
    t = T.DeviceStepTimer()
    t.note(out=None)                        # disabled: pure no-op
    t.flush("epoch")
    with T.enabled(None) as tr:
        for _ in range(3):
            t.note(out=torch.zeros(()))
        t.flush(site="epoch")
        evs = tr.events()
    assert len(evs) == 1
    ev = evs[0]
    assert ev["name"] == "device_steps" and ev["cat"] == "device"
    assert ev["args"]["n"] == 3 and ev["args"]["site"] == "epoch"
    assert ev["args"]["per_step_us"] == pytest.approx(ev["dur"] / 3)
    with T.enabled(None) as tr2:            # the window resets after flush
        t.flush("epoch")
        assert tr2.events() == []


def test_device_step_timer_never_reads_the_device(monkeypatch):
    """The timer waits for nothing itself: no synchronize, no item(), no
    copy to the host (it rides a drain the trainer already makes)."""
    def boom(*a, **k):
        raise AssertionError("DeviceStepTimer read the device")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.Tensor, "item", boom)
    monkeypatch.setattr(torch.Tensor, "cpu", boom)
    t = T.DeviceStepTimer()
    with T.enabled(None) as tr:
        t.note(torch.ones(()))
        t.flush("train_steps")
        assert len(tr.events()) == 1


def test_replica_view_pids_and_header():
    with T.enabled(None) as tr:
        v0, v1 = tr.for_replica(0), tr.for_replica(1)
        assert tr.for_replica(0) is v0
        v1.emit_span("train_step", "step", 5.0, 2.0, step=0)
        v0.instant("tick")
        evs = tr.events()
    assert v0.pid != v1.pid and tr.pid not in (v0.pid, v1.pid)
    heads = [e for e in evs if e["ph"] == "M"]
    assert [h["args"]["replica"] for h in heads] == [0, 1]
    (x,) = [e for e in evs if e["ph"] == "X"]
    assert x["pid"] == v1.pid and x["args"] == {"step": 0, "replica": 1}


# ---------------------------------------------------------------------------
# analyzer arithmetic on synthetic span sets (times in us)
# ---------------------------------------------------------------------------
def _x(name, cat, ts, dur, tid=1, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": float(ts),
            "dur": float(dur), "pid": 7, "tid": tid, "args": args}


def _xp(pid, name, cat, ts, dur, **args):
    ev = _x(name, cat, ts, dur, **args)
    ev["pid"] = pid
    return ev


SYNTHETIC = {
    "overlap": [_x("producer_build", "producer", 0, 10, tid=2),
                _x("producer_build", "producer", 20, 10, tid=2),
                _x("train_step", "step", 5, 20, tid=1)],
    "sync_only": [_x("train_step", "step", 0, 10),
                  _x("epoch_flush", "sync", 10, 2)],
    "stalls": [_x("queue_get_wait", "wait", 0, 30),
               _x("queue_get_wait", "wait", 50, 10),
               _x("queue_put_wait", "wait", 60, 40)],
    "mid_epoch": [_x("epoch", "loop", 0, 100, epoch=0),
                  _x("train_step", "step", 0, 20, step=0),
                  _x("guard_sync", "sync", 25, 5),
                  _x("train_step", "step", 40, 20, step=1),
                  _x("cache_refill", "sync", 45, 5),
                  _x("epoch_flush", "sync", 62, 5)],
    "empty_epoch": [_x("epoch", "loop", 0, 10, epoch=4),
                    _x("stats_flush", "sync", 2, 1)],
    "per_pid": [_xp(7, "epoch", "loop", 0, 100, epoch=0),
                _xp(7, "train_step", "step", 0, 15, step=0),
                _xp(7, "train_step", "step", 20, 15, step=1),
                _xp(7, "epoch_flush", "sync", 36, 4, epoch=0),
                _xp(1001, "epoch", "loop", 0, 100, epoch=0),
                _xp(1001, "train_step", "step", 0, 15, step=0),
                _xp(1001, "halo_wait", "sync", 50, 5),
                _xp(1001, "train_step", "step", 80, 15, step=1),
                _xp(1001, "epoch_flush", "sync", 96, 4, epoch=0)],
    "empty": [],
}


def test_interval_arithmetic():
    assert R.merge_intervals([(0, 10), (5, 15), (20, 30)]) == \
        [(0, 15), (20, 30)]
    assert R.intersect_total([(0, 10), (20, 30)], [(5, 25)]) == 10.0
    assert R.intersect_total([(0, 10)], [(10, 20)]) == 0.0


def test_overlap_fraction_synthetic():
    ov = R.overlap_fraction(SYNTHETIC["overlap"])
    # producer busy [0,10]+[20,30]=20us; steps [5,25]; overlap 5+5=10us
    assert ov["producer_busy_s"] == pytest.approx(20 / 1e6)
    assert ov["overlap_s"] == pytest.approx(10 / 1e6)
    assert ov["overlap_frac"] == pytest.approx(0.5)


def test_sync_pipeline_overlap_is_zero_by_construction():
    ov = R.overlap_fraction(SYNTHETIC["sync_only"])
    assert ov["producer_busy_s"] == 0.0 and ov["overlap_frac"] == 0.0


def test_stall_attribution_synthetic():
    st = R.stall_attribution(SYNTHETIC["stalls"])
    assert st["queue_get_wait"]["count"] == 2
    assert st["queue_get_wait"]["total_s"] == pytest.approx(40 / 1e6)
    assert st["queue_put_wait"]["frac_of_wall"] == pytest.approx(0.4)


def test_epoch_rollups_and_mid_epoch_sync_gate():
    evs = SYNTHETIC["mid_epoch"]
    (ep,) = R.epoch_rollups(evs)
    assert ep["epoch"] == 0 and ep["n_steps"] == 2
    assert ep["mid_epoch_syncs"] == 1
    assert ep["mid_epoch_sync_names"] == ["guard_sync"]
    assert ep["spans"]["train_step"]["count"] == 2
    rep = R.analyze(evs)
    assert rep["mid_epoch_sync_count"] == 1
    assert rep["sync_sites"]["epoch_flush"]["count"] == 1


def test_epoch_rollup_empty_epoch_has_no_mid_syncs():
    (ep,) = R.epoch_rollups(SYNTHETIC["empty_epoch"])
    assert ep["n_steps"] == 0 and ep["mid_epoch_syncs"] == 0


def test_per_pid_gate_fails_on_dirty_rank1_even_when_rank0_clean():
    """Rank 1's sync at ts 50 is after rank 0's last step but before its
    own: judged per pid it is mid-epoch, and rank 0 stays clean."""
    eps = {ep["pid"]: ep for ep in R.epoch_rollups(SYNTHETIC["per_pid"])}
    assert set(eps) == {7, 1001}
    assert eps[7]["mid_epoch_syncs"] == 0 and eps[7]["n_steps"] == 2
    assert eps[7]["spans"]["train_step"]["count"] == 2
    assert eps[1001]["mid_epoch_syncs"] == 1
    assert eps[1001]["mid_epoch_sync_names"] == ["halo_wait"]
    rep = R.analyze(SYNTHETIC["per_pid"])
    assert rep["mid_epoch_sync_count"] == 1
    assert rep["mid_epoch_sync_by_pid"] == {"7": 0, "1001": 1}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_analyze_equals_the_reference_on_synthetic_events(name):
    evs = SYNTHETIC[name]
    assert R.analyze(evs) == R_ref.analyze(evs)
    assert R.validate_events(evs) == R_ref.validate_events(evs)


# ---------------------------------------------------------------------------
# metrics hub
# ---------------------------------------------------------------------------
def test_counter_gauge_histogram_primitives():
    h = M.MetricsHub()
    c = h.counter("c")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    h.gauge("g").set(2.5)
    assert h.gauge("g").value == 2.5
    hist = h.histogram("h")
    for v in [5.0, 1.0, 3.0, 2.0, 4.0]:
        hist.observe(v)
    s = hist.summary()
    assert s["count"] == 5 and s["min"] == 1.0 and s["max"] == 5.0
    assert s["p50"] == 3.0
    assert hist.percentile(0) == 1.0 and hist.percentile(100) == 5.0
    assert M.Histogram("empty").summary()["count"] == 0


def test_hub_name_bound_to_one_type():
    h = M.MetricsHub()
    h.counter("x")
    with pytest.raises(TypeError):
        h.gauge("x")
    assert h.counter("x") is h.counter("x")     # get-or-create


def test_hub_epoch_marks_are_counter_deltas():
    h = M.MetricsHub()
    h.counter("hits").inc(10)
    h.gauge("rate").set(0.5)
    e0 = h.mark_epoch(0)
    h.counter("hits").inc(3)
    h.gauge("rate").set(0.7)
    e1 = h.mark_epoch(1)
    assert e0["hits"] == 10 and e1["hits"] == 3      # delta, not total
    assert e1["rate"] == 0.7
    assert h.epochs == [e0, e1]
    assert h.snapshot()["hits"] == 13                # totals unharmed


def test_export_schema_and_run_metadata():
    h = M.MetricsHub()
    h.counter("n").inc()
    h.mark_epoch(0)
    out = h.export(extra={"tag": "unit"})
    assert out["schema"] == M.OBS_SCHEMA_VERSION
    assert out["metrics"]["n"] == 1
    assert len(out["epochs"]) == 1
    assert out["tag"] == "unit"
    meta = out["meta"]
    assert set(meta) == {"schema", "backend", "torch", "cuda", "device",
                         "power_limit", "git_commit", "hostname", "python"}
    assert meta["torch"] == torch.__version__
    if not torch.cuda.is_available():       # this CPU box: nulls, no raise
        assert meta["backend"] == "cpu"
        assert meta["device"] is None and meta["power_limit"] is None
    json.dumps(out)                                  # JSON-serializable


# ---------------------------------------------------------------------------
# meter mirrors: hub series == meter fields, exactly
# ---------------------------------------------------------------------------
def test_hitrate_meter_mirrors_hub():
    h = M.MetricsHub()
    m = HitRateMeter(hub=h)
    m.observe(7, 3)
    m.observe(5, 5)
    m.observe_refill(40)
    m.note_degraded(step=9)
    assert h.counter("cache/hits").value == m.hits == 12
    assert h.counter("cache/misses").value == m.misses == 8
    assert h.counter("cache/refills").value == m.refills == 40
    assert h.counter("cache/degradations").value == 1
    assert h.gauge("cache/hit_rate").value == m.hit_rate


def test_resilience_meter_mirrors_hub():
    h = M.MetricsHub()
    m = ResilienceMeter(hub=h)
    m.note("rollbacks", step=3)
    m.note("skipped_steps", step=1)
    m.note("skipped_steps", step=2)
    m.note("producer_restarts", epoch=0, pos=4)
    assert h.counter("resilience/rollbacks").value == m.rollbacks == 1
    assert h.counter("resilience/skipped_steps").value \
        == m.skipped_steps == 2
    assert h.counter("resilience/producer_restarts").value == 1


def test_straggler_monitor_mirrors_hub_and_windows():
    h = M.MetricsHub()
    m = StragglerMonitor(warmup=2, threshold=2.0, hub=h)
    for _ in range(4):
        m.observe(0.01, 0)              # warmup + 2 normal
    mark = m.mark()
    m.observe(10.0, 4)                  # straggler
    m.observe(0.01, 5)
    assert h.counter("straggler/steps").value == m.count == 6
    assert h.counter("straggler/events").value == len(m.events) == 1
    assert h.gauge("straggler/fraction").value == m.straggler_fraction
    assert h.histogram("straggler/step_time_s").count == 6
    assert m.fraction_since(mark) == pytest.approx(0.5)
    assert m.fraction_since(m.mark()) == 0.0


def test_meter_absorption_on_real_trainer_run(tiny_t):
    """20 guarded dynamic-cache steps across an epoch boundary: every hub
    series equals the meter's own field."""
    tr = _trainer(tiny_t)
    tr.train_steps(20)
    hub = tr.hub
    assert tr.cache_meter.refills > 0
    assert hub.counter("cache/hits").value == tr.cache_meter.hits
    assert hub.counter("cache/misses").value == tr.cache_meter.misses
    assert hub.counter("cache/refills").value == tr.cache_meter.refills
    assert hub.gauge("cache/hit_rate").value == tr.cache_meter.hit_rate
    assert hub.counter("straggler/steps").value == tr.straggler.count == 20
    assert hub.gauge("straggler/fraction").value \
        == tr.straggler.straggler_fraction
    for kind, n in tr.guard_meter.counts().items():
        assert hub.counter(f"resilience/{kind}").value == n
    out = hub.export()
    assert out["schema"] == M.OBS_SCHEMA_VERSION
    assert out["metrics"]["cache/hits"] == tr.cache_meter.hits


# ---------------------------------------------------------------------------
# trainer integration: spans, bit-exactness, the CLI
# ---------------------------------------------------------------------------
# the reference trainer's spans in a guarded (check_every=1) run_epoch that
# the port does not emit, and why: its `_drain` reads the losses, the
# cache counters and the guard flags in the one `epoch_flush` copy, where
# the reference reads the counters in a `stats_flush` of their own (the
# port's `stats_flush` is the drain before a rollback)
NOT_EMITTED = {"stats_flush": "folded into epoch_flush / steps_flush"}
# names the port's run_epoch emits: the reference's, less NOT_EMITTED
EXPECTED = {"train_step", "epoch", "epoch_flush", "device_steps",
            "guard_sync", "stats_flush"} - set(NOT_EMITTED)


def test_trainer_emits_expected_span_taxonomy(tiny_t):
    tr = _trainer(tiny_t)
    with T.enabled(None) as tracer:
        d = tr.run_epoch(1e-3)
        evs = tracer.events()
    names = {e["name"] for e in evs}
    assert EXPECTED <= names
    assert not set(NOT_EMITTED) & names
    # the dynamic cache's boundary: the refill inside the last step
    assert {"cache_refill", "clock_refill"} <= names
    assert 0.0 <= d["straggler"] <= 1.0
    (dev,) = [e for e in evs if e["name"] == "device_steps"]
    n_steps = len([e for e in evs if e["name"] == "train_step"])
    assert dev["args"]["n"] == n_steps and dev["args"]["site"] == "epoch"
    cats = {e["name"]: e["cat"] for e in evs}
    assert cats["guard_sync"] == cats["epoch_flush"] == \
        cats["cache_refill"] == "sync"
    assert cats["clock_refill"] == "cache" and cats["epoch"] == "loop"
    assert tr.hub.epochs and tr.hub.epochs[-1]["epoch"] == 0


def test_rollback_and_eval_spans(tiny_t, tmp_path):
    """A NaN burst past the skip budget: the rollback's `stats_flush`,
    `ckpt_rollback` and `ckpt_restore`, the saves' `ckpt_save`; then
    `eval`."""
    from repro_torch.resilience import FaultPlan, FaultSpec, faults
    tr = _trainer(tiny_t, ckpt_dir=str(tmp_path), ckpt_every=4)
    plan = FaultPlan(specs=(FaultSpec("step_nonfinite", 5, 3),))
    with T.enabled(None) as tracer, faults.inject(plan):
        tr.train_steps(10)
        tr.evaluate(tiny_t.val_ids[:BATCH])
        evs = tracer.events()
    assert tr.guard_meter.rollbacks == 1
    cats = {}
    for e in evs:
        cats.setdefault(e["name"], e["cat"])
    assert cats["stats_flush"] == cats["ckpt_save"] == "sync"
    assert cats["ckpt_rollback"] == cats["ckpt_restore"] == "ckpt"
    assert cats["eval"] == "eval" and cats["steps_flush"] == "sync"


def test_tracing_on_off_loss_bit_exact(tiny_t):
    """Tracing touches no generator, batch or sync: the traced run's
    losses equal the untraced run's, per step."""
    with T.enabled(None):
        traced = _trainer(tiny_t, guard=None).train_steps(14)
    untraced = _trainer(tiny_t, guard=None).train_steps(14)
    assert traced == untraced


def test_async_trace_matches_reference_report_and_passes_gates(tiny_t,
                                                               tmp_path):
    """A trace the port's async trainer wrote (guard and checkpoints off,
    as the reference's traced run sets them): the port's and the
    reference's analyzers give the same report; producer/consumer overlap
    > 0, no mid-epoch sync, no conformance problem; the epoch's losses
    equal an untraced async run's."""
    p = str(tmp_path / "async.jsonl")
    tr = _trainer(tiny_t, guard=None, pipeline="async")
    try:
        with T.enabled(p, run="unit", pipeline="async") as tracer:
            traced = [tr.run_epoch(1e-3)["loss"] for _ in range(2)]
            tracer.flush()
    finally:
        tr.stream.close()
    ref = _trainer(tiny_t, guard=None, pipeline="async")
    try:
        untraced = [ref.run_epoch(1e-3)["loss"] for _ in range(2)]
    finally:
        ref.stream.close()
    assert traced == untraced
    evs = R.load_trace(p)
    rep = R.analyze(evs)
    assert rep == R_ref.analyze(R_ref.load_trace(p))
    assert R.validate_events(evs) == R_ref.validate_events(evs) == []
    assert rep["overlap"]["overlap_frac"] > 0
    assert rep["mid_epoch_sync_count"] == 0
    assert len(rep["epochs"]) == 2
    assert {"producer_build", "queue_get_wait", "batch_build",
            "epoch_order"} <= {e["name"] for e in evs}


def test_cli_report_and_gates(tmp_path, capsys):
    def write(path, events):
        with open(path, "w") as f:
            for ev in events:
                f.write(json.dumps(ev) + "\n")

    good = [_x("epoch", "loop", 0, 100, epoch=0),
            _x("producer_build", "producer", 0, 40, tid=2),
            _x("train_step", "step", 10, 30, step=0),
            _x("epoch_flush", "sync", 45, 5)]
    p = str(tmp_path / "good.jsonl")
    write(p, good)
    out_json = str(tmp_path / "r.json")
    out_chrome = str(tmp_path / "c.json")
    assert obs_cli([p, "--json", out_json, "--chrome", out_chrome,
                    "--require-overlap", "--forbid-mid-epoch-sync"]) == 0
    rep = json.loads(open(out_json).read())
    assert rep["overlap"]["overlap_frac"] > 0
    assert rep["mid_epoch_sync_count"] == 0
    assert "traceEvents" in json.loads(open(out_chrome).read())
    p2 = str(tmp_path / "sync.jsonl")
    write(p2, [_x("train_step", "step", 0, 10)])
    assert obs_cli([p2, "--require-overlap"]) == 1
    assert obs_cli([p2]) == 0
    p3 = str(tmp_path / "mid.jsonl")
    write(p3, SYNTHETIC["mid_epoch"])
    assert obs_cli([p3, "--forbid-mid-epoch-sync"]) == 1
    assert obs_cli([p3]) == 0
    capsys.readouterr()


def test_module_cli_on_a_trainer_trace(tiny_t, tmp_path):
    """`python -m repro_torch.obs` on a trace the trainer wrote: exit 0
    through both gates of a sync run with guard off, and the report."""
    p = str(tmp_path / "sync.jsonl")
    tr = _trainer(tiny_t, guard=None)
    with T.enabled(p) as tracer:
        tr.run_epoch(1e-3)
        tracer.flush()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", p,
         "--forbid-mid-epoch-sync", "--json", str(tmp_path / "r.json")],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "mid-epoch syncs total: 0" in out.stdout
    rep = json.loads((tmp_path / "r.json").read_text())
    assert rep == R_ref.analyze(R_ref.load_trace(p))
    assert np.isclose(rep["overlap"]["overlap_frac"], 0.0)
