"""`repro_torch.obs`: span tracing, metrics and the trace analyzer
(`repro/obs/__init__.py`). Pure Python; nothing here touches the device.

  obs.trace    structured span tracer -> Chrome-trace/Perfetto JSONL,
               a no-op singleton when disabled, sync-free device step
               timing (`DeviceStepTimer`)
  obs.metrics  `MetricsHub` counter/gauge/histogram registry that the
               trainer's `HitRateMeter` / `ResilienceMeter` /
               `StragglerMonitor` mirror into, with per-epoch snapshots,
               a versioned export schema and the `run_metadata` header
  obs.report   trace analyzer: producer/consumer overlap fraction,
               stall attribution by stage, host-sync placement gate,
               per-epoch rollups — also `python -m repro_torch.obs`
"""
from repro_torch.obs.metrics import (OBS_SCHEMA_VERSION, Counter, Gauge,
                                     Histogram, MetricsHub, run_metadata)
from repro_torch.obs.trace import (TRACE_SCHEMA_VERSION, DeviceStepTimer,
                                   Tracer, current, enabled, install,
                                   instant, span, uninstall)
from repro_torch.obs.report import analyze, load_trace, to_chrome

__all__ = [
    "OBS_SCHEMA_VERSION", "TRACE_SCHEMA_VERSION",
    "Counter", "Gauge", "Histogram", "MetricsHub", "run_metadata",
    "DeviceStepTimer", "Tracer", "current", "enabled", "install",
    "instant", "span", "uninstall",
    "analyze", "load_trace", "to_chrome",
]
