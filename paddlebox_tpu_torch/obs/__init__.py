"""Unified telemetry: typed instruments, run events, Prometheus export,
causal pass tracing, the flight recorder, SLO alerts, the quality
monitor and the straggler watchdog (counterpart of
``paddlebox_tpu/obs``; the catalog is ``docs/OBSERVABILITY.md``).

Off by default: with no sink attached the hub is inert, and every hot
call site (each kernel wrapper's launch, each batch) costs one
``hub.active`` attribute read. ``FLAGS_telemetry_jsonl=<path>``,
``FLAGS_telemetry_prom_port=<port>``, ``FLAGS_flightrec_dir=<dir>``,
``FLAGS_quality_window_passes=<n>`` and
``FLAGS_alerts_eval_interval_sec=<s>`` turn the pieces on
(``obs.hub.configure_from_flags``, called at ``Trainer`` init).

Deliberate differences from the reference:

- **Dispatch counts.** ``pbox_kernel_dispatch_total{kernel, impl}``:
  the reference books at jit trace time, once per compiled program; the
  eager port books once per launch (``impl`` ``cuda``) or per call of a
  kernel's plain version on CPU tensors (``impl`` ``plain``), so its
  counts are launch counts and equal the wrappers' ``.launches``. The
  index seam keeps ``device`` / ``host``.
- **trace()** (``utils/profiler``) writes a ``torch.profiler`` chrome
  trace, not an XPlane.
- **The quality monitor's norm sample** is gathered on the table's
  device (``obs/quality.norm_sample``), not copied with the whole table.
- **_process_index** is ``torch.distributed``'s rank when a process
  group is initialized, else 0; the port's single-controller paths
  have none.
"""

from paddlebox_tpu_torch.obs.alerts import AlertEngine, Rule, default_rules
from paddlebox_tpu_torch.obs.flightrec import FlightRecorder
from paddlebox_tpu_torch.obs.hub import (TelemetryHub, configure_from_flags,
                                   emit_pass_event, get_hub, reset_hub)
from paddlebox_tpu_torch.obs.instruments import Counter, Gauge, Histogram
from paddlebox_tpu_torch.obs.quality import QualityMonitor
from paddlebox_tpu_torch.obs.sinks import ChromeSpanSink, JsonlSink, MemorySink
from paddlebox_tpu_torch.obs.trace import (ChromeLaneTraceSink, lane_scope,
                                     set_lane, span, tracing_active)
from paddlebox_tpu_torch.obs.watchdog import (DirHeartbeatStore,
                                        LocalHeartbeatStore,
                                        StragglerReport, StragglerTimeout,
                                        StragglerWatchdog)

__all__ = [
    "TelemetryHub", "get_hub", "reset_hub", "configure_from_flags",
    "emit_pass_event", "Counter", "Gauge", "Histogram",
    "JsonlSink", "MemorySink", "ChromeSpanSink", "ChromeLaneTraceSink",
    "span", "lane_scope", "set_lane", "tracing_active",
    "StragglerWatchdog", "StragglerReport", "StragglerTimeout",
    "LocalHeartbeatStore", "DirHeartbeatStore",
    "FlightRecorder", "QualityMonitor", "AlertEngine", "Rule",
    "default_rules",
]
