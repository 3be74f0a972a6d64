"""repro_torch.obs — observability for the port's Moby serving path.

Port of ``repro.obs``, with the same names. Three parts, all off by
default and free when off (engines take ``obs=None`` and guard every hook
with one ``if``; no extra device fetches, bitwise-identical outputs —
tests/test_torch_obs.py):

* **Metrics** (:mod:`repro_torch.obs.metrics`, a copy of the JAX
  package's) — counters / gauges / histograms with labels, filled from
  the packed (S, F) arrays a run already fetches, with Prometheus text
  exposition and JSON export.
* **Virtual-timeline tracing** (:mod:`repro_torch.obs.trace`, a copy) —
  per-stream-frame spans, uplink transfers, cloud queue wait and per-GPU
  batch busy intervals reconstructed from the modeled-latency state, as
  Chrome trace-event JSON (``RunReport.to_trace(path)``), plus measured
  host spans (``Observer.measured_span``), which also show in a
  torch.profiler trace as ``moby/<span>``.
* **Scheduler decision audit** (:mod:`repro_torch.obs.audit`, a copy) —
  one JSONL/CSV row per stream-frame of every policy input and the chosen
  treatment.

Enable from the facade::

    from repro_torch import api
    sess = api.Session("fleet-16-congested",
                       obs=api.ObsConfig(metrics=True, trace=True,
                                         audit=True))
    rep = sess.run(16)
    rep.to_trace("fleet.trace.json")      # load in ui.perfetto.dev
    rep.to_prometheus("metrics.prom")
    rep.to_audit("audit.jsonl")
"""
from repro_torch.obs.audit import AUDIT_FIELDS, AuditLog
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, fill_report_metrics,
                                     get_registry)
from repro_torch.obs.observe import (ObsConfig, Observer, export_artifacts,
                                     make_observer)
from repro_torch.obs.trace import Timeline, trace_from_report

__all__ = [
    "AUDIT_FIELDS", "AuditLog",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "fill_report_metrics", "get_registry",
    "ObsConfig", "Observer", "export_artifacts", "make_observer",
    "Timeline", "trace_from_report",
]
