"""ObsConfig + Observer: what the engines talk to.

Port of ``repro/obs/observe.py``, with the same names and behaviour.
``ObsConfig`` is the user-facing switch (off by default: a ``None`` /
all-off config makes every engine hook a single ``if obs is None`` test,
so disabled runs are bitwise identical with no extra fetches).
``Observer`` is one run's collection state: the engines push host-side
values they *already computed* (wall clocks, transfer times, batcher
intervals, scheduler telemetry) and the observer assembles the
metrics/trace/audit views after the run.

Measured (real wall-clock) spans: :meth:`Observer.measured_span` wraps a
host-side region in ``time.perf_counter`` plus
``torch.profiler.record_function("moby/<name>")``, so the span also shows
in a torch.profiler trace. Nothing in a span synchronises: a dispatch span
measures the host's enqueue, and the fetch span after it absorbs the wait
on the device. The port has no jit; what compiles in it is the ``nvcc``
build of the kernel library (``kernels._build.builds``) and the CUDA graph
capture of the fleet's scan (``fleet.step.FleetScan.captures``). A span
handed a callable returning their sum is marked ``compiled`` when the sum
grew inside it, and feeds the same retrace and compile-time metric
families as the JAX package's jit caches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs.audit import AuditLog
from repro_torch.obs.metrics import (MetricsRegistry, fill_autotune_metrics,
                                     fill_report_metrics, get_registry)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """What to observe; everything defaults off. Setting an export path
    implies the corresponding collector (``trace_path=...`` turns tracing
    on). Paths may contain ``{n}`` / ``{scenario}`` / ``{policy}``
    placeholders, expanded per run by ``api.Session``."""
    metrics: bool = False
    trace: bool = False
    audit: bool = False
    metrics_path: Optional[str] = None
    trace_path: Optional[str] = None
    audit_path: Optional[str] = None
    # Metrics sink; None = the process-default registry (obs.get_registry),
    # so successive runs of a sweep accumulate into one exposition.
    registry: Optional[MetricsRegistry] = None

    @property
    def want_metrics(self) -> bool:
        return self.metrics or self.metrics_path is not None

    @property
    def want_trace(self) -> bool:
        return self.trace or self.trace_path is not None

    @property
    def want_audit(self) -> bool:
        return self.audit or self.audit_path is not None

    @property
    def enabled(self) -> bool:
        return self.want_metrics or self.want_trace or self.want_audit


def make_observer(cfg: Optional[ObsConfig], **run_info
                  ) -> Optional["Observer"]:
    """The engines' entry point: None (or an all-off config) -> None, so
    the disabled path stays one pointer test per hook."""
    if cfg is None or not cfg.enabled:
        return None
    return Observer(cfg, **run_info)


class Observer:
    """Collection state for ONE run (engines build a fresh one per run)."""

    def __init__(self, cfg: ObsConfig, *, n_streams: int = 1,
                 devices=(), policy: str = "", detector: str = "",
                 frame_dt: float = 0.1, n_shards: int = 1):
        self.cfg = cfg
        self.n_streams = n_streams
        # Stream-axis mesh shards; the port has no mesh yet, so 1.
        self.n_shards = n_shards
        self.devices = list(devices) or [""] * n_streams
        self.policy = policy
        self.detector = detector
        self.frame_dt = frame_dt
        self.registry = cfg.registry if cfg.registry is not None \
            else get_registry()
        # virtual-timeline records (modeled clocks)
        self.uplink_spans: List[Dict] = []
        self.gpu_busy: List[Dict] = []
        # measured host spans (real wall clock, zeroed at first span)
        self.measured: List[Dict] = []
        self._host_t0: Optional[float] = None
        self.retraces: Dict[str, int] = {}
        self.compile_s: Dict[str, float] = {}
        # audit
        self.audit = AuditLog()
        self._metrics_flushed = False
        self._telemetry = None          # latest (bw, edge, off) this frame
        # byte accounting (metrics)
        self.bytes_up = 0
        self.bytes_down = 0

    # -- virtual timeline -------------------------------------------------
    def record_uplink(self, direction: str, t0: float, dur: float,
                      n_sharers: int, n_bytes: int,
                      bw_share_mbps: float) -> None:
        """One shared-cell transfer round (modeled clock): all ``n``
        concurrent senders split the trace bandwidth."""
        self.uplink_spans.append(
            {"dir": direction, "t0": float(t0), "dur": float(dur),
             "n": int(n_sharers), "bytes": int(n_bytes) * int(n_sharers),
             "bw_share_mbps": round(float(bw_share_mbps), 3)})
        if direction == "up":
            self.bytes_up += int(n_bytes) * int(n_sharers)
        else:
            self.bytes_down += int(n_bytes) * int(n_sharers)

    def on_cloud_batch(self, gpu: int, start: float, finish: float,
                       batch_size: int, last_arrive: float) -> None:
        """CloudBatcher sink: one dispatched batch's busy interval on its
        GPU lane (start >= the lane's previous finish by construction, so
        lanes never overlap; queue wait = start - last request arrival)."""
        self.gpu_busy.append(
            {"gpu": int(gpu), "start": float(start), "end": float(finish),
             "batch": int(batch_size),
             "queue_wait_s": float(max(start - last_arrive, 0.0))})

    # -- measured host spans ----------------------------------------------
    @contextlib.contextmanager
    def measured_span(self, name: str,
                      compile_count: Optional[Callable[[], int]] = None,
                      **args):
        """Real wall-clock span around a host region (dispatch / fetch),
        also a ``torch.profiler`` range ``moby/<name>``. ``compile_count``:
        a callable returning the builds and graph captures so far; its
        growth inside the span marks the span as a compile and feeds the
        per-step retrace counters."""
        before = None if compile_count is None else int(compile_count())
        t0 = time.perf_counter()
        if self._host_t0 is None:
            self._host_t0 = t0
        with torch.profiler.record_function(f"moby/{name}"):
            yield
        dur = time.perf_counter() - t0
        rec = {"name": name, "t0": t0 - self._host_t0, "dur": dur, **args}
        after = None if compile_count is None else int(compile_count())
        if after is not None and after > before:
            rec["compiled"] = True
            self.retraces[name] = self.retraces.get(name, 0) \
                + (after - before)
            self.compile_s[name] = self.compile_s.get(name, 0.0) + dur
        self.measured.append(rec)

    # -- scheduler audit --------------------------------------------------
    def note_telemetry(self, bw_mbps, edge_cost_s, offload_cost_s) -> None:
        """Stash the host-computed telemetry the engine is about to fold
        into the SchedulerState (same values, no re-computation)."""
        self._telemetry = (np.asarray(bw_mbps, float),
                           np.asarray(edge_cost_s, float),
                           np.asarray(offload_cost_s, float))

    def audit_frame(self, frame: int, kinds, err_ewma, frames_since_anchor,
                    streams=None) -> None:
        """One decision row per stream for this frame. ``kinds`` is the
        per-stream treatment, ``err_ewma`` / ``frames_since_anchor`` the
        decision-time telemetry (scalars or (S,) arrays)."""
        s_idx = range(self.n_streams) if streams is None else streams
        ew = np.broadcast_to(np.asarray(err_ewma, float), (self.n_streams,))
        fa = np.broadcast_to(np.asarray(frames_since_anchor, float),
                             (self.n_streams,))
        if self._telemetry is None:
            bw = edge = off = np.zeros(self.n_streams)
        else:
            bw, edge, off = (np.broadcast_to(a, (self.n_streams,))
                             for a in self._telemetry)
        kinds = np.broadcast_to(np.asarray(kinds), (self.n_streams,))
        for s in s_idx:
            self.audit.record(
                stream=s, frame=frame, policy=self.policy,
                device=self.devices[s], kind=str(kinds[s]),
                err_ewma=float(ew[s]), frames_since_anchor=int(fa[s]),
                bw_mbps=float(bw[s]), edge_cost_s=float(edge[s]),
                offload_cost_s=float(off[s]))

    # -- finalize ---------------------------------------------------------
    def finalize(self, report, busy_s_g=None) -> None:
        """Called by the engine with the finished report: attach this
        observer. The registry fill is deferred to :meth:`flush_metrics`
        (first metrics access / Session export) so provenance labels
        stamped *after* the engine returns — scenario, policy — make it
        into the samples."""
        self.busy_s_g = [float(b) for b in (busy_s_g or [])]
        self._metrics_flushed = False
        report.obs = self

    def flush_metrics(self, report) -> None:
        """Fill the registry from the packed arrays + the run's
        pool/uplink/compile accounting — once per run (idempotent)."""
        if not self.cfg.want_metrics or self._metrics_flushed:
            return
        self._metrics_flushed = True
        reg = self.registry
        fill_report_metrics(reg, report)
        if self.busy_s_g:
            g = reg.gauge("moby_cloud_gpu_busy_seconds",
                          "accumulated service time per pool GPU",
                          labels=("scenario", "policy", "gpu"))
            for i, b in enumerate(self.busy_s_g):
                g.set(b, scenario=report.scenario, policy=report.policy,
                      gpu=i)
        if self.n_shards > 1 and self.n_streams % self.n_shards == 0:
            # Sharded fleet: per-shard latency tails + stream counts. The
            # stream axis shards contiguously, so shard k holds streams
            # [k*S/D, (k+1)*S/D).
            lat = np.asarray(report.latency_s).reshape(
                self.n_shards, self.n_streams // self.n_shards, -1)
            p95 = reg.gauge("moby_shard_p95_latency_seconds",
                            "p95 modeled frame latency per mesh shard",
                            labels=("scenario", "policy", "shard"))
            ns = reg.gauge("moby_shard_streams",
                           "streams resident on each mesh shard",
                           labels=("scenario", "policy", "shard"))
            for k in range(self.n_shards):
                p95.set(float(np.percentile(lat[k], 95)),
                        scenario=report.scenario, policy=report.policy,
                        shard=k)
                ns.set(lat.shape[1], scenario=report.scenario,
                       policy=report.policy, shard=k)
        if self.bytes_up or self.bytes_down:
            c = reg.counter("moby_uplink_bytes_total",
                            "modeled bytes over the shared cell",
                            labels=("direction",))
            c.inc(self.bytes_up, direction="up")
            c.inc(self.bytes_down, direction="down")
        if self.retraces:
            # The JAX package's family names, so an exposition reads the
            # same in both packages: here a kernel build or graph capture.
            rt = reg.counter("moby_jit_retraces_total",
                             "jitted-step compilations observed mid-run",
                             labels=("step",))
            ct = reg.gauge("moby_jit_compile_wall_seconds",
                           "wall time of dispatches that compiled",
                           labels=("step",))
            for name, n in self.retraces.items():
                rt.inc(n, step=name)
                ct.set(self.compile_s[name], step=name)
        if self.measured:
            h = reg.histogram("moby_host_span_seconds",
                              "measured wall time of host regions",
                              labels=("span",),
                              buckets=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
                                       0.1, 0.3, 1.0, 3.0))
            for rec in self.measured:
                h.observe(rec["dur"], span=rec["name"])
        # The port has no autotune table yet (ROADMAP item 10).
        fill_autotune_metrics(reg, None, None)


# Per-process run counter for {n} placeholders in export paths.
_RUN_COUNTER = 0


def next_run_index() -> int:
    global _RUN_COUNTER
    _RUN_COUNTER += 1
    return _RUN_COUNTER - 1


def export_artifacts(report, cfg: Optional[ObsConfig]) -> Dict[str, str]:
    """Write every export path the config asks for (trace JSON, Prometheus
    exposition, audit JSONL/CSV) for one finished run; returns
    {kind: path}. Paths may contain ``{n}`` (per-process run counter),
    ``{scenario}`` and ``{policy}`` placeholders. Parent directories are
    created. Used by ``api.Session``."""
    import os

    if cfg is None or not cfg.enabled:
        return {}
    n = next_run_index()

    def expand(path):
        out = path.format(n=n, scenario=report.scenario or "run",
                          policy=report.policy or "none")
        parent = os.path.dirname(out)
        if parent:
            os.makedirs(parent, exist_ok=True)
        return out

    written = {}
    if cfg.trace_path is not None:
        p = expand(cfg.trace_path)
        report.to_trace(p)
        written["trace"] = p
    if cfg.metrics_path is not None:
        p = expand(cfg.metrics_path)
        report.to_prometheus(p)
        written["metrics"] = p
    if cfg.audit_path is not None:
        p = expand(cfg.audit_path)
        report.to_audit(p)
        written["audit"] = p
    return written
