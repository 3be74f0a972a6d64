"""Lightweight metrics registry: counters, gauges, histograms with labels.

A copy of ``repro/obs/metrics.py`` (numpy only) so the port imports
nothing of ``repro``; ``tests/test_torch_obs.py`` holds it equal to the
original.

A deliberately small, dependency-free subset of the Prometheus client
model, tuned for the serving path's needs:

* metrics are created once on a :class:`MetricsRegistry` (get-or-create,
  type/label-schema checked) and carry labeled samples keyed by the tuple
  of label *values*;
* :meth:`MetricsRegistry.to_prometheus` renders the text exposition
  format (``# HELP`` / ``# TYPE`` headers, ``{label="v"}`` samples,
  cumulative ``_bucket``/``_sum``/``_count`` histogram series);
* :meth:`MetricsRegistry.to_json` exports the same data as one JSON
  document for programmatic consumers.

:func:`fill_report_metrics` populates a registry from a ``RunReport``'s
packed (S, F) arrays after a run — zero overhead during the run, no extra
device round-trips (the report *is* the one fetch the engines already do).
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

# Default histogram buckets (seconds): spans modeled frame latencies from
# sub-ms transform frames to multi-second congested anchors.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

_LabelKey = Tuple[str, ...]


def _fmt(v: float) -> str:
    """Prometheus sample value: shortest float repr, inf/nan spelled out."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(names: Sequence[str], values: _LabelKey) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape(str(v))}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class Metric:
    """Base: a named family of labeled samples."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._samples: Dict[_LabelKey, float] = {}

    def _key(self, labelkw: Dict[str, object]) -> _LabelKey:
        if set(labelkw) != set(self.labels):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labels}, "
                f"got {sorted(labelkw)}")
        return tuple(str(labelkw[n]) for n in self.labels)

    def value(self, **labelkw) -> float:
        return self._samples[self._key(labelkw)]

    def samples(self) -> Iterable[Tuple[_LabelKey, float]]:
        return sorted(self._samples.items())

    def expose(self) -> List[str]:
        return [f"{self.name}{_label_str(self.labels, k)} {_fmt(v)}"
                for k, v in self.samples()]

    def to_dict(self) -> dict:
        return {"name": self.name, "type": self.kind, "help": self.help,
                "labels": list(self.labels),
                "samples": [{"labels": dict(zip(self.labels, k)),
                             "value": v} for k, v in self.samples()]}


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labelkw) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        k = self._key(labelkw)
        self._samples[k] = self._samples.get(k, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labelkw) -> None:
        self._samples[self._key(labelkw)] = float(value)


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics): ``le`` buckets
    count observations <= the bound, ``+Inf`` equals ``_count``."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per label key: (per-bucket counts, +Inf count, sum)
        self._hist: Dict[_LabelKey, Tuple[List[int], int, float]] = {}

    def observe(self, value: float, **labelkw) -> None:
        k = self._key(labelkw)
        counts, n, total = self._hist.get(
            k, ([0] * len(self.buckets), 0, 0.0))
        for i, b in enumerate(self.buckets):
            if value <= b:
                counts[i] += 1
        self._hist[k] = (counts, n + 1, total + float(value))

    def observe_many(self, values, **labelkw) -> None:
        for v in np.asarray(values, float).reshape(-1):
            self.observe(float(v), **labelkw)

    def count(self, **labelkw) -> int:
        return self._hist[self._key(labelkw)][1]

    def sum(self, **labelkw) -> float:
        return self._hist[self._key(labelkw)][2]

    def samples(self):
        # flat view for to_dict: _count and _sum per key
        return sorted((k, float(n)) for k, (_, n, _) in self._hist.items())

    def expose(self) -> List[str]:
        lines = []
        for k in sorted(self._hist):
            counts, n, total = self._hist[k]
            lab = list(zip(self.labels, k))
            for b, c in zip(self.buckets, counts):
                ls = _label_str([x for x, _ in lab] + ["le"],
                                tuple([x for _, x in lab] + [_fmt(b)]))
                lines.append(f"{self.name}_bucket{ls} {c}")
            ls = _label_str([x for x, _ in lab] + ["le"],
                            tuple([x for _, x in lab] + ["+Inf"]))
            lines.append(f"{self.name}_bucket{ls} {n}")
            base = _label_str(self.labels, k)
            lines.append(f"{self.name}_sum{base} {_fmt(total)}")
            lines.append(f"{self.name}_count{base} {n}")
        return lines

    def to_dict(self) -> dict:
        return {"name": self.name, "type": self.kind, "help": self.help,
                "labels": list(self.labels),
                "buckets": list(self.buckets),
                "samples": [{"labels": dict(zip(self.labels, k)),
                             "bucket_counts": list(counts),
                             "count": n, "sum": total}
                            for k, (counts, n, total)
                            in sorted(self._hist.items())]}


class MetricsRegistry:
    """Named metric families with get-or-create registration."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name, help, labels, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help=help, labels=labels, **kw)
            self._metrics[name] = m
            return m
        if not isinstance(m, cls) or m.labels != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.labels}; asked for {cls.kind} {tuple(labels)}")
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str) -> Metric:
        return self._metrics[name]

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def clear(self) -> None:
        self._metrics.clear()

    # -- export ----------------------------------------------------------
    def to_prometheus(self, file=None) -> str:
        """The Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for name in self.names():
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {_escape(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.expose())
        text = "\n".join(lines) + ("\n" if lines else "")
        _write(text, file)
        return text

    def to_json(self, file=None) -> str:
        text = json.dumps(
            {"metrics": [self._metrics[n].to_dict() for n in self.names()]},
            indent=1, sort_keys=True)
        _write(text, file)
        return text


def _write(text: str, file) -> None:
    if file is None:
        return
    if hasattr(file, "write"):
        file.write(text)
    else:
        with open(file, "w") as f:
            f.write(text)


# Process-default registry: successive runs accumulate (counters) or
# refresh (gauges) here, so one exposition covers a whole sweep.
_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT


# ---------------------------------------------------------------------------
# RunReport -> metrics (the zero-overhead fill: everything below reads the
# packed (S, F) arrays the run already fetched)
# ---------------------------------------------------------------------------


def fill_report_metrics(reg: MetricsRegistry, report) -> None:
    """Populate serving metrics from a finished ``RunReport`` (duck-typed
    to avoid an obs -> serving import cycle)."""
    scn, pol = report.scenario, report.policy
    devices = report.device if report.device is not None \
        else np.asarray([""] * report.n_streams)

    frames = reg.counter("moby_frames_total",
                         "stream-frames served, by treatment",
                         labels=("scenario", "policy", "device", "kind"))
    lat = reg.histogram("moby_frame_latency_seconds",
                        "modeled end-to-end frame latency",
                        labels=("scenario", "policy", "device", "kind"))
    onb = reg.histogram("moby_onboard_seconds",
                        "modeled on-device transformation time",
                        labels=("scenario", "policy", "device"))
    for dev in sorted(set(str(d) for d in devices)):
        sel = devices == dev
        for kind in sorted(set(report.kind[sel].reshape(-1))):
            m = report.kind[sel] == kind
            frames.inc(int(m.sum()), scenario=scn, policy=pol,
                       device=dev, kind=kind)
            lat.observe_many(report.latency_s[sel][m], scenario=scn,
                             policy=pol, device=dev, kind=kind)
        onb.observe_many(report.onboard_s[sel], scenario=scn, policy=pol,
                         device=dev)

    g95 = reg.gauge("moby_device_p95_latency_seconds",
                    "p95 modeled latency per edge device class "
                    "(RunReport.device_p95_latency)",
                    labels=("scenario", "policy", "device"))
    if report.device is not None:
        for dev, p95 in report.device_p95_latency().items():
            g95.set(p95, scenario=scn, policy=pol, device=dev)
    else:
        g95.set(float(np.percentile(report.latency_s, 95)),
                scenario=scn, policy=pol, device="")
    s95 = reg.gauge("moby_stream_p95_latency_seconds",
                    "p95 modeled latency per stream",
                    labels=("scenario", "policy", "stream"))
    for s, v in enumerate(report.stream_p95_latency()):
        s95.set(float(v), scenario=scn, policy=pol, stream=s)

    for name, val, help in (
            ("moby_run_mean_f1", report.mean_f1, "mean 3D-IoU F1"),
            ("moby_run_anchor_rate", report.anchor_rate,
             "fraction of frames anchored"),
            ("moby_run_offload_rate", report.offload_rate,
             "fraction of frames touching the cloud")):
        reg.gauge(name, help, labels=("scenario", "policy")).set(
            val, scenario=scn, policy=pol)


def fill_autotune_metrics(reg: MetricsRegistry,
                          table: Optional[Dict[str, Dict[str, float]]],
                          selected: Optional[Dict[str, str]] = None) -> None:
    """Export the ops/autotune micro-benchmark table: measured per-op
    per-backend seconds plus the argmin backend ``"auto"`` resolves to.
    No-op when no table has been measured/pinned yet (the exporter never
    *triggers* the startup micro-benchmark)."""
    if not table:
        return
    t = reg.gauge("moby_autotune_op_seconds",
                  "measured best-of-k wall time per hot op per backend",
                  labels=("op", "backend"))
    sel = reg.gauge("moby_autotune_selected",
                    "1 for the backend 'auto' resolves this op to",
                    labels=("op", "backend"))
    for op, row in table.items():
        for be, secs in row.items():
            t.set(secs, op=op, backend=be)
        if selected and op in selected:
            for be in row:
                sel.set(1.0 if be == selected[op] else 0.0,
                        op=op, backend=be)
