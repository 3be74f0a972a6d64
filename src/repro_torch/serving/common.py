"""Shared serving-layer pieces: wire sizes, the on-board latency model,
modeled per-frame cost estimates (scheduler telemetry), and the canonical
:class:`RunReport` — used by the single-stream ``MobyEngine``, the
batched multi-stream ``FleetEngine`` (repro_torch.fleet) and the
``repro_torch.api`` facade.

A copy of ``repro/serving/common.py`` (plain numpy, no tensors) so the port
imports nothing of ``repro``; its observability views read
``repro_torch.obs``. The CSV and summary exports are byte-for-byte those of
the original.

``ComponentTimes`` itself lives in :mod:`repro_torch.runtime.profiles`
(the single modeled-latency source, derived per device profile); it is
re-exported here for the serving-layer consumers.
"""
from __future__ import annotations

import csv
import dataclasses
import io
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.runtime import profiles
from repro_torch.runtime.profiles import ComponentTimes  # noqa: F401 (re-export)

# Wire size of one LiDAR frame: the paper measures 6.96 Mbit/file average
# (KITTI scans cropped to the camera FOV).
PC_BYTES = int(6.96e6 / 8)
RESULT_BYTES = 64 * 7 * 4  # detections back to the edge


def onboard_transform_time(comp: ComponentTimes, n_assoc: float, n_new: float,
                           use_tba: bool, use_fos: bool) -> float:
    """On-board time of one transform frame (Fig. 15 component model).

    Box estimation cost is a mix of the associated (single-hypothesis) and
    new-object (two-hypothesis) paths, weighted by this frame's detections.
    """
    t = comp.seg_2d + comp.point_proj + comp.filtration
    total = max(n_assoc + n_new, 1)
    frac_new = n_new / total
    t += frac_new * comp.bbox_est_new + (1 - frac_new) * comp.bbox_est_assoc
    if use_tba:
        t += comp.tba
    if use_fos:
        t += comp.fos
    return t


def nominal_transform_time(comp: ComponentTimes, use_tba: bool,
                           use_fos: bool) -> float:
    """Modeled cost of a *typical* transform frame (all detections carry a
    track prior) — the per-frame edge-cost estimate the adaptive scheduler
    compares against the offload cost."""
    return onboard_transform_time(comp, n_assoc=1, n_new=0,
                                  use_tba=use_tba, use_fos=use_fos)


def modeled_frame_costs(comp: ComponentTimes, detector: str,
                        bw_mbps: float, rtt_s: float, use_tba: bool,
                        charge_fos: bool, *, onboard_anchors: bool = False,
                        edge_device="jetson_tx2",
                        cloud_device="rtx_2080ti") -> Tuple[float, float]:
    """(edge_cost_s, offload_cost_s) for one frame from the active device
    profiles and the currently observed uplink bandwidth — the modeled
    costs engines feed into ``scheduler.observe_telemetry`` each frame.

    Heterogeneous fleets pass a stacked per-stream ``comp`` and a
    ``profiles.ProfileVector`` as ``edge_device``: both costs then come
    back as (S,) arrays, so each stream's scheduler budget reflects its
    own device.

    The offload cost is the anchor round-trip estimate: frame upload +
    result download at the observed fair-share bandwidth (plus per-leg
    RTT) and cloud inference on the cloud profile; with
    ``onboard_anchors`` (the ``moby_onboard`` mode) it is edge inference
    on the edge profile instead.
    """
    edge = nominal_transform_time(comp, use_tba, charge_fos)
    if onboard_anchors:
        return edge, profiles.detector_latency(detector, edge_device)
    bw = max(float(bw_mbps), 1e-3)
    wire_s = (PC_BYTES + RESULT_BYTES) * 8 / 1e6 / bw
    offload = 2 * rtt_s + wire_s + \
        profiles.detector_latency(detector, cloud_device)
    return edge, offload


# ---------------------------------------------------------------------------
# Canonical run outcome
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FrameRecord:
    """One stream-frame outcome (the seed engine's record format, kept as
    the row view of :class:`RunReport`)."""
    frame: int
    kind: str                  # anchor | test | transform | edge/cloud_only
    latency_s: float
    onboard_s: float
    f1: float
    precision: float
    recall: float


_CSV_FIELDS = ("stream", "frame", "kind", "latency_s", "onboard_s", "f1",
               "precision", "recall", "scenario", "policy", "device")


@dataclasses.dataclass
class RunReport:
    """Canonical outcome of a serving run: per-stream-per-frame packed
    arrays, shape (S, F) throughout (S=1 for the single-stream engine).

    Unifies the seed's ``RunResult`` (list of FrameRecords) and the fleet
    subsystem's ``FleetRunResult`` (packed arrays): one class carries the
    aggregate properties every benchmark reads, the per-stream record view
    the tests read, and CSV/dict export for the benchmark harness.
    """
    kind: np.ndarray        # (S, F) unicode: frame treatment per frame
    latency_s: np.ndarray   # (S, F) end-to-end latency
    onboard_s: np.ndarray   # (S, F) on-device transformation time
    f1: np.ndarray          # (S, F)
    precision: np.ndarray   # (S, F)
    recall: np.ndarray      # (S, F)
    scenario: str = ""      # provenance (repro_torch.api fills these in)
    policy: str = ""
    # Per-stream edge device-profile names, shape (S,) (None when the run
    # predates device stamping — exported as an empty CSV column then).
    device: Optional[np.ndarray] = None
    # Scene frame period — lets the virtual timeline replay the engines'
    # wall-clock recurrence exactly from the packed arrays.
    frame_dt: float = 0.1
    # The run's repro_torch.obs.Observer when observability was enabled
    # (None otherwise; never exported to CSV).
    obs: Optional[object] = None

    # -- construction ---------------------------------------------------
    @classmethod
    def from_records(cls, records: Sequence[FrameRecord], *,
                     scenario: str = "", policy: str = "",
                     device: str = "") -> "RunReport":
        """Build a single-stream (1, F) report from FrameRecords."""
        def col(name, dtype=np.float32):
            return np.asarray([getattr(r, name) for r in records],
                              dtype=dtype)[None, :]
        return cls(kind=col("kind", dtype="<U12"),
                   latency_s=col("latency_s"), onboard_s=col("onboard_s"),
                   f1=col("f1"), precision=col("precision"),
                   recall=col("recall"), scenario=scenario, policy=policy,
                   device=np.asarray([device]) if device else None)

    # -- shape ----------------------------------------------------------
    @property
    def n_streams(self) -> int:
        return self.f1.shape[0]

    @property
    def n_frames(self) -> int:
        return self.f1.shape[1]

    # -- derived masks --------------------------------------------------
    @property
    def is_anchor(self) -> np.ndarray:
        return self.kind == "anchor"

    @property
    def send_test(self) -> np.ndarray:
        return self.kind == "test"

    # -- aggregates (the properties every benchmark/test reads) ---------
    @property
    def mean_latency(self) -> float:
        return float(np.mean(self.latency_s))

    @property
    def mean_onboard(self) -> float:
        return float(np.mean(self.onboard_s))

    @property
    def mean_f1(self) -> float:
        return float(np.mean(self.f1))

    @property
    def mean_anchor_latency(self) -> float:
        a = self.latency_s[self.is_anchor]
        return float(np.mean(a)) if a.size else 0.0

    @property
    def anchor_rate(self) -> float:
        return float(np.mean(self.is_anchor))

    @property
    def offload_rate(self) -> float:
        """Fraction of frames that sent anything to the cloud (anchor
        round-trips *and* test-frame uploads) — the x-axis of the
        accuracy/offload frontier the policy sweep plots."""
        return float(np.mean(self.is_anchor | self.send_test))

    # -- per-stream aggregates (heterogeneous fleets) --------------------
    def stream_device(self, s: int) -> str:
        """Stream ``s``'s edge device-profile name ("" when unstamped)."""
        return str(self.device[s]) if self.device is not None else ""

    def stream_p95_latency(self) -> np.ndarray:
        """(S,) p95 of modeled end-to-end latency per stream — the
        per-stream tail the heterogeneity sweeps compare across device
        classes."""
        return np.percentile(self.latency_s, 95, axis=1)

    def device_p95_latency(self) -> Dict[str, float]:
        """p95 modeled latency per device class: each stream's p95
        averaged over the streams assigned that device (requires a
        device-stamped report)."""
        if self.device is None:
            raise ValueError("report has no per-stream device names")
        p95 = self.stream_p95_latency()
        return {str(d): float(np.mean(p95[self.device == d]))
                for d in sorted(set(str(x) for x in self.device))}

    # -- per-stream record views ----------------------------------------
    def kinds(self, s: int = 0) -> List[str]:
        return [str(k) for k in self.kind[s]]

    def stream_records(self, s: int) -> List[FrameRecord]:
        """One stream's run as seed-engine-style FrameRecords."""
        return [FrameRecord(t, str(self.kind[s, t]),
                            float(self.latency_s[s, t]),
                            float(self.onboard_s[s, t]),
                            float(self.f1[s, t]),
                            float(self.precision[s, t]),
                            float(self.recall[s, t]))
                for t in range(self.n_frames)]

    @property
    def records(self) -> List[FrameRecord]:
        """Single-stream record view (the seed ``RunResult.records``)."""
        if self.n_streams != 1:
            raise ValueError(
                f"report holds {self.n_streams} streams; use "
                f"stream_records(s) to pick one")
        return self.stream_records(0)

    # -- export ----------------------------------------------------------
    def summary(self) -> Dict[str, Union[str, float, int]]:
        """Aggregates as a flat dict (benchmark/emit friendly)."""
        return {
            "scenario": self.scenario, "policy": self.policy,
            "n_streams": self.n_streams, "n_frames": self.n_frames,
            "mean_latency_s": self.mean_latency,
            "mean_onboard_s": self.mean_onboard,
            "mean_f1": self.mean_f1,
            "mean_anchor_latency_s": self.mean_anchor_latency,
            "p95_latency_s": float(np.percentile(self.latency_s, 95)),
            "anchor_rate": self.anchor_rate,
            "offload_rate": self.offload_rate,
        }

    def to_rows(self) -> Iterable[Dict[str, Union[str, float, int]]]:
        for s in range(self.n_streams):
            for t in range(self.n_frames):
                yield {"stream": s, "frame": t, "kind": str(self.kind[s, t]),
                       "latency_s": float(self.latency_s[s, t]),
                       "onboard_s": float(self.onboard_s[s, t]),
                       "f1": float(self.f1[s, t]),
                       "precision": float(self.precision[s, t]),
                       "recall": float(self.recall[s, t]),
                       "scenario": self.scenario, "policy": self.policy,
                       "device": self.stream_device(s)}

    def to_csv(self, file=None, header: bool = True) -> str:
        """Write per-frame rows (with scenario/policy provenance columns)
        as CSV to ``file`` (path or file object); returns the CSV text.
        ``header=False`` lets the sweep harness concatenate many reports
        into one CSV."""
        buf = io.StringIO()
        w = csv.DictWriter(buf, fieldnames=_CSV_FIELDS)
        if header:
            w.writeheader()
        for row in self.to_rows():
            w.writerow(row)
        text = buf.getvalue()
        if file is not None:
            if hasattr(file, "write"):
                file.write(text)
            else:
                with open(file, "w") as f:
                    f.write(text)
        return text

    # -- observability views (repro_torch.obs) ---------------------------
    def to_trace(self, path=None) -> dict:
        """The run's virtual timeline as a Chrome trace-event document
        (Perfetto-loadable), written to ``path`` when given. With an
        attached observer (ObsConfig(trace=True)) the trace carries
        uplink, per-GPU cloud and measured host lanes; without one, the
        per-stream lanes are reconstructed from the packed arrays."""
        from repro_torch.obs import trace as trace_lib
        tl = trace_lib.trace_from_report(self, obs=self.obs)
        return tl.write(path) if path is not None else tl.to_chrome()

    def metrics_registry(self):
        """The metrics registry this run reported into — or, for an
        unobserved run, a fresh registry filled from the packed arrays
        (same numbers, nothing run-external like GPU-pool accounting)."""
        from repro_torch import obs as obs_lib
        if self.obs is not None and self.obs.cfg.want_metrics:
            self.obs.flush_metrics(self)   # idempotent
            return self.obs.registry
        reg = obs_lib.MetricsRegistry()
        obs_lib.fill_report_metrics(reg, self)
        return reg

    def to_prometheus(self, file=None) -> str:
        """Prometheus text exposition of this run's metrics."""
        return self.metrics_registry().to_prometheus(file)

    def to_audit(self, file=None, fmt: Optional[str] = None) -> str:
        """The scheduler decision audit (one row per stream-frame) as
        JSONL, or CSV when ``fmt="csv"`` / the path ends in .csv.
        Requires the run to have been observed with audit on."""
        if self.obs is None or not len(self.obs.audit):
            raise ValueError(
                "no audit log attached to this report; run through an "
                "engine/Session with obs=ObsConfig(audit=True)")
        if fmt is None:
            fmt = "csv" if str(file).endswith(".csv") else "jsonl"
        return self.obs.audit.to_csv(file) if fmt == "csv" \
            else self.obs.audit.to_jsonl(file)
