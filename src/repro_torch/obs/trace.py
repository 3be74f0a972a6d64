"""Virtual-timeline tracing: Chrome trace-event JSON, Perfetto-loadable.

A copy of ``repro/obs/trace.py`` (numpy only) so the port imports
nothing of ``repro``; ``tests/test_torch_obs.py`` holds it equal to the
original.

The serving engines model time (device profiles, netsim, cloud batcher)
rather than measuring it, so the timeline here is *reconstructed* from the
modeled-latency state a run already computes — per-stream-frame spans for
edge compute, uplink transfers under contention shares, cloud queue wait
and per-GPU batch busy intervals — and written in the Chrome trace-event
format (``{"traceEvents": [{"ph": "X", "ts": ..., "dur": ..., "pid": ...,
"tid": ...}]}``), which https://ui.perfetto.dev loads directly.

Lanes (``pid`` = track, ``tid`` = lane within it):

* ``streams`` — one lane per vehicle stream: anchor / test / transform
  spans at the stream's modeled wall clock;
* ``uplink``  — the shared cell: one upload span per offloading round
  (args carry the contention share) and a downlink lane;
* ``cloud``   — one lane per pool GPU: batch busy intervals (args carry
  batch size and queue wait). Busy spans never overlap within a lane and
  their durations sum to the pool's ``busy_s_g`` accounting;
* ``host``    — *measured* wall-clock spans around dispatch/fetch
  (``Observer.measured_span``), its own clock starting at 0, so modeled
  vs. real time can be compared side by side.

:func:`trace_from_report` also works without an attached observer: the
per-stream lanes are reconstructed exactly from the packed (S, F) arrays
(the engines' wall-clock recurrence is replayed), network/cloud lanes are
simply absent then.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

# Track (pid) numbering, stable so diffs of trace files stay readable.
PID_STREAMS = 1
PID_UPLINK = 2
PID_CLOUD = 3
PID_HOST = 4

_TRACK_NAMES = {
    PID_STREAMS: "streams (modeled)",
    PID_UPLINK: "uplink (modeled)",
    PID_CLOUD: "cloud GPU pool (modeled)",
    PID_HOST: "host (measured)",
}


class Timeline:
    """An append-only collection of complete ('ph: X') trace spans."""

    def __init__(self):
        self.events: List[dict] = []
        self._lanes: Dict[tuple, str] = {}

    def lane(self, pid: int, tid: int, name: str) -> None:
        """Name a lane (emitted as thread_name metadata)."""
        self._lanes[(pid, tid)] = name

    def span(self, pid: int, tid: int, name: str, ts_s: float, dur_s: float,
             args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "X", "pid": pid, "tid": int(tid),
              "ts": round(float(ts_s) * 1e6, 3),
              "dur": round(max(float(dur_s), 0.0) * 1e6, 3)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def to_chrome(self) -> dict:
        meta = []
        for pid, name in _TRACK_NAMES.items():
            if any(e["pid"] == pid for e in self.events):
                meta.append({"name": "process_name", "ph": "M", "pid": pid,
                             "tid": 0, "args": {"name": name}})
        for (pid, tid), name in sorted(self._lanes.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": int(tid), "args": {"name": name}})
        return {"traceEvents": meta + self.events,
                "displayTimeUnit": "ms"}

    def write(self, path) -> dict:
        doc = self.to_chrome()
        if hasattr(path, "write"):
            json.dump(doc, path)
        else:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def _stream_walls(kind: np.ndarray, latency_s: np.ndarray,
                  frame_dt: float) -> np.ndarray:
    """(S, F) modeled wall time at each frame's start — the engines' wall
    recurrence replayed from the packed arrays: a frame advances the wall
    by frame_dt, except anchors which block for max(frame_dt, latency)."""
    s_n, f_n = kind.shape
    walls = np.zeros((s_n, f_n))
    adv = np.where(kind == "anchor",
                   np.maximum(frame_dt, latency_s), frame_dt)
    walls[:, 1:] = np.cumsum(adv, axis=1)[:, :-1]
    return walls


def trace_from_report(report, obs=None) -> Timeline:
    """Build the virtual timeline of a finished run.

    ``report`` is duck-typed (kind/latency_s/onboard_s (S, F) arrays +
    frame_dt). ``obs`` is the run's :class:`repro_torch.obs.observe.Observer`
    when one was attached: its uplink/cloud/audit/measured records add the
    network and GPU-pool lanes and per-span args.
    """
    tl = Timeline()
    kind = np.asarray(report.kind)
    lat = np.asarray(report.latency_s, float)
    onb = np.asarray(report.onboard_s, float)
    frame_dt = float(getattr(report, "frame_dt", 0.1))
    walls = _stream_walls(kind, lat, frame_dt)

    devices = getattr(report, "device", None)
    for s in range(kind.shape[0]):
        dev = str(devices[s]) if devices is not None else ""
        tl.lane(PID_STREAMS, s, f"stream {s}" + (f" [{dev}]" if dev else ""))
        for t in range(kind.shape[1]):
            k = str(kind[s, t])
            dur = lat[s, t] if k in ("anchor", "cloud_only") else onb[s, t]
            args = {"frame": t, "latency_s": float(lat[s, t])}
            if obs is not None and obs.audit.rows:
                row = obs.audit.row(s, t)
                if row is not None:
                    args.update({f: row[f] for f in
                                 ("err_ewma", "bw_mbps", "edge_cost_s",
                                  "offload_cost_s") if f in row})
            tl.span(PID_STREAMS, s, k, walls[s, t], dur, args)

    if obs is None:
        return tl

    tl.lane(PID_UPLINK, 0, "upload")
    tl.lane(PID_UPLINK, 1, "download")
    for rec in obs.uplink_spans:
        tl.span(PID_UPLINK, 0 if rec["dir"] == "up" else 1,
                f"{rec['dir']}x{rec['n']}", rec["t0"], rec["dur"],
                {k: v for k, v in rec.items() if k not in ("t0", "dur")})
    for g in sorted({r["gpu"] for r in obs.gpu_busy}):
        tl.lane(PID_CLOUD, g, f"gpu{g}")
    for rec in obs.gpu_busy:
        tl.span(PID_CLOUD, rec["gpu"], f"batch[{rec['batch']}]",
                rec["start"], rec["end"] - rec["start"],
                {"batch": rec["batch"],
                 "queue_wait_s": rec["queue_wait_s"]})
    tl.lane(PID_HOST, 0, "engine host loop")
    for rec in obs.measured:
        tl.span(PID_HOST, 0, rec["name"], rec["t0"], rec["dur"],
                {k: v for k, v in rec.items()
                 if k not in ("name", "t0", "dur")} or None)
    return tl
