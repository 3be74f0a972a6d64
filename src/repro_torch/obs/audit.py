"""Scheduler decision audit: one row per stream-frame.

A copy of ``repro/obs/audit.py`` (plain Python) so the port imports
nothing of ``repro``; ``tests/test_torch_obs.py`` holds it equal to the
original.

Every policy input the telemetry ``SchedulerState`` carries at decision
time (``err_ewma``, ``frames_since_anchor``, observed uplink bandwidth,
modeled edge/offload frame costs) plus the chosen treatment, recorded by
the engines when ``ObsConfig.audit`` is on and exportable as JSONL or
CSV. This is exactly the dataset the ROADMAP's adaptive-calibration
carry-over needs: fitting the ``adaptive`` policy's drift/budget constants
per scenario (and per device class) is a regression over these rows.

Row schema (:data:`AUDIT_FIELDS`):

====================  =====================================================
stream, frame         stream index / frame index (rows cover all S x F)
policy                the scheduler policy the run used
device                the stream's edge device-profile name
kind                  chosen treatment: anchor | test | transform | <mode>
err_ewma              EWMA of observed test error at decision time
frames_since_anchor   frames since this stream last anchored
bw_mbps               observed fair-share uplink bandwidth
edge_cost_s           modeled on-device frame cost
offload_cost_s        modeled anchor round-trip cost
====================  =====================================================
"""
from __future__ import annotations

import csv
import io
import json
from typing import Dict, List, Optional

AUDIT_FIELDS = ("stream", "frame", "policy", "device", "kind", "err_ewma",
                "frames_since_anchor", "bw_mbps", "edge_cost_s",
                "offload_cost_s")


class AuditLog:
    """Append-only per-stream-frame decision records."""

    def __init__(self):
        self.rows: List[Dict] = []
        self._index: Dict[tuple, int] = {}

    def record(self, *, stream: int, frame: int, policy: str, device: str,
               kind: str, err_ewma: float, frames_since_anchor: int,
               bw_mbps: float, edge_cost_s: float,
               offload_cost_s: float) -> None:
        row = {"stream": int(stream), "frame": int(frame),
               "policy": policy, "device": device, "kind": kind,
               "err_ewma": float(err_ewma),
               "frames_since_anchor": int(frames_since_anchor),
               "bw_mbps": float(bw_mbps),
               "edge_cost_s": float(edge_cost_s),
               "offload_cost_s": float(offload_cost_s)}
        self._index[(row["stream"], row["frame"])] = len(self.rows)
        self.rows.append(row)

    def __len__(self) -> int:
        return len(self.rows)

    def row(self, stream: int, frame: int) -> Optional[Dict]:
        i = self._index.get((int(stream), int(frame)))
        return None if i is None else self.rows[i]

    # -- export ----------------------------------------------------------
    def to_jsonl(self, file=None) -> str:
        text = "".join(json.dumps(r, sort_keys=True) + "\n"
                       for r in self.rows)
        _write(text, file)
        return text

    def to_csv(self, file=None) -> str:
        buf = io.StringIO()
        w = csv.DictWriter(buf, fieldnames=AUDIT_FIELDS)
        w.writeheader()
        for r in self.rows:
            w.writerow(r)
        text = buf.getvalue()
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
