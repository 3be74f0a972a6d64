"""Session: run a :class:`Scenario` end to end and get a RunReport.

Port of ``repro/api/session.py``: a single stream (``n_streams == 1``)
through ``MobyEngine``, a fleet (``n_streams > 1`` in a moby mode) through
the orchestrated ``FleetEngine``, and the ``edge_only`` / ``cloud_only``
baselines (single-stream notions, as in the JAX package). The fleet's
single-dispatch ``run(scan=True)`` is ROADMAP item 8, "Fleet, scan mode",
and raises ``NotImplementedError`` until then; the observability hooks
(``obs=``) and the stream mesh are not ported either.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch import device as device_lib
from repro_torch.api.scenario import Scenario, scenario as _scenario
from repro_torch.fleet.engine import FleetEngine
from repro_torch.serving.common import RunReport
from repro_torch.serving.engine import MobyEngine

_SCAN_TODO = ("the fleet's scan mode is not ported yet (ROADMAP item 8, "
              "'Fleet, scan mode')")


class Session:
    """A live serving run for one scenario, computing on ``torch_device``
    (default ``"cuda"``; the CPU runs only when asked for)::

        report = Session(api.scenario("smoke")).run(16)
        report.mean_latency, report.anchor_rate, report.to_csv("out.csv")
    """

    def __init__(self, scn: Union[Scenario, str],
                 torch_device: Union[str, torch.device] = device_lib.DEFAULT):
        if isinstance(scn, str):
            scn = _scenario(scn)
        self.scenario = scn
        sparams = scn.scheduler_params()
        devices = scn.stream_devices()  # fail fast on unknown devices
        if scn.n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {scn.n_streams}")
        # Baselines (edge_only/cloud_only) are single-stream notions — a
        # fleet preset's baseline comparison runs on one stream, on stream
        # 0's resolved device.
        if scn.n_streams == 1 or scn.mode in ("edge_only", "cloud_only"):
            self.engine = MobyEngine(
                scn.scene, scn.detector, trace=scn.trace, mode=scn.mode,
                use_fos=scn.use_fos, use_tba=scn.use_tba,
                tparams=scn.tparams, sparams=sparams, seed=scn.seed,
                comp=scn.comp, device=devices[0], torch_device=torch_device)
        else:
            self.engine = FleetEngine(
                scn.scene, scn.detector, n_streams=scn.n_streams,
                trace=scn.trace, mode=scn.mode, use_fos=scn.use_fos,
                use_tba=scn.use_tba, tparams=scn.tparams, sparams=sparams,
                seed=scn.seed, comp=scn.comp, cloud_cfg=scn.cloud,
                device=scn.device, torch_device=torch_device)

    @property
    def n_streams(self) -> int:
        """Streams the built engine actually serves (1 for baselines)."""
        return getattr(self.engine, "n_streams", 1)

    def run(self, n_frames: int, scan: bool = False) -> RunReport:
        """Serve ``n_frames`` per stream. ``scan=True`` (the fleet's
        single-dispatch mode) is not ported yet and raises."""
        if scan:
            raise NotImplementedError(f"run(scan=True): {_SCAN_TODO}")
        report = self.engine.run(n_frames)
        report.scenario = self.scenario.name
        report.policy = self.scenario.scheduler_params().policy \
            if self.scenario.use_fos else ""
        return report
