"""Session: run a :class:`Scenario` end to end and get a RunReport.

Port of ``repro/api/session.py``: a single stream (``n_streams == 1``)
through ``MobyEngine``, a fleet (``n_streams > 1`` in a moby mode) through
``FleetEngine``, and the ``edge_only`` / ``cloud_only`` baselines
(single-stream notions, as in the JAX package). ``run(scan=True)`` is the
fleet's scan (benchmark) mode, ``FleetEngine.run_scan``: at S=1 an
equivalent single-stream fleet slice is built for it, and a baseline mode
raises ``ValueError`` as the JAX package does. The observability hooks
(``obs=``) and the stream mesh are not ported.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import device as device_lib
from repro_torch.api.scenario import Scenario, scenario as _scenario
from repro_torch.fleet.engine import FleetEngine
from repro_torch.serving.common import RunReport
from repro_torch.serving.engine import MobyEngine


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
        self.torch_device = torch_device
        self._scan_engine: Optional[FleetEngine] = None
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
            self.engine = self._scan_engine = self._fleet(scn.n_streams)

    def _fleet(self, n_streams: int) -> FleetEngine:
        scn = self.scenario
        # A lazily built S=1 slice of a fleet scenario keeps stream 0's
        # resolved device; full-size fleets pass the spec through.
        device = scn.device if n_streams == scn.n_streams \
            else list(scn.stream_devices()[:n_streams])
        return FleetEngine(
            scn.scene, scn.detector, n_streams=n_streams, trace=scn.trace,
            mode=scn.mode, use_fos=scn.use_fos, use_tba=scn.use_tba,
            tparams=scn.tparams, sparams=scn.scheduler_params(),
            seed=scn.seed, comp=scn.comp, cloud_cfg=scn.cloud, device=device,
            torch_device=self.torch_device)

    @property
    def n_streams(self) -> int:
        """Streams the built engine actually serves (1 for baselines)."""
        return getattr(self.engine, "n_streams", 1)

    def run(self, n_frames: int, scan: bool = False) -> RunReport:
        """Serve ``n_frames`` per stream.

        ``scan=True`` uses the fleet's scan mode (on the card, one CUDA
        graph of the frame replayed ``n_frames`` times). At S=1 an
        equivalent single-stream fleet slice is built lazily for it (S=1
        fleet parity is a tested invariant).
        """
        if scan:
            if self._scan_engine is None:
                self._scan_engine = self._fleet(1)
            report = self._scan_engine.run_scan(n_frames)
        else:
            report = self.engine.run(n_frames)
        report.scenario = self.scenario.name
        report.policy = self.scenario.scheduler_params().policy \
            if self.scenario.use_fos else ""
        return report
