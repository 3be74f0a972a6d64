"""FleetEngine: batched multi-stream Moby serving.

Port of ``repro/fleet/engine.py``. Runs S concurrent vehicle streams
through one call of the fleet step per frame (see fleet.step) on
``torch_device`` (default ``"cuda"``; the CPU runs only when asked for),
and fetches one packed ``(S, 7)`` stats tensor a frame. Fleet-level
resource contention is modelled on the host, where the network and cloud
clocks live, line for line as in the JAX package:

* **Shared uplink**: all of a frame's anchor/test uploads split one cell's
  trace bandwidth (runtime.netsim.SharedUplink), so transfer times degrade
  with fleet size;
* **Cloud batcher**: the round's requests are batched round-robin onto a
  pool of cloud GPUs (fleet.cloud.CloudBatcher);
* **Heterogeneous edges**: ``device`` accepts a profile name, a per-stream
  list or a mix spec (``profiles.ProfileVector``): per-stream component
  times, edge inference and scheduler cost telemetry.

Two run modes:

* :meth:`FleetEngine.run`, orchestrated: one call of the fleet step and
  one packed ``(S, 7)`` fetch a frame, byte-accurate host netsim timing;
* :meth:`FleetEngine.run_scan`, benchmark: the network/cloud model runs
  on the device beside the step (``step_lib.FleetScan``); on the card the
  run is one CUDA graph of the frame, replayed a frame, with one fetch at
  the end; on the CPU the same body runs frame by frame.

The ``RunReport`` latencies are modelled edge and network times, not
wall times of any chip. With S=1 the inputs and the timing reduce to the
single-stream ``MobyEngine``. Not ported yet: the stream mesh
(``mesh=``, ROADMAP item 11) and the observability hooks (``obs=``, item
9).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import projection, scheduler, transform
from repro_torch.data import scenes
from repro_torch.fleet import cloud as cloud_lib
from repro_torch.fleet import step as step_lib
from repro_torch.runtime import netsim, profiles
from repro_torch.serving import tape as tape_lib
from repro_torch.serving.common import (PC_BYTES, RESULT_BYTES, ComponentTimes,
                                        RunReport, modeled_frame_costs,
                                        onboard_transform_time)

# The dtype each tape column has on the device (jnp.asarray's defaults).
_DTYPES = dict(points=torch.float32, det2d=torch.float32, val2d=torch.bool,
               label_img=torch.int32, det3d=torch.float32, val3d=torch.bool,
               gt_boxes=torch.float32, gt_visible=torch.bool)


def report_from_packed(packed_sf: np.ndarray,
                       devices: Optional[Sequence[str]] = None) -> RunReport:
    """Build a RunReport from a (S, F, COL_ONBOARD+1) packed stats array
    (the scheduler's anchor/test bits are mutually exclusive, so the kind
    string per frame is lossless). ``devices`` stamps the per-stream
    device-profile names onto the report."""
    p = packed_sf
    is_anchor = p[:, :, step_lib.COL_IS_ANCHOR] > 0.5
    send_test = p[:, :, step_lib.COL_SEND_TEST] > 0.5
    kind = np.where(is_anchor, "anchor",
                    np.where(send_test, "test", "transform")).astype("<U12")
    return RunReport(kind=kind,
                     latency_s=p[:, :, step_lib.COL_LATENCY],
                     onboard_s=p[:, :, step_lib.COL_ONBOARD],
                     f1=p[:, :, step_lib.COL_F1],
                     precision=p[:, :, step_lib.COL_PRECISION],
                     recall=p[:, :, step_lib.COL_RECALL],
                     device=None if devices is None
                     else np.asarray(list(devices)))


class FleetEngine:
    def __init__(self, scene_cfg: scenes.SceneConfig, detector: str,
                 n_streams: int, trace: str = "belgium2", mode: str = "moby",
                 use_fos: bool = True, use_tba: bool = True,
                 tparams: Optional[transform.TransformParams] = None,
                 sparams: Optional[scheduler.SchedulerParams] = None,
                 seed: int = 0, comp: Optional[ComponentTimes] = None,
                 tapes: Optional[Sequence[tape_lib.FrameTape]] = None,
                 cloud_cfg: Optional[cloud_lib.CloudBatcherConfig] = None,
                 device: profiles.DeviceSpec = "jetson_tx2",
                 stream_seeds: Optional[Sequence[int]] = None,
                 torch_device: Union[str, torch.device] = device_lib.DEFAULT):
        if mode not in ("moby", "moby_onboard"):
            raise ValueError(f"FleetEngine serves moby modes, got {mode!r}")
        self.torch_device = device_lib.resolve(torch_device)
        self.cfg = scene_cfg
        self.detector = detector
        self.n_streams = n_streams
        self.trace = trace
        self.mode = mode
        self.use_fos = use_fos
        self.use_tba = use_tba
        # Edge device profiles, one per stream: a name, an S-list, or a mix
        # spec resolve to a ProfileVector. The cloud stays on the 2080Ti.
        self.pvec = profiles.profile_vector(device, n_streams)
        self.stream_devices = self.pvec.names
        # Stacked (S,)-field component model for the telemetry, plus
        # per-stream scalar slices for the host loop.
        self.comp = comp or profiles.component_times_vector(self.pvec)
        self.comps = [profiles.component_slice(self.comp, s)
                      for s in range(n_streams)]
        self.seed = seed
        if stream_seeds is not None and len(stream_seeds) != n_streams:
            raise ValueError(f"got {len(stream_seeds)} stream seeds for "
                             f"{n_streams} streams")
        self.stream_seeds = None if stream_seeds is None \
            else tuple(int(s) for s in stream_seeds)
        self.frame_dt = scene_cfg.dt
        base = tparams or transform.TransformParams()
        self.tparams = base._replace(use_tba=use_tba)
        self.sparams = sparams or scheduler.SchedulerParams()
        # FOS scoring cost applies only to test-offloading policies.
        self._charge_fos = use_fos and \
            scheduler.get_policy(self.sparams.policy).uses_tests
        tr, p = scenes.make_calibration(scene_cfg)
        self.calib = projection.Calibration(
            tr=torch.from_numpy(tr).to(self.torch_device),
            p=torch.from_numpy(p).to(self.torch_device),
            height=scene_cfg.img_h, width=scene_cfg.img_w)
        self.uplink = netsim.SharedUplink(trace, seed=seed)
        infer = profiles.detector_latency(detector, profiles.RTX_2080TI)
        cc = cloud_cfg or cloud_lib.CloudBatcherConfig()
        if cc.infer_s is None:
            # Fill the detector-derived per-frame latency (presets set
            # n_gpus/window without knowing the detector).
            cc = cloud_lib.replace_config(cc, infer_s=infer)
        self.cloud_cfg = cc
        self.batcher = cloud_lib.CloudBatcher(self.cloud_cfg)
        self._given_tapes = list(tapes) if tapes is not None else None
        self._stack: Optional[tape_lib.FrameTape] = None
        self._step = step_lib.make_fleet_step(
            self.calib, self.tparams, self.sparams, use_fos)
        self._scan_cache: Optional[step_lib.FleetScan] = None
        self.scan_timing: dict = {}
        # Host wall seconds of the last run, per frame: the whole frame
        # (inputs to the card, the step, the stats fetch, the host's
        # contention model), and the share spent putting the frame's
        # inputs on the device.
        self.frame_wall_s: List[float] = []
        self.input_wall_s: List[float] = []

    # ------------------------------------------------------------------
    def _stacked(self, n_frames: int) -> tape_lib.FrameTape:
        if self._given_tapes is not None:
            # Caller-supplied data plane: validate, never substitute.
            if len(self._given_tapes) != self.n_streams:
                raise ValueError(
                    f"got {len(self._given_tapes)} tapes for "
                    f"{self.n_streams} streams")
            if self._given_tapes[0].n_frames < n_frames:
                raise ValueError(
                    f"tapes hold {self._given_tapes[0].n_frames} frames, "
                    f"run asked for {n_frames}")
        if self._stack is None or self._stack.points.shape[1] < n_frames:
            tapes = self._given_tapes or tape_lib.record_fleet_tapes(
                self.cfg, self.detector, n_frames, self.n_streams,
                seed=self.seed)
            self._stack = tape_lib.stack_tapes(tapes)
        return tape_lib.FrameTape(*(a[:, :n_frames] for a in self._stack))

    def _edge_infer(self) -> np.ndarray:
        """(S,) per-stream edge inference latency from the profile vector."""
        return np.asarray(
            profiles.detector_latency(self.detector, self.pvec), np.float64)

    def _observe_telemetry(self, state: step_lib.FleetState
                           ) -> step_lib.FleetState:
        """Per-frame telemetry for cost-aware policies: every stream of
        the fleet shares the cell, so each observes its fair share of the
        current trace bandwidth; edge/offload costs are per-stream vectors
        from the profile vector."""
        bw = self.uplink.current_bw_mbps(n_sharers=self.n_streams)
        edge, off = modeled_frame_costs(
            self.comp, self.detector, bw, self.uplink.rtt_s, self.use_tba,
            self._charge_fos, onboard_anchors=self.mode == "moby_onboard",
            edge_device=self.pvec)
        sched = scheduler.observe_telemetry(state.sched, bw_mbps=bw,
                                            edge_cost_s=edge,
                                            offload_cost_s=off)
        return state._replace(sched=sched)

    def _frame_inputs(self, stack: tape_lib.FrameTape,
                      t: int) -> step_lib.FrameInputs:
        """Frame ``t`` of every stream, copied to the device."""
        return step_lib.FrameInputs(**{
            name: torch.from_numpy(np.ascontiguousarray(
                getattr(stack, name)[:, t])).to(self.torch_device,
                                                _DTYPES[name])
            for name in step_lib.FrameInputs._fields})

    # ------------------------------------------------------------------
    def run(self, n_frames: int) -> RunReport:
        """Orchestrated serving: one fleet step + one stats fetch per
        frame for all S streams; byte-accurate shared-uplink/cloud timing."""
        stack = self._stacked(n_frames)
        s_n = self.n_streams
        state = self._init_state()
        edge_inf = self._edge_infer()   # (S,), frame-invariant
        walls = np.zeros(s_n)
        inflight_at = np.full(s_n, np.inf)
        self.uplink.reset()
        self.batcher.reset()
        self.frame_wall_s, self.input_wall_s = [], []
        out = np.zeros((s_n, n_frames, step_lib.COL_ONBOARD + 1), np.float32)

        for t in range(n_frames):
            t_start = time.perf_counter()
            inp = self._frame_inputs(stack, t)
            self.input_wall_s.append(time.perf_counter() - t_start)
            arrived = walls >= inflight_at
            if self.use_fos:
                state = self._observe_telemetry(state)
            state, packed = self._step(
                state, inp, torch.from_numpy(arrived).to(self.torch_device),
                torch.full((), t, dtype=torch.int32,
                           device=self.torch_device))
            pk = packed.cpu().numpy()        # the one fetch per frame
            is_anchor = pk[:, step_lib.COL_IS_ANCHOR] > 0.5
            send_test = pk[:, step_lib.COL_SEND_TEST] > 0.5
            inflight_at[arrived] = np.inf

            # Fleet-level contention: this round's uploads share the cell
            # uplink; its cloud requests are served as one batch.
            cloud_anchor = is_anchor & (self.mode != "moby_onboard")
            senders = cloud_anchor | send_test
            n_up = int(senders.sum())
            roundtrip = np.zeros(s_n)
            if n_up:
                up = self.uplink.transfer_time(PC_BYTES, n_sharers=n_up)
                down = self.uplink.transfer_time(RESULT_BYTES,
                                                 n_sharers=n_up)
                idxs = np.flatnonzero(senders)
                done = self.batcher.submit_batch(
                    [self.uplink.t + up] * n_up)
                for j, s in enumerate(idxs):
                    roundtrip[s] = (done[j] - self.uplink.t) + down

            lat = np.zeros(s_n)
            onb = np.zeros(s_n)
            for s in range(s_n):
                if is_anchor[s]:
                    lat[s] = edge_inf[s] \
                        if self.mode == "moby_onboard" else roundtrip[s]
                else:
                    n_assoc = int(pk[s, step_lib.COL_N_ASSOC])
                    n_new = max(int(pk[s, step_lib.COL_N_VALID]) - n_assoc, 0)
                    onb[s] = onboard_transform_time(
                        self.comps[s], n_assoc, n_new, self.use_tba,
                        self._charge_fos)
                    lat[s] = onb[s]
                if send_test[s]:
                    inflight_at[s] = walls[s] + roundtrip[s]

            out[:, t, :step_lib.N_COLS] = pk
            out[:, t, step_lib.COL_LATENCY] = lat
            out[:, t, step_lib.COL_ONBOARD] = onb
            walls += np.where(is_anchor, np.maximum(self.frame_dt, lat),
                              self.frame_dt)
            self.uplink.advance(self.frame_dt)
            self.frame_wall_s.append(time.perf_counter() - t_start)
        report = report_from_packed(out, devices=self.stream_devices)
        report.frame_dt = self.frame_dt
        return report

    # ------------------------------------------------------------------
    def _init_state(self) -> step_lib.FleetState:
        return step_lib.init_fleet_state(self.n_streams, self.cfg.max_obj,
                                         stream_seeds=self.stream_seeds,
                                         device=self.torch_device)

    def run_scan(self, n_frames: int) -> RunReport:
        """Benchmark mode: the network/cloud model runs on the device with
        the fleet step (``step_lib.FleetScan``). The tape goes to the
        device once; on the card the run is one CUDA graph of the frame,
        captured once and replayed ``n_frames`` times, with one fetch of
        the ``(F, S, 9)`` rows at the end; on the CPU the same body runs
        frame by frame. ``scan_timing`` keeps the host seconds of the
        last run's parts."""
        scan = self._scan_fn()
        t0 = time.perf_counter()
        stacked = self._scan_inputs(n_frames)
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)
        t1 = time.perf_counter()
        _, outs = scan.run(self._init_state(), stacked, n_frames)
        packed = outs.cpu().numpy().transpose(1, 0, 2)  # (F,S,C)->(S,F,C)
        t2 = time.perf_counter()
        self.scan_timing = dict(tape_s=t1 - t0, run_s=t2 - t1, **scan.timing)
        if "replay_start" in self.scan_timing:
            # From the first replay to the fetched rows.
            self.scan_timing["replay_s"] = \
                t2 - self.scan_timing.pop("replay_start")
        report = report_from_packed(packed, devices=self.stream_devices)
        report.frame_dt = self.frame_dt
        return report

    def _scan_inputs(self, n_frames: int) -> step_lib.FrameInputs:
        """The tape as (F, S, ...) tensors on the device, copied once."""
        stack = self._stacked(n_frames)
        return step_lib.FrameInputs(**{
            name: torch.from_numpy(np.ascontiguousarray(
                getattr(stack, name).swapaxes(0, 1))).to(self.torch_device,
                                                        _DTYPES[name])
            for name in step_lib.FrameInputs._fields})

    def _scan_fn(self) -> step_lib.FleetScan:
        if self._scan_cache is not None:
            return self._scan_cache
        net = step_lib.ScanNetParams(
            bw_mbps=netsim.synthesize_trace(self.trace, seed=self.seed)
            .astype(np.float32),
            trace_dt=0.1, rtt_s=self.uplink.rtt_s, frame_dt=self.frame_dt,
            pc_mbits=PC_BYTES * 8 / 1e6,
            result_mbits=RESULT_BYTES * 8 / 1e6,
            infer_s=self.cloud_cfg.infer_s,
            marginal=self.cloud_cfg.marginal,
            max_batch=self.cloud_cfg.max_batch,
            n_gpus=self.cloud_cfg.n_gpus)
        self._scan_cache = step_lib.FleetScan(
            self.n_streams, self.calib, self.tparams, self.sparams,
            self.comp, net, self.use_fos,
            onboard_anchors=self.mode == "moby_onboard",
            edge_infer_s=self._edge_infer(),
            charge_fos=self._charge_fos, device=self.torch_device)
        return self._scan_cache
