"""Moby serving engine: the full edge-cloud system of Fig. 4, one stream.

Orchestrates, per frame:
  * frame treatment (anchor / test / transform) via the offloading
    scheduler (core.scheduler),
  * the on-device path (2D detection -> tracking association -> 2D->3D
    transformation) on the engine's torch device,
  * the cloud path (3D detector on anchor/test frames) over the 4G netsim,
  * **recomputation** (§3.4): while blocked on an anchor result, buffered
    intermediate outputs are replayed through the transformation so the
    wait is hidden,
  * end-to-end latency accounting on calibrated device profiles, and
    accuracy vs the simulator's ground truth.

Deployment modes reproduce the paper's baselines: ``moby``, ``edge_only``,
``cloud_only``, plus ``moby_onboard`` (anchors run the 3D detector on the
edge).

Port of ``repro/serving/engine.py``. ``device`` still names the *modeled*
edge profile (``"jetson_tx2"``): the ``RunReport`` latencies are modeled
TX2 times, computed on the host, not wall times of any chip.
``torch_device`` is where the pipeline computes (default ``"cuda"``; a run
on the CPU must ask for it). ``obs=`` (``repro_torch.obs.ObsConfig``)
turns on the metrics, the trace and the decision audit; off, every hook is
one pointer test and the run is bitwise the unobserved one.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import metrics, prng, projection, scheduler, transform
from repro_torch.data import scenes
from repro_torch.kernels import _build
from repro_torch.obs import observe as obs_lib
from repro_torch.runtime import netsim, profiles
from repro_torch.serving import tape as tape_lib
from repro_torch.serving.common import (PC_BYTES, RESULT_BYTES,
                                        ComponentTimes, FrameRecord,
                                        RunReport, modeled_frame_costs,
                                        onboard_transform_time)

# Disabled-observability stand-in for `with obs.measured_span(...)`.
_NULL_CTX = contextlib.nullcontext()


def _frame_stats(boxes3d, valid, gt_boxes, gt_visible, det_to_track):
    """All per-frame scalars the host loop needs, packed into one small
    tensor so each frame costs a single device-to-host fetch."""
    f1, prec, rec = metrics.f1_score(boxes3d, valid, gt_boxes, gt_visible)
    n_assoc = ((det_to_track >= 0) & valid).sum()
    n_valid = valid.sum()
    return torch.stack([f1, prec, rec, n_assoc.to(torch.float32),
                        n_valid.to(torch.float32)])


class MobyEngine:
    def __init__(self, scene_cfg: scenes.SceneConfig, detector: str,
                 trace: str = "belgium2", mode: str = "moby",
                 use_fos: bool = True, use_tba: bool = True,
                 tparams: Optional[transform.TransformParams] = None,
                 sparams: Optional[scheduler.SchedulerParams] = None,
                 seed: int = 0,
                 comp: Optional[ComponentTimes] = None,
                 tape: Optional[tape_lib.FrameTape] = None,
                 device: str = "jetson_tx2",
                 torch_device: Union[str, torch.device] = device_lib.DEFAULT,
                 obs: Optional[obs_lib.ObsConfig] = None):
        self.torch_device = device_lib.resolve(torch_device)
        self.cfg = scene_cfg
        self.detector = detector
        self.mode = mode
        self.use_fos = use_fos
        self.use_tba = use_tba
        # The edge device profile is the single modeled-latency source:
        # component times (unless explicitly overridden) and edge
        # inference both come from it (runtime.profiles).
        self.profile = profiles.get_profile(device)
        self.comp = comp or profiles.component_times(self.profile)
        self.net = netsim.NetworkSim(trace, seed=seed)
        self.stream = scenes.SceneStream(scene_cfg, seed=seed)
        self.calib = projection.Calibration(
            tr=self._tensor(self.stream.tr), p=self._tensor(self.stream.p),
            height=scene_cfg.img_h, width=scene_cfg.img_w)
        base = tparams or transform.TransformParams()
        self.tparams = base._replace(use_tba=use_tba)
        self.sparams = sparams or scheduler.SchedulerParams()
        # The per-frame FOS scoring cost only applies when the active
        # policy actually offloads test frames.
        self._charge_fos = use_fos and \
            scheduler.get_policy(self.sparams.policy).uses_tests
        self.rng = np.random.default_rng(seed + 1)
        self.noise = scenes.DETECTOR_PROFILES[detector]
        self.frame_dt = scene_cfg.dt
        # Optional pre-recorded data plane (serving.tape). When set, all
        # per-frame inputs come from the tape instead of live scene
        # rendering + lazy oracle draws.
        self.tape = tape
        # Host wall seconds per frame of the last moby-mode run, from the
        # frame's host inputs (scene rendered) to its stats on the host; the
        # per-frame stats fetch waits for the device, so the span covers
        # the frame's device work.
        self.frame_wall_s: List[float] = []
        # Observability switch (repro_torch.obs); None/all-off keeps every
        # run hook a single pointer test.
        self.obs_config = obs

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device (one copy)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.torch_device)

    # ------------------------------------------------------------------
    def _cloud_parts(self) -> tuple:
        """(upload, cloud inference, download) legs of one cloud trip —
        split out so the observer can record the legs individually;
        ``_cloud_roundtrip`` sums them in this exact order."""
        tx = self.net.transfer_time(PC_BYTES)
        infer = profiles.detector_latency(self.detector,
                                          profiles.RTX_2080TI)
        back = self.net.transfer_time(RESULT_BYTES)
        return tx, infer, back

    def _cloud_roundtrip(self, obs=None, t0: float = 0.0,
                         record_gpu: bool = False) -> float:
        tx, infer, back = self._cloud_parts()
        if obs is not None:
            bd = self.net.transfer_breakdown(PC_BYTES, tx)
            obs.record_uplink("up", t0, tx, 1, PC_BYTES, bd["eff_mbps"])
            if record_gpu:
                obs.on_cloud_batch(0, t0 + tx, t0 + tx + infer, 1, t0 + tx)
            bdd = self.net.transfer_breakdown(RESULT_BYTES, back)
            obs.record_uplink("down", t0 + tx + infer, back, 1,
                              RESULT_BYTES, bdd["eff_mbps"])
        return tx + infer + back

    def _edge_infer(self) -> float:
        return profiles.detector_latency(self.detector, self.profile)

    def _onboard_transform_time(self, n_assoc: int, n_new: int) -> float:
        return onboard_transform_time(self.comp, n_assoc, n_new,
                                      self.use_tba, self._charge_fos)

    def _observe_telemetry(self, sstate: scheduler.SchedulerState,
                           obs=None) -> scheduler.SchedulerState:
        """Per-frame telemetry for cost-aware policies: the bandwidth the
        netsim currently delivers plus modeled edge/offload frame costs
        from the active device profiles."""
        bw = self.net.current_bw_mbps()
        edge, off = modeled_frame_costs(
            self.comp, self.detector, bw, self.net.rtt_s, self.use_tba,
            self._charge_fos, onboard_anchors=self.mode == "moby_onboard",
            edge_device=self.profile)
        if obs is not None:
            obs.note_telemetry(bw, edge, off)
        return scheduler.observe_telemetry(sstate, bw_mbps=bw,
                                           edge_cost_s=edge,
                                           offload_cost_s=off)

    # ------------------------------------------------------------------
    def run(self, n_frames: int) -> RunReport:
        if self.tape is not None and self.tape.n_frames < n_frames:
            raise ValueError(f"tape holds {self.tape.n_frames} frames, "
                             f"run asked for {n_frames}")
        if self.mode in ("edge_only", "cloud_only"):
            return self._run_baseline(n_frames)
        return self._run_moby(n_frames)

    def _run_baseline(self, n_frames: int) -> RunReport:
        obs = obs_lib.make_observer(
            self.obs_config, n_streams=1, devices=(self.profile.name,),
            policy=self.mode, detector=self.detector,
            frame_dt=self.frame_dt)
        recs = []
        for t, frame in enumerate(self.stream.frames(n_frames)):
            det, val = scenes.oracle_detect_3d(frame, self.rng, self.noise)
            lat = self._edge_infer() if self.mode == "edge_only" \
                else self._cloud_roundtrip(obs, t0=t * self.frame_dt)
            f1, p, r = metrics.f1_score(
                self._tensor(det.astype(np.float32)), self._tensor(val),
                self._tensor(frame.gt_boxes.astype(np.float32)),
                self._tensor(frame.visible_gt()))
            recs.append(FrameRecord(t, self.mode, lat,
                                    lat if self.mode == "edge_only" else 0.0,
                                    float(f1), float(p), float(r)))
            self.net.advance(self.frame_dt)
            if obs is not None and obs.cfg.want_audit:
                # Baselines make no scheduling decision; the audit still
                # gets its one row per stream-frame (telemetry zeros).
                obs.audit_frame(t, self.mode, 0.0, 0.0)
        report = RunReport.from_records(recs, device=self.profile.name)
        report.frame_dt = self.frame_dt
        if obs is not None:
            obs.finalize(report)
        return report

    def _run_moby(self, n_frames: int) -> RunReport:
        obs = obs_lib.make_observer(
            self.obs_config, n_streams=1, devices=(self.profile.name,),
            policy=self.sparams.policy if self.use_fos else "no_fos",
            detector=self.detector, frame_dt=self.frame_dt)
        want_audit = obs is not None and obs.cfg.want_audit
        tensor = self._tensor
        dev = self.torch_device
        recs: List[FrameRecord] = []
        mstate = transform.init_state(max_tracks=2 * self.cfg.max_obj,
                                      key=prng.key(0, device=dev))
        sstate = scheduler.init_scheduler(self.cfg.max_obj, device=dev)
        # In-flight test frame: (arrival_wall_time, boxes, valid) or None.
        inflight = None
        # Buffered intermediate outputs for recomputation (§3.4).
        recompute_buf = []
        wall = 0.0
        false = torch.zeros((), dtype=torch.bool, device=dev)

        frame_iter = None if self.tape is not None \
            else self.stream.frames(n_frames)
        self.frame_wall_s = []

        for t in range(n_frames):
            tf = self.tape.frame(t) if self.tape is not None else None
            frame = next(frame_iter) if frame_iter is not None else None
            t_start = time.perf_counter()
            if want_audit:
                # Decision-time scheduler state, fetched *before* the step
                # updates it (one extra (2,) fetch per frame, audit only).
                pre_tel = scheduler.decision_telemetry(sstate).cpu().numpy()
            if self.use_fos:
                sstate = self._observe_telemetry(sstate, obs)
                actions = scheduler.scheduler_pre(sstate, self.sparams)
                # One small fetch: the frame's treatment decides the branch.
                is_anchor, send_test = (bool(x) for x in torch.stack(
                    [actions.run_as_anchor, actions.send_test]).cpu())
            else:
                is_anchor, send_test = t == 0, False
                actions = scheduler.SchedulerActions(
                    false, torch.full((), is_anchor, dtype=torch.bool, device=dev))

            if is_anchor:
                if tf is not None:
                    det3d, val3d = tf.det3d, tf.val3d
                else:
                    det3d, val3d = scenes.oracle_detect_3d(frame, self.rng,
                                                           self.noise)
                if self.mode == "moby_onboard":
                    latency = self._edge_infer()
                else:
                    latency = self._cloud_roundtrip(obs, t0=wall,
                                                    record_gpu=True)
                with obs.measured_span("moby/anchor_step", _build.build_count,
                                       frame=t) if obs is not None \
                        else _NULL_CTX:
                    mstate, out = transform.anchor_step(
                        mstate, tensor(det3d.astype(np.float32)),
                        tensor(val3d), self.calib, params=self.tparams)
                # Recomputation: replay buffered frames through the
                # transformation while waiting — hidden latency, so it does
                # not add to `latency`; we verify it fits in the wait.
                recompute_time = len(recompute_buf) * (
                    self.comp.bbox_est_assoc + self.comp.point_proj)
                assert recompute_time <= max(latency, 1e-9) + 1.0
                recompute_buf.clear()
            else:
                if tf is not None:
                    boxes2d, val2d, label_img = tf.det2d, tf.val2d, \
                        tf.label_img
                    points = tf.points
                else:
                    boxes2d, val2d, label_img = scenes.oracle_detect_2d(
                        frame, self.rng)
                    points = frame.points
                with obs.measured_span("moby/transform_step",
                                       _build.build_count,
                                       frame=t) if obs is not None \
                        else _NULL_CTX:
                    mstate, out = transform.transform_step(
                        mstate, tensor(points.astype(np.float32)),
                        tensor(boxes2d.astype(np.float32)), tensor(val2d),
                        tensor(label_img.astype(np.int32)), self.calib,
                        params=self.tparams)
                recompute_buf.append(t)
                if len(recompute_buf) > 8:
                    recompute_buf.pop(0)

            # Test-frame transport (parallel with on-device processing).
            if send_test and inflight is None:
                if tf is not None:
                    tdet, tval = tf.det3d, tf.val3d
                else:
                    tdet, tval = scenes.oracle_detect_3d(frame, self.rng,
                                                         self.noise)
                arrive = wall + self._cloud_roundtrip(obs, t0=wall)
                inflight = (arrive, tensor(tdet.astype(np.float32)),
                            tensor(tval))

            test_arrived = inflight is not None and wall >= inflight[0]
            tb = inflight[1] if test_arrived else sstate.buf_boxes
            tv = inflight[2] if test_arrived else sstate.buf_valid
            if self.use_fos:
                sstate = scheduler.scheduler_post(
                    sstate, actions, out.boxes3d, out.valid,
                    torch.full((), test_arrived, dtype=torch.bool, device=dev),
                    tb, tv,
                    self.sparams)
            if test_arrived:
                inflight = None

            # One packed fetch per frame: f1/precision/recall + the
            # detection counts driving the on-board time model.
            gt_boxes = tf.gt_boxes if tf is not None else frame.gt_boxes
            gt_vis = tf.gt_visible if tf is not None else frame.visible_gt()
            with obs.measured_span("moby/frame_stats_fetch",
                                   _build.build_count,
                                   frame=t) if obs is not None \
                    else _NULL_CTX:
                stats = _frame_stats(out.boxes3d, out.valid,
                                     tensor(gt_boxes.astype(np.float32)),
                                     tensor(gt_vis), out.det_to_track).cpu()
            self.frame_wall_s.append(time.perf_counter() - t_start)
            f1, p, r = float(stats[0]), float(stats[1]), float(stats[2])
            if is_anchor:
                onboard = 0.0
            else:
                n_assoc = int(stats[3])
                n_new = max(int(stats[4]) - n_assoc, 0)
                onboard = self._onboard_transform_time(n_assoc, n_new)
                latency = onboard

            kind = "anchor" if is_anchor else \
                ("test" if send_test else "transform")
            recs.append(FrameRecord(t, kind, latency, onboard, f1, p, r))
            if want_audit:
                obs.audit_frame(t, kind, pre_tel[0], pre_tel[1])
            wall += max(self.frame_dt, latency if is_anchor else 0.0)
            self.net.advance(self.frame_dt)
        report = RunReport.from_records(recs, device=self.profile.name)
        report.frame_dt = self.frame_dt
        if obs is not None:
            obs.finalize(report)
        return report
