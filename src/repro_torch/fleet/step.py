"""Fleet stepping: S streams advanced by one call per frame.

Port of ``repro/fleet/step.py``'s orchestrated half. :func:`make_fleet_step`
returns a plain function that advances every stream of a fleet in one
call: the scheduler's ``pre``, the fused anchor/transform step (both
branches computed, each stream's selected: what ``jax.vmap`` makes of
``lax.cond``), the in-flight test latch, the scheduler's ``post``, F1, and
one packed ``(S, N_COLS)`` stats tensor, the host's one fetch a frame.
The JAX package's ``jax.vmap`` over streams is the leading S axis that
every core function of the port takes; on the card the frame's hot ops
run as one launch each for all S streams (K1's labels instance; K3 over
the S x O objects; K2 once a branch).

The host supplies only the test-arrival flags (it owns the network clock).

:class:`FleetScan` (port of the scan half) wraps the same step with the
network/cloud model on the device: its body is one frame in float32 with
the JAX body's roundings, and on the card a run is one CUDA graph of that
frame, replayed a frame (``lax.scan``'s counterpart), with one fetch at
the end. The stream mesh is not ported
(ROADMAP item 11).
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import fp, metrics, prng, scheduler, transform
from repro_torch.serving.common import ComponentTimes, nominal_transform_time

# Columns of the packed per-stream stats row (the one host fetch per frame).
COL_IS_ANCHOR = 0
COL_SEND_TEST = 1
COL_F1 = 2
COL_PRECISION = 3
COL_RECALL = 4
COL_N_ASSOC = 5
COL_N_VALID = 6
N_COLS = 7
# The engine's report appends two more columns (modelled times).
COL_LATENCY = 7
COL_ONBOARD = 8


class FrameInputs(NamedTuple):
    """One frame of per-stream inputs, each with a leading S axis (see
    serving.tape for the recording)."""
    points: torch.Tensor      # (S, N, 3)
    det2d: torch.Tensor       # (S, D, 4)
    val2d: torch.Tensor       # (S, D)
    label_img: torch.Tensor   # (S, H, W)
    det3d: torch.Tensor       # (S, D, 7)
    val3d: torch.Tensor       # (S, D)
    gt_boxes: torch.Tensor    # (S, D, 7)
    gt_visible: torch.Tensor  # (S, D)


class FleetState(NamedTuple):
    """All per-stream state, stacked on a leading S axis."""
    moby: transform.MobyState          # tracker + avg size + PRNG key
    sched: scheduler.SchedulerState    # frame-offloading state machine
    inflight_boxes: torch.Tensor       # (S, D, 7) latched test payloads
    inflight_valid: torch.Tensor       # (S, D)


def init_fleet_state(n_streams: int, max_obj: int, key_base: int = 0,
                     stream_seeds: Optional[Sequence[int]] = None,
                     device=None) -> FleetState:
    """Stream i's PRNG seed is ``key_base + i`` so stream 0 of a fleet
    matches a single-stream engine seeded with ``key_base`` (parity).
    ``stream_seeds`` (length-S ints) overrides the per-stream seeds."""
    if stream_seeds is None:
        seeds = [key_base + i for i in range(n_streams)]
    else:
        if len(stream_seeds) != n_streams:
            raise ValueError(f"got {len(stream_seeds)} stream seeds for "
                             f"{n_streams} streams")
        seeds = [int(s) for s in stream_seeds]
    keys = torch.stack([prng.key(s, device=device) for s in seeds])
    return FleetState(
        moby=transform.init_state(2 * max_obj, keys),
        sched=scheduler.init_scheduler_fleet(n_streams, max_obj,
                                             device=device),
        inflight_boxes=torch.zeros((n_streams, max_obj, 7),
                                   dtype=torch.float32, device=device),
        inflight_valid=torch.zeros((n_streams, max_obj), dtype=torch.bool,
                                   device=device))


StepFn = Callable[[FleetState, FrameInputs, torch.Tensor, torch.Tensor],
                  tuple[FleetState, torch.Tensor]]


def make_fleet_step(calib, params, sparams,
                    use_fos: bool = True) -> StepFn:
    """``(state, FrameInputs[S], test_arrived[S], t) -> (state, (S,
    N_COLS))``, with the calibration, the transform and scheduler
    parameters and the policy switch bound once. ``t`` is the frame index:
    without FOS, frame 0 is the anchor. The engines pass it as a 0-dim
    integer tensor on the state's device (a host int, which the step also
    takes, would be frozen into a CUDA graph of the step)."""

    def fleet_step(state: FleetState, inp: FrameInputs,
                   test_arrived: torch.Tensor, t: torch.Tensor):
        if use_fos:
            actions = scheduler.scheduler_pre(state.sched, sparams)
        else:
            first = torch.as_tensor(t, device=test_arrived.device) == 0
            actions = scheduler.SchedulerActions(
                send_test=torch.zeros_like(test_arrived),
                run_as_anchor=first.expand(test_arrived.shape))
        mstate, out = transform.fused_step(
            state.moby, inp.points, inp.det2d, inp.val2d, inp.label_img,
            inp.det3d, inp.val3d, actions.run_as_anchor, calib, params)

        # The cloud's answer for an in-flight test frame is that frame's
        # own 3D detections, latched on the device at send time; the host
        # supplies only the arrival timing.
        arrived3 = test_arrived[:, None, None]
        tb = torch.where(arrived3, state.inflight_boxes, state.sched.buf_boxes)
        tv = torch.where(test_arrived[:, None], state.inflight_valid,
                         state.sched.buf_valid)
        sched_state = state.sched
        if use_fos:
            sched_state = scheduler.scheduler_post(
                sched_state, actions, out.boxes3d, out.valid, test_arrived,
                tb, tv, sparams)
        new_ib = torch.where(actions.send_test[:, None, None], inp.det3d,
                             state.inflight_boxes)
        new_iv = torch.where(actions.send_test[:, None], inp.val3d,
                             state.inflight_valid)

        f1, prec, rec = metrics.f1_score(out.boxes3d, out.valid,
                                         inp.gt_boxes, inp.gt_visible)
        n_assoc = ((out.det_to_track >= 0) & out.valid).sum(-1)
        n_valid = out.valid.sum(-1)
        packed = torch.stack([
            actions.run_as_anchor.to(torch.float32),
            actions.send_test.to(torch.float32),
            f1, prec, rec,
            n_assoc.to(torch.float32), n_valid.to(torch.float32)], dim=-1)
        return FleetState(mstate, sched_state, new_ib, new_iv), packed

    return fleet_step


# ---------------------------------------------------------------------------
# Scan mode: the whole run with the network and cloud model on the device
# ---------------------------------------------------------------------------


def onboard_time_vec(comp: ComponentTimes, n_assoc: torch.Tensor,
                     n_new: torch.Tensor, use_tba: bool,
                     use_fos: bool) -> torch.Tensor:
    """Tensor twin of serving.common.onboard_transform_time. The
    component times (host floats, or (S,) numpy vectors) enter in float32,
    as JAX's weak typing takes them."""
    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=n_new.device)
    t = f32(comp.seg_2d + comp.point_proj + comp.filtration)
    total = torch.clamp_min(n_assoc + n_new, 1.0)
    frac_new = n_new / total
    t = t + frac_new * f32(comp.bbox_est_new) \
        + (1 - frac_new) * f32(comp.bbox_est_assoc)
    if use_tba:
        t = t + f32(comp.tba)
    if use_fos:
        t = t + f32(comp.fos)
    return t


class ScanNetParams(NamedTuple):
    """On-device network + cloud model for scan (benchmark) mode.

    A one-tick fair-share approximation of SharedUplink + CloudBatcher:
    transfer time is rtt + bits / (trace bandwidth / concurrent senders),
    and same-frame cloud requests form one batch on a single server. A
    configured batch window (``CloudBatcherConfig.window_s``) never splits
    a round, as a round's requests arrive at one modelled instant, so it
    has no field here.
    """
    bw_mbps: np.ndarray        # (T,) synthesized cell-uplink trace
    trace_dt: float
    rtt_s: float
    frame_dt: float
    pc_mbits: float            # LiDAR frame upload size
    result_mbits: float        # detections download size
    infer_s: float             # cloud detector, batch of 1
    marginal: float            # marginal batch cost (CloudBatcherConfig)
    max_batch: int             # detector batch-size ceiling (chunks beyond)
    n_gpus: int = 1            # cloud GPU pool size (CloudBatcherConfig)


class ScanConsts(NamedTuple):
    """Per-run constants of the scan body on the device: host-f64
    component sums rounded to f32 once, as the JAX package rounds them."""
    bw_trace: torch.Tensor     # (T,) cell-uplink trace
    edge_cost_s: torch.Tensor  # (S,) modeled on-device frame cost
    edge_infer_s: torch.Tensor  # (S,) edge detector latency (onboard mode)
    ob_base: torch.Tensor      # (S,) seg+proj+filtration time
    ob_new: torch.Tensor       # (S,) bbox estimation, unassociated det
    ob_assoc: torch.Tensor     # (S,) bbox estimation, tracked det
    ob_tba: torch.Tensor       # (S,) tracking-based adjustment time
    ob_fos: torch.Tensor       # (S,) FOS scoring time


class ScanCarry(NamedTuple):
    """What one frame of the scan hands the next."""
    state: FleetState
    walls: torch.Tensor        # (S,) f32 each stream's modelled clock
    inflight_at: torch.Tensor  # (S,) f32 arrival time of the test in flight
    busy: torch.Tensor         # () or (G,) f32 cloud GPU clocks
    rr: torch.Tensor           # () int32 round-robin GPU pointer


def _recip(c: float) -> float:
    """The float32 reciprocal XLA multiplies by where the JAX package
    divides by the constant ``c``."""
    return float(np.float32(1.0) / np.float32(c))


def _cdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` divided in float32 (``float / tensor`` in PyTorch
    multiplies by the reciprocal instead)."""
    return torch.div(torch.full_like(x, c), x)


def _leaves(tree) -> list:
    out = []
    for x in tree:
        out.extend(_leaves(x) if isinstance(x, tuple) else [x])
    return out


def _rebuild(tree, leaves):
    it = iter(leaves)

    def one(x):
        if isinstance(x, tuple):
            return type(x)(*(one(y) for y in x))
        return next(it)
    return one(tree)


class FleetScan:
    """Scan mode of a fleet (port of ``make_fleet_scan``, without
    ``mesh=``): :meth:`body` is one frame (the telemetry, the
    fleet step, the shared uplink's share, the cloud pool, the modelled
    latencies and clocks), all in float32 on the device from the
    ``ScanConsts``; :meth:`run` runs ``n_frames`` of it.

    On the CPU :meth:`run` steps the body eagerly, frame by frame
    (:meth:`run_eager`). On the card it puts nothing on the host: the body
    is warmed up once on a side stream, then one frame of it is captured
    in a ``torch.cuda.CUDAGraph`` over static buffers (the carry, the
    frame's inputs, the frame index and the ``(F, S, 9)`` output); each
    frame is a device-to-device copy of its inputs and a replay, under
    ``torch.cuda.set_sync_debug_mode("error")``. A failed capture raises:
    the card has no eager route.
    """

    def __init__(self, n_streams: int, calib, params, sparams,
                 comp: ComponentTimes, net: ScanNetParams,
                 use_fos: bool = True, onboard_anchors: bool = False,
                 edge_infer_s=0.0, charge_fos: Optional[bool] = None,
                 device=None):
        self.n_streams = n_streams
        self.params = params
        self.net = net
        self.use_fos = use_fos
        self.onboard_anchors = onboard_anchors
        self.charge_fos = use_fos if charge_fos is None else charge_fos
        self.step = make_fleet_step(calib, params, sparams, use_fos)

        def svec(v):
            return torch.from_numpy(np.broadcast_to(
                np.asarray(v, np.float64), (n_streams,)).astype(np.float32)
            ).to(device)

        self.consts = ScanConsts(
            bw_trace=torch.from_numpy(np.asarray(net.bw_mbps, np.float32))
            .to(device),
            edge_cost_s=svec(nominal_transform_time(comp, params.use_tba,
                                                    self.charge_fos)),
            edge_infer_s=svec(edge_infer_s),
            ob_base=svec(comp.seg_2d + comp.point_proj + comp.filtration),
            ob_new=svec(comp.bbox_est_new),
            ob_assoc=svec(comp.bbox_est_assoc),
            ob_tba=svec(comp.tba),
            ob_fos=svec(comp.fos))
        # Constant terms of a sum, folded into one as XLA folds them.
        f32 = np.float32
        self._offload_const = float(f32(2.0 * net.rtt_s) + f32(net.infer_s))
        self._ob_extra = self.consts.ob_tba if params.use_tba else None
        if self.charge_fos:
            self._ob_extra = self.consts.ob_fos if self._ob_extra is None \
                else self._ob_extra + self.consts.ob_fos
        # Host seconds of the last run on the card: warm-up, capture, and
        # the perf_counter at the first replay (the caller's fetch ends
        # the replays).
        self.timing: dict = {}
        # Kernel launches recorded into the last captured graph (each
        # replay launches them again).
        self.captured_launches: dict = {}

    def init_carry(self, state: FleetState) -> ScanCarry:
        dev = state.inflight_boxes.device
        s_n, g = self.n_streams, self.net.n_gpus
        return ScanCarry(
            state=state,
            walls=torch.zeros((s_n,), dtype=torch.float32, device=dev),
            inflight_at=torch.full((s_n,), float("inf"), dtype=torch.float32,
                                   device=dev),
            busy=torch.zeros(() if g == 1 else (g,), dtype=torch.float32,
                             device=dev),
            rr=torch.zeros((), dtype=torch.int32, device=dev))

    def body(self, carry: ScanCarry, t: torch.Tensor, inp: FrameInputs
             ) -> tuple[ScanCarry, torch.Tensor]:
        """One frame: ``t`` is the frame index (0-dim int32 on the
        device); returns the next carry and the frame's (S, 9) row.

        Each line computes what ``repro/fleet/step.py``'s scan body
        computes, with the float32 roundings XLA's CPU compiler gives it
        (they decide the trace index and the clocks' comparisons, so
        ``tests/test_torch_scan.py`` holds every frame bit for bit):
        ``x / c`` for a constant c is ``x * f32(1 / c)``; ``(x + c1) + c2``
        is ``x + f32(c1 + c2)``; ``a / (b / c)`` is ``(a * c) / b``; and
        ``x * y + z`` is one fused multiply-add where XLA fused it."""
        net, cs = self.net, self.consts
        state, walls, inflight_at, busy, rr = carry
        n_trace = cs.bw_trace.shape[0]
        inv_dt = _recip(net.trace_dt)

        def trace_at(sec):
            idx = torch.remainder((sec * inv_dt).to(torch.int32), n_trace)
            return cs.bw_trace.index_select(0, idx.reshape(1)).reshape(())

        test_arrived = walls >= inflight_at
        t_f = t.to(torch.float32)
        frame_dt = torch.full_like(t_f, net.frame_dt)
        net_t = t_f * net.frame_dt
        if self.use_fos:
            # Telemetry for cost-aware policies: each stream observes its
            # fair share of the current trace bandwidth plus the modelled
            # edge/offload frame costs.
            bw_share = trace_at(net_t) * _recip(float(self.n_streams))
            offload = cs.edge_infer_s if self.onboard_anchors else (
                _cdiv(net.pc_mbits + net.result_mbits, bw_share)
                + self._offload_const)
            state = state._replace(sched=scheduler.observe_telemetry(
                state.sched, bw_mbps=bw_share, edge_cost_s=cs.edge_cost_s,
                offload_cost_s=offload))
        state, packed = self.step(state, inp, test_arrived, t)
        is_anchor = packed[:, COL_IS_ANCHOR] > 0.5
        send_test = packed[:, COL_SEND_TEST] > 0.5

        # Shared uplink: all of this frame's senders split the cell rate
        # (on-board anchors stay off the network).
        cloud_anchor = torch.zeros_like(is_anchor) if self.onboard_anchors \
            else is_anchor
        n_up = (cloud_anchor | send_test).sum().to(torch.int32)
        n_req = torch.clamp_min(n_up, 1).to(torch.float32)
        # bits / (bw / n) is computed as (bits * n) / bw, as XLA rewrites
        # a quotient by a quotient.
        bw = trace_at(net_t + net.rtt_s)
        up = net.rtt_s + (net.pc_mbits * n_req) / bw
        down = net.rtt_s + (net.result_mbits * n_req) / bw

        # Cloud batcher: the round's requests chunked at max_batch, every
        # request done with the round's last chunk; with a G-GPU pool the
        # chunks spread round-robin over per-GPU queues from the pointer
        # rr, which persists across rounds.
        b_eff = torch.clamp_max(n_req, float(net.max_batch))
        n_chunks = torch.ceil(n_req * _recip(float(net.max_batch)))
        sent = n_up > 0
        # 1 + marginal * (b_eff - 1), and the arrival net_t + up with
        # net_t = t * dt, each one fused multiply-add on XLA's CPU.
        batch_cost = fp.fma(torch.full_like(b_eff, net.marginal), b_eff - 1,
                            torch.ones_like(b_eff))
        arrive = fp.fma(t_f, frame_dt, up)
        if net.n_gpus == 1:
            infer_b = n_chunks * net.infer_s * batch_cost
            # XLA fuses the two uses of the finish time apart: the pool's
            # clock takes the fused arrival, the round trip the arrival
            # rounded twice (and no multiply-add with -net_t below).
            done = torch.maximum(busy, net_t + up) + infer_b
            busy = torch.where(sent, torch.maximum(busy, arrive) + infer_b,
                               busy)
            roundtrip = (done - net_t) + down
        else:
            g_n = net.n_gpus
            chunk_s = net.infer_s * batch_cost
            n_chunks_i = n_chunks.to(torch.int32)
            g = torch.arange(g_n, dtype=torch.int32, device=busy.device)
            base = torch.div(n_chunks_i, g_n, rounding_mode="floor")
            extra = n_chunks_i - base * g_n
            n_g = (base + (torch.remainder(g - rr, g_n) < extra)
                   ).to(torch.float32)                           # (G,)
            start_g = torch.maximum(busy, arrive)
            done_g = start_g + n_g * chunk_s
            done = torch.where(n_g > 0, done_g, float("-inf")).amax()
            busy = torch.where((n_g > 0) & sent, done_g, busy)
            rr = torch.where(sent, torch.remainder(rr + n_chunks_i, g_n), rr)
            roundtrip = fp.fma(-t_f, frame_dt, done) + down

        n_assoc = packed[:, COL_N_ASSOC]
        n_new = torch.clamp_min(packed[:, COL_N_VALID] - n_assoc, 0.0)
        total = torch.clamp_min(n_assoc + n_new, 1.0)
        frac_new = n_new / total
        onboard = fp.fma(1.0 - frac_new, cs.ob_assoc,
                         fp.fma(frac_new, cs.ob_new, cs.ob_base))
        if self._ob_extra is not None:
            onboard = onboard + self._ob_extra
        anchor_latency = cs.edge_infer_s if self.onboard_anchors \
            else roundtrip
        latency = torch.where(is_anchor, anchor_latency, onboard)
        onboard = torch.where(is_anchor, 0.0, onboard)

        inflight_at = torch.where(test_arrived, float("inf"), inflight_at)
        inflight_at = torch.where(send_test, walls + roundtrip, inflight_at)
        walls = walls + torch.where(
            is_anchor, torch.clamp_min(latency, net.frame_dt), net.frame_dt)
        out = torch.cat([packed, latency[:, None], onboard[:, None]], dim=1)
        return ScanCarry(state, walls, inflight_at, busy, rr), out

    def run(self, state: FleetState, stacked: FrameInputs, n_frames: int
            ) -> tuple[FleetState, torch.Tensor]:
        """``n_frames`` frames from ``state`` over the stacked inputs
        ``(F, S, ...)`` (on the state's device) -> the final state and the
        ``(F, S, N_COLS + 2)`` rows, on the device."""
        if state.inflight_boxes.device.type == "cuda":
            return self._run_graph(state, stacked, n_frames)
        return self.run_eager(state, stacked, n_frames)

    def run_eager(self, state: FleetState, stacked: FrameInputs,
                  n_frames: int) -> tuple[FleetState, torch.Tensor]:
        """The body stepped frame by frame, on any device."""
        carry = self.init_carry(state)
        rows = []
        for f in range(n_frames):
            t = torch.full((), f, dtype=torch.int32,
                           device=state.inflight_boxes.device)
            carry, row = self.body(carry, t, FrameInputs(
                *(x[f] for x in stacked)))
            rows.append(row)
        return carry.state, torch.stack(rows)

    def _run_graph(self, state: FleetState, stacked: FrameInputs,
                   n_frames: int) -> tuple[FleetState, torch.Tensor]:
        graph = self.capture(state, stacked, n_frames)
        self.timing["replay_start"] = time.perf_counter()
        return graph.replay(stacked)

    def capture(self, state: FleetState, stacked: FrameInputs,
                n_frames: int) -> "ScanGraph":
        """Warm the body up on a side stream, on a copy of the carry from
        ``state`` (this loads the kernels, fills the cached constants and
        makes the library handles), then capture one frame of it in a CUDA
        graph over static buffers. Records ``timing`` and the kernel
        launches of the captured frame (``captured_launches``)."""
        from repro_torch import kernels
        dev = state.inflight_boxes.device
        carry = self.init_carry(state)
        static = _leaves(carry)
        t_buf = torch.zeros((), dtype=torch.int32, device=dev)
        inp_buf = FrameInputs(*(x[0].clone() for x in stacked))
        out = torch.zeros((n_frames, self.n_streams, N_COLS + 2),
                          dtype=torch.float32, device=dev)

        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.body(_rebuild(carry, [x.clone() for x in static]),
                      t_buf.clone(), inp_buf)
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()

        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            new, row = self.body(carry, t_buf, inp_buf)
            fresh = _leaves(new)
            # A new leaf that shares storage with another carry buffer is
            # copied first, so no buffer is overwritten before it is read.
            ptrs = {x.untyped_storage().data_ptr() for x in static}
            fresh = [y.clone() if y is not x and
                     y.untyped_storage().data_ptr() in ptrs else y
                     for x, y in zip(static, fresh)]
            for x, y in zip(static, fresh):
                if y is not x:
                    x.copy_(y)
            out.index_copy_(0, t_buf.reshape(1).long(), row[None])
            t_buf.add_(1)
        after = kernels.launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after}
        self.timing = dict(warmup_s=t1 - t0,
                           capture_s=time.perf_counter() - t1)
        return ScanGraph(graph, carry, static, t_buf, inp_buf, out)


class ScanGraph:
    """One frame of a fleet's scan body captured in a CUDA graph, with its
    static buffers: the carry, the frame index, the frame's inputs and the
    ``(F, S, N_COLS + 2)`` output."""

    def __init__(self, graph, carry: ScanCarry, static, t_buf, inp_buf,
                 out):
        self.graph, self.carry, self.static = graph, carry, static
        self.t_buf, self.inp_buf, self.out = t_buf, inp_buf, out
        self.initial = [x.clone() for x in static]

    def replay(self, stacked: FrameInputs) -> tuple[FleetState,
                                                    torch.Tensor]:
        """Run every frame from the initial carry: a device-to-device copy
        of frame t's inputs into the static inputs and a replay, with no
        host synchronisation (sync debug mode "error"). Returns the final
        state and the output rows, on the device (the caller fetches)."""
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            # PyTorch warns that the mode is a prototype.
            warnings.filterwarnings("ignore", "Synchronization debug mode")
            torch.cuda.set_sync_debug_mode("error")
        try:
            for x, y in zip(self.static, self.initial):
                x.copy_(y)
            self.t_buf.zero_()
            for f in range(self.out.shape[0]):
                for buf, src in zip(self.inp_buf, stacked):
                    buf.copy_(src[f])
                self.graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        return self.carry.state, self.out
