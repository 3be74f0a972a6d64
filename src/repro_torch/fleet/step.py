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
Scan mode (``make_fleet_scan``) and the stream mesh are not ported yet
(ROADMAP items 8 and 11).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.core import metrics, prng, scheduler, transform

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


StepFn = Callable[[FleetState, FrameInputs, torch.Tensor, int],
                  tuple[FleetState, torch.Tensor]]


def make_fleet_step(calib, params, sparams,
                    use_fos: bool = True) -> StepFn:
    """``(state, FrameInputs[S], test_arrived[S], t) -> (state, (S,
    N_COLS))``, with the calibration, the transform and scheduler
    parameters and the policy switch bound once. ``t`` is the frame index
    (a host int): without FOS, frame 0 is the anchor."""

    def fleet_step(state: FleetState, inp: FrameInputs,
                   test_arrived: torch.Tensor, t: int):
        s_n = test_arrived.shape[0]
        if use_fos:
            actions = scheduler.scheduler_pre(state.sched, sparams)
        else:
            actions = scheduler.SchedulerActions(
                send_test=torch.zeros_like(test_arrived),
                run_as_anchor=torch.full((s_n,), t == 0, dtype=torch.bool,
                                         device=test_arrived.device))
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
