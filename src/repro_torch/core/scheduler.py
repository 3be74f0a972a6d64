"""Frame offloading scheduler (§3.4) with pluggable policies.

The paper's FOS policy: every ``N_T`` frames a *test frame* is offloaded to
the cloud detector in parallel with on-device processing. When the cloud
result returns, the transformation output buffered for that frame is scored
against it (3D-IoU F1, the cloud result acting as ground truth). If the
score drops below ``Q_T``, the next frame becomes an *anchor frame*:
processing blocks on the cloud 3D result, which then reseeds the
transformation.

Port of ``repro/core/scheduler.py``. The state is a NamedTuple of 0-dim
tensors on the engine's device, or of (S,)-leading ones for a fleet
(:func:`init_scheduler_fleet`; every policy takes either); :func:`scheduler_pre` /
:func:`scheduler_post` dispatch through a registry keyed by
``SchedulerParams.policy``. Registered policies:

* ``fos``            — the paper's test-frame feedback loop (default);
* ``periodic(k)``    — anchor every k frames, no test traffic;
* ``always_anchor``  — every frame offloaded as an anchor;
* ``never_anchor``   — anchor frame 0 only, then pure on-device
  transformation;
* ``adaptive``       — anchors when the predicted accuracy drift exceeds an
  error budget scaled by how expensive offloading currently is, and adapts
  its test cadence to the drift level.
"""
from __future__ import annotations

import functools
import re
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core import metrics


class SchedulerParams(NamedTuple):
    n_t: int = 4          # test-frame period (paper §4)
    q_t: float = 0.7      # accuracy threshold (paper §4)
    iou_thresh: float = 0.4
    # Policy slot: a registered policy name ("fos", "periodic(8)", ...).
    policy: str = "fos"


class SchedulerState(NamedTuple):
    frames_since_test: torch.Tensor   # int64
    test_inflight: torch.Tensor       # bool
    buf_boxes: torch.Tensor           # (D, 7) our output on the test frame
    buf_valid: torch.Tensor           # (D,)
    anchor_pending: torch.Tensor      # bool: next frame must be an anchor
    last_error: torch.Tensor          # float: 1 - F1 of last test comparison
    tests_sent: torch.Tensor          # int64 counters (diagnostics)
    anchors_triggered: torch.Tensor
    # -- running telemetry (adaptive-policy inputs) ---------------------
    err_ewma: torch.Tensor            # float32 EWMA of observed test error
    frames_since_anchor: torch.Tensor  # int64
    bw_mbps: torch.Tensor             # float32 observed uplink bandwidth
    edge_cost_s: torch.Tensor         # float32 modeled on-device frame cost
    offload_cost_s: torch.Tensor      # float32 modeled anchor offload cost


class SchedulerActions(NamedTuple):
    send_test: torch.Tensor       # bool: offload this frame as a test frame
    run_as_anchor: torch.Tensor   # bool: this frame is an anchor frame


class SchedulerPolicy(NamedTuple):
    """A frame-treatment policy: ``pre`` decides this frame's actions from
    the state, ``post`` advances the state machine after the frame.
    ``uses_tests`` declares whether the policy offloads test frames — the
    engines charge the per-frame FOS scoring cost (ComponentTimes.fos)
    only when it does."""
    name: str
    pre: Callable[[SchedulerState, SchedulerParams], SchedulerActions]
    post: Callable[..., SchedulerState]
    uses_tests: bool = True


def init_scheduler(max_obj: int, device=None) -> SchedulerState:
    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    def b(v):
        return torch.tensor(v, dtype=torch.bool, device=device)

    return SchedulerState(
        frames_since_test=i64(0),
        test_inflight=b(False),
        buf_boxes=torch.zeros((max_obj, 7), dtype=torch.float32,
                              device=device),
        buf_valid=torch.zeros((max_obj,), dtype=torch.bool, device=device),
        anchor_pending=b(True),   # frame 0 is always an anchor
        last_error=f32(0.0),
        tests_sent=i64(0),
        anchors_triggered=i64(0),
        err_ewma=f32(0.0),
        frames_since_anchor=i64(0),
        bw_mbps=f32(0.0),         # 0 = not yet observed
        edge_cost_s=f32(0.0),
        offload_cost_s=f32(0.0),
    )


def init_scheduler_fleet(n_streams: int, max_obj: int,
                         device=None) -> SchedulerState:
    """Batched scheduler state: one independent state machine per stream,
    stacked on a leading stream axis. Every policy's ``pre`` and ``post``
    advance all streams at once on it (the fleet engine)."""
    one = init_scheduler(max_obj, device=device)
    return SchedulerState(*(x.expand(n_streams, *x.shape).clone()
                            for x in one))


def observe_telemetry(state: SchedulerState, bw_mbps=None, edge_cost_s=None,
                      offload_cost_s=None) -> SchedulerState:
    """Fold externally observed telemetry into the state: the uplink
    bandwidth the netsim currently delivers and the modeled per-frame
    edge/offload costs from the active device profile. Engines call it
    once per frame before :func:`scheduler_pre`."""
    upd = {}
    for name, v in (("bw_mbps", bw_mbps), ("edge_cost_s", edge_cost_s),
                    ("offload_cost_s", offload_cost_s)):
        if v is None:
            continue
        cur = getattr(state, name)
        if isinstance(v, (int, float)):
            # A fill on the device: no host-to-device copy per frame.
            upd[name] = torch.full_like(cur, float(v))
        else:
            upd[name] = torch.as_tensor(v, dtype=torch.float32).to(
                cur.device).expand(cur.shape)
    return state._replace(**upd) if upd else state


def decision_telemetry(state: SchedulerState) -> torch.Tensor:
    """The state-resident policy inputs an audit row needs, packed into
    ONE small tensor — ``[err_ewma, frames_since_anchor]`` — so an audit
    costs a single extra fetch per frame."""
    return torch.stack([state.err_ewma,
                        state.frames_since_anchor.to(torch.float32)])


# ---------------------------------------------------------------------------
# Policy registry
# ---------------------------------------------------------------------------

# base name -> factory(arg: Optional[int]) -> SchedulerPolicy
_POLICIES: Dict[str, Callable[[Optional[int]], SchedulerPolicy]] = {}

_PARAM_RE = re.compile(r"^([a-z_]+)\((\d+)\)$")


def register_policy(name: str,
                    factory: Callable[[Optional[int]], SchedulerPolicy]
                    ) -> None:
    """Register a policy under a base name. ``factory`` receives the
    optional integer argument of a parameterized spelling (``"name(k)"``),
    or None for the bare name. Re-registration takes effect immediately
    (the resolution cache is dropped)."""
    _POLICIES[name] = factory
    get_policy.cache_clear()


def list_policies() -> list[str]:
    return sorted(_POLICIES)


@functools.lru_cache(maxsize=None)
def get_policy(name: str) -> SchedulerPolicy:
    """Resolve a policy name — ``"fos"``, ``"periodic(8)"``, ... — to its
    registered :class:`SchedulerPolicy`. Raises KeyError naming the
    registered policies on an unknown name."""
    base, arg = name, None
    m = _PARAM_RE.match(name)
    if m:
        base, arg = m.group(1), int(m.group(2))
    if base not in _POLICIES:
        raise KeyError(
            f"unknown scheduler policy {name!r}; registered policies: "
            f"{list_policies()} (parameterized form: 'periodic(k)')")
    return _POLICIES[base](arg)


def scheduler_pre(state: SchedulerState,
                  params: SchedulerParams = SchedulerParams()
                  ) -> SchedulerActions:
    """Decide this frame's treatment before processing it."""
    return get_policy(params.policy).pre(state, params)


def scheduler_post(state: SchedulerState, actions: SchedulerActions,
                   out_boxes: torch.Tensor, out_valid: torch.Tensor,
                   test_arrived: torch.Tensor, test_boxes: torch.Tensor,
                   test_valid: torch.Tensor,
                   params: SchedulerParams = SchedulerParams()
                   ) -> SchedulerState:
    """Advance the state machine after processing a frame.

    Args:
      out_boxes/out_valid: this frame's transformation output (buffered when
        this frame was sent as a test frame).
      test_arrived: bool — the cloud result for the in-flight test frame
        arrived during this frame.
      test_boxes/test_valid: the cloud 3D detections for that test frame.
    """
    return get_policy(params.policy).post(
        state, actions, out_boxes, out_valid, test_arrived, test_boxes,
        test_valid, params)


# ---------------------------------------------------------------------------
# Built-in policies
# ---------------------------------------------------------------------------

# Telemetry smoothing for the test-error EWMA (maintained by the shared
# fos/adaptive post step).
EWMA_ALPHA = 0.5


def _fos_pre(state: SchedulerState,
             params: SchedulerParams) -> SchedulerActions:
    run_as_anchor = state.anchor_pending
    due = state.frames_since_test >= params.n_t - 1
    send_test = (~run_as_anchor) & due & (~state.test_inflight)
    return SchedulerActions(send_test=send_test, run_as_anchor=run_as_anchor)


def _fos_post(state: SchedulerState, actions: SchedulerActions,
              out_boxes: torch.Tensor, out_valid: torch.Tensor,
              test_arrived: torch.Tensor, test_boxes: torch.Tensor,
              test_valid: torch.Tensor,
              params: SchedulerParams) -> SchedulerState:
    # Buffer our own output when this frame is offloaded as a test.
    buf_boxes = torch.where(actions.send_test[..., None, None], out_boxes,
                            state.buf_boxes)
    buf_valid = torch.where(actions.send_test[..., None], out_valid,
                            state.buf_valid)

    # Score the returned test frame against our buffered output.
    f1, _, _ = metrics.f1_score(buf_boxes, buf_valid, test_boxes, test_valid,
                                params.iou_thresh)
    got = state.test_inflight & test_arrived
    error = torch.where(got, 1.0 - f1, state.last_error)
    bad = got & (f1 < params.q_t)

    anchor_pending = torch.where(actions.run_as_anchor, False,
                                 state.anchor_pending) | bad
    test_inflight = (state.test_inflight & ~test_arrived) | actions.send_test
    frames_since_test = torch.where(actions.send_test | actions.run_as_anchor,
                                    0, state.frames_since_test + 1)
    # Telemetry: smooth each observed test error into the EWMA; an anchor
    # resets the drift clock *and* the drift estimate.
    ewma = torch.where(got, (1 - EWMA_ALPHA) * state.err_ewma
                       + EWMA_ALPHA * (1.0 - f1), state.err_ewma)
    ewma = torch.where(actions.run_as_anchor, 0.0, ewma)
    return state._replace(
        frames_since_test=frames_since_test,
        test_inflight=test_inflight,
        buf_boxes=buf_boxes,
        buf_valid=buf_valid,
        anchor_pending=anchor_pending,
        last_error=error,
        tests_sent=state.tests_sent + actions.send_test.long(),
        anchors_triggered=state.anchors_triggered + bad.long(),
        err_ewma=ewma,
        frames_since_anchor=torch.where(actions.run_as_anchor, 0,
                                        state.frames_since_anchor + 1),
    )


def _anchor_only_post(state: SchedulerState, actions: SchedulerActions,
                      out_boxes, out_valid, test_arrived, test_boxes,
                      test_valid, params: SchedulerParams) -> SchedulerState:
    """Shared post for the test-free policies: clear the pending flag,
    count frames/anchors, leave the test machinery untouched."""
    anchored = actions.run_as_anchor
    return state._replace(
        frames_since_test=torch.where(anchored, 0,
                                      state.frames_since_test + 1),
        anchor_pending=torch.where(anchored, False, state.anchor_pending),
        anchors_triggered=state.anchors_triggered + anchored.long(),
        frames_since_anchor=torch.where(anchored, 0,
                                        state.frames_since_anchor + 1),
    )


def _no_test(state: SchedulerState) -> torch.Tensor:
    return torch.zeros_like(state.anchor_pending)


def _make_fos(arg: Optional[int]) -> SchedulerPolicy:
    if arg is not None:
        raise KeyError("policy 'fos' takes no argument; tune "
                       "SchedulerParams.n_t / q_t instead")
    return SchedulerPolicy("fos", _fos_pre, _fos_post)


def _make_periodic(arg: Optional[int]) -> SchedulerPolicy:
    k = 4 if arg is None else arg
    if k < 1:
        raise KeyError(f"periodic({k}): period must be >= 1")

    def pre(state: SchedulerState,
            params: SchedulerParams) -> SchedulerActions:
        due = state.frames_since_test >= k - 1
        return SchedulerActions(send_test=_no_test(state),
                                run_as_anchor=state.anchor_pending | due)

    return SchedulerPolicy(f"periodic({k})", pre, _anchor_only_post,
                           uses_tests=False)


def _make_always_anchor(arg: Optional[int]) -> SchedulerPolicy:
    def pre(state: SchedulerState,
            params: SchedulerParams) -> SchedulerActions:
        return SchedulerActions(
            send_test=_no_test(state),
            run_as_anchor=torch.ones_like(state.anchor_pending))

    return SchedulerPolicy("always_anchor", pre, _anchor_only_post,
                           uses_tests=False)


def _make_never_anchor(arg: Optional[int]) -> SchedulerPolicy:
    def pre(state: SchedulerState,
            params: SchedulerParams) -> SchedulerActions:
        return SchedulerActions(send_test=_no_test(state),
                                run_as_anchor=state.anchor_pending)

    return SchedulerPolicy("never_anchor", pre, _anchor_only_post,
                           uses_tests=False)


# Adaptive-policy constants (hand-tuned on the synthetic scenes):
# per-frame growth of the predicted drift since the last anchor;
DRIFT_GROWTH = 0.15
# error budget = (1 - q_t) * (BUDGET_BASE + BUDGET_COST * rel_offload);
BUDGET_BASE = 0.2
BUDGET_COST = 0.3
# test period swings between PERIOD_MAX * n_t (calm) and
# PERIOD_MIN * n_t (predicted drift at the budget).
PERIOD_MAX = 2.0
PERIOD_MIN = 1.0


def _adaptive_pre(state: SchedulerState,
                  params: SchedulerParams) -> SchedulerActions:
    """Cost/drift trade-off (Panopticus-style execution scheduling): anchor
    when the *predicted* accuracy drift exceeds an error budget scaled by
    the current offload cost; the test cadence adapts the same way."""
    pred_err = state.err_ewma * (
        1.0 + DRIFT_GROWTH * state.frames_since_anchor.to(torch.float32))
    edge = state.edge_cost_s.clamp_min(1e-4)
    off = state.offload_cost_s
    # Relative offload cost in (0, 1); 0.5 (neutral) until telemetry flows.
    rel = torch.where(off > 0, off / (off + edge), 0.5)
    budget = (1.0 - params.q_t) * (BUDGET_BASE + BUDGET_COST * rel)
    run_as_anchor = state.anchor_pending | (pred_err > budget)
    err_ratio = (pred_err / budget.clamp_min(1e-6)).clamp(0.0, 1.0)
    period = torch.round(params.n_t * (
        PERIOD_MAX - (PERIOD_MAX - PERIOD_MIN) * err_ratio)).clamp_min(1.0)
    due = state.frames_since_test.to(torch.float32) >= period - 1.0
    send_test = (~run_as_anchor) & due & (~state.test_inflight)
    return SchedulerActions(send_test=send_test, run_as_anchor=run_as_anchor)


def _make_adaptive(arg: Optional[int]) -> SchedulerPolicy:
    if arg is not None:
        raise KeyError("policy 'adaptive' takes no argument; tune "
                       "SchedulerParams.n_t / q_t instead")
    # Shares the fos post step: test buffering/scoring plus the telemetry
    # (err_ewma, frames_since_anchor) both policies maintain.
    return SchedulerPolicy("adaptive", _adaptive_pre, _fos_post)


register_policy("fos", _make_fos)
register_policy("periodic", _make_periodic)
register_policy("always_anchor", _make_always_anchor)
register_policy("never_anchor", _make_never_anchor)
register_policy("adaptive", _make_adaptive)
