"""Kalman-filter tracking in the 2D image plane (§3.2).

SORT-style [Bewley et al., ICIP'16] constant-velocity Kalman filter over the
observation ``z = [u, v, s, r]`` (box center, scale=area, aspect ratio) with
state ``x = [u, v, s, r, du, dv, ds]``. All tracks live in fixed slots with
an active mask, so predict/update run over the slot dimension at once.

Each track also carries the object's latest 3D box (size + heading), which
is what the 2D->3D transformation consumes as its per-object prior.

Port of ``repro/core/tracking.py``: ``jnp.linalg.solve`` becomes
``torch.linalg.solve_ex`` (no host sync for the singularity check), and
the ``.at[].max`` scatter of :func:`spawn` becomes
``scatter_reduce(..., "amax")``. Integer state is int64.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

STATE_DIM = 7
OBS_DIM = 4


class TrackerParams(NamedTuple):
    max_age: int = 3          # frames a track survives without a match
    min_area: float = 1.0


class TrackState(NamedTuple):
    x: torch.Tensor            # (T, 7) Kalman mean
    p: torch.Tensor            # (T, 7, 7) Kalman covariance
    active: torch.Tensor       # (T,) bool
    age: torch.Tensor          # (T,) frames since last match
    hits: torch.Tensor         # (T,) total matches
    track_id: torch.Tensor     # (T,) stable id (-1 if free)
    box3d: torch.Tensor        # (T, 7) latest 3D box for this object
    has_box3d: torch.Tensor    # (T,) bool
    next_id: torch.Tensor      # scalar


@functools.lru_cache(maxsize=None)
def _fh_matrices(dtype, device):
    """Constant transition F and observation H (built once per device:
    read-only, and no host-to-device copy per frame)."""
    f = torch.eye(STATE_DIM, dtype=dtype, device=device)
    f[0, 4] = f[1, 5] = f[2, 6] = 1.0
    h = torch.eye(OBS_DIM, STATE_DIM, dtype=dtype, device=device)
    return f, h


@functools.lru_cache(maxsize=None)
def _qr_matrices(dtype, device):
    """Constant process noise Q and observation noise R (read-only)."""
    q = torch.diag(torch.tensor([1, 1, 1, 1, 0.01, 0.01, 0.0001],
                                dtype=dtype)).to(device)
    r = torch.diag(torch.tensor([1, 1, 10, 10], dtype=dtype)).to(device)
    return q, r


def bbox_to_z(box: torch.Tensor) -> torch.Tensor:
    """[x1,y1,x2,y2] -> [u, v, s, r]."""
    w = (box[..., 2] - box[..., 0]).clamp_min(1e-3)
    h = (box[..., 3] - box[..., 1]).clamp_min(1e-3)
    u = box[..., 0] + w / 2
    v = box[..., 1] + h / 2
    return torch.stack([u, v, w * h, w / h], dim=-1)


def z_to_bbox(z: torch.Tensor) -> torch.Tensor:
    """[u, v, s, r] -> [x1,y1,x2,y2]."""
    s = z[..., 2].clamp_min(1e-3)
    r = z[..., 3].clamp_min(1e-3)
    w = torch.sqrt(s * r)
    h = s / w
    return torch.stack([z[..., 0] - w / 2, z[..., 1] - h / 2,
                        z[..., 0] + w / 2, z[..., 1] + h / 2], dim=-1)


def init_tracks(max_tracks: int, dtype=torch.float32,
                device=None) -> TrackState:
    eye = torch.eye(STATE_DIM, dtype=dtype, device=device)
    return TrackState(
        x=torch.zeros((max_tracks, STATE_DIM), dtype=dtype, device=device),
        p=(eye[None] * 10.0).repeat(max_tracks, 1, 1),
        active=torch.zeros((max_tracks,), dtype=torch.bool, device=device),
        age=torch.zeros((max_tracks,), dtype=torch.int64, device=device),
        hits=torch.zeros((max_tracks,), dtype=torch.int64, device=device),
        track_id=torch.full((max_tracks,), -1, dtype=torch.int64,
                            device=device),
        box3d=torch.zeros((max_tracks, 7), dtype=dtype, device=device),
        has_box3d=torch.zeros((max_tracks,), dtype=torch.bool, device=device),
        next_id=torch.zeros((), dtype=torch.int64, device=device),
    )


def predict(state: TrackState) -> tuple[TrackState, torch.Tensor]:
    """Kalman predict for all active slots. Returns predicted 2D boxes (T, 4)."""
    f, _ = _fh_matrices(state.x.dtype, state.x.device)
    q, _ = _qr_matrices(state.x.dtype, state.x.device)
    x = state.x @ f.T
    # Clamp scale velocity so area stays positive (SORT convention).
    neg = (x[:, 2] + x[:, 6]) <= 0
    x = torch.cat([x[:, :6], torch.where(neg, 0.0, x[:, 6])[:, None]], dim=1)
    p = f @ state.p @ f.T + q
    x = torch.where(state.active[:, None], x, state.x)
    p = torch.where(state.active[:, None, None], p, state.p)
    boxes = z_to_bbox(x[:, :4])
    return state._replace(x=x, p=p), boxes


def update(state: TrackState, track_to_det: torch.Tensor,
           det_boxes: torch.Tensor,
           params: TrackerParams = TrackerParams()) -> TrackState:
    """Kalman update with matched detections; age unmatched; kill stale.

    Args:
      track_to_det: (T,) detection index per track, -1 if unmatched.
      det_boxes: (D, 4) detections.
    """
    _, h = _fh_matrices(state.x.dtype, state.x.device)
    _, r = _qr_matrices(state.x.dtype, state.x.device)
    matched = (track_to_det >= 0) & state.active
    det_idx = track_to_det.clamp(0, det_boxes.shape[0] - 1)
    z = bbox_to_z(det_boxes[det_idx])  # (T, 4)
    x, p = state.x, state.p
    y = z - x @ h.T                                     # (T, 4)
    s = h @ p @ h.T + r                                 # (T, 4, 4)
    k = torch.linalg.solve_ex(s, h @ p)[0].transpose(1, 2)  # (T, 7, 4)
    x2 = x + (k @ y[..., None])[..., 0]
    eye = torch.eye(STATE_DIM, dtype=x.dtype, device=x.device)
    p2 = (eye - k @ h) @ p
    x = torch.where(matched[:, None], x2, state.x)
    p = torch.where(matched[:, None, None], p2, state.p)
    age = torch.where(matched, 0, state.age + 1)
    hits = torch.where(matched, state.hits + 1, state.hits)
    active = state.active & (age <= params.max_age)
    return state._replace(x=x, p=p, age=age, hits=hits, active=active)


def spawn(state: TrackState, det_boxes: torch.Tensor, det_valid: torch.Tensor,
          det_to_track: torch.Tensor) -> tuple[TrackState, torch.Tensor]:
    """Start new tracks for unmatched detections in free slots.

    Returns (state, det_to_track) where newly spawned detections now point at
    their new track slot.
    """
    t = state.x.shape[0]
    d = det_boxes.shape[0]
    dev = state.x.device
    free = ~state.active                                    # (T,)
    need = det_valid & (det_to_track < 0)                   # (D,)
    # Rank free slots and needy detections; pair them by rank.
    free_rank = torch.cumsum(free.long(), 0) - 1            # rank among free
    need_rank = torch.cumsum(need.long(), 0) - 1            # rank among needy
    # For each track slot: which detection (by rank) lands here?
    # slot with free_rank k takes the detection with need_rank k.
    det_rank_for_slot = torch.where(free, free_rank, -1)    # (T,)
    # Build rank -> det index map.
    capped_rank = need_rank.clamp(0, t - 1)
    arange_d = torch.arange(d, device=dev)
    rank_to_det = torch.full((t,), -1, dtype=torch.int64, device=dev)
    rank_to_det = rank_to_det.scatter_reduce(
        0, torch.where(need, capped_rank, t - 1),
        torch.where(need & (need_rank < t), arange_d, -1), "amax")
    take = torch.where(det_rank_for_slot >= 0,
                       rank_to_det[det_rank_for_slot.clamp(0, t - 1)], -1)
    spawning = (take >= 0) & free & (det_rank_for_slot < need.sum())
    z = bbox_to_z(det_boxes[take.clamp(0, d - 1)])
    x_new = torch.cat([z, torch.zeros_like(state.x[:, 4:])], dim=1)
    eye = torch.eye(STATE_DIM, dtype=state.x.dtype, device=dev)
    p_new = (eye[None] * 10.0).expand(t, STATE_DIM, STATE_DIM)
    ids_new = state.next_id + torch.cumsum(spawning.long(), 0) - 1
    x = torch.where(spawning[:, None], x_new, state.x)
    p = torch.where(spawning[:, None, None], p_new, state.p)
    active = state.active | spawning
    age = torch.where(spawning, 0, state.age)
    hits = torch.where(spawning, 1, state.hits)
    track_id = torch.where(spawning, ids_new, state.track_id)
    has_box3d = state.has_box3d & ~spawning
    next_id = state.next_id + spawning.sum()
    # Update det_to_track for spawned detections.
    onehot = (take[:, None] == arange_d[None, :]) & spawning[:, None]
    new_map = torch.where(onehot.any(dim=0),
                          onehot.to(torch.int8).argmax(dim=0), det_to_track)
    state = state._replace(x=x, p=p, active=active, age=age, hits=hits,
                           track_id=track_id, has_box3d=has_box3d,
                           next_id=next_id)
    return state, new_map


def set_box3d(state: TrackState, det_to_track: torch.Tensor,
              boxes3d: torch.Tensor, boxes_ok: torch.Tensor) -> TrackState:
    """Write per-detection 3D boxes back onto their tracks."""
    t = state.x.shape[0]
    arange_t = torch.arange(t, device=state.x.device)
    onehot = (det_to_track[:, None] == arange_t[None, :]) & \
        boxes_ok[:, None] & (det_to_track >= 0)[:, None]      # (D, T)
    has = onehot.any(dim=0)
    src = onehot.to(torch.int8).argmax(dim=0)                 # (T,)
    new_boxes = boxes3d[src]
    box3d = torch.where(has[:, None], new_boxes, state.box3d)
    has_box3d = state.has_box3d | has
    return state._replace(box3d=box3d, has_box3d=has_box3d)
