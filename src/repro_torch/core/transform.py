"""The full per-frame 2D->3D transformation pipeline (§3.1 workflow).

Two entry points:

* :func:`anchor_step` — "Preparation": ingest cloud 3D detections for an
  anchor frame, project them to 2D to (re)seed the tracker, and refresh the
  fleet-average object size.
* :func:`transform_step` — "Transformation": run tracking-based association
  on the current 2D detections, project the point cloud into the masks,
  filter each cluster (Algorithm 1), RANSAC the visible surface and estimate
  3D boxes (Eqs. 1-2), then write results back onto the tracks for the next
  frame.

Port of ``repro/core/transform.py``. ``TransformParams`` drops the JAX
package's ``backend`` field: the port dispatches each hot op by the device
of its tensors (``repro_torch.ops``), so there is nothing to select. The
state's ``key`` is a (2,) threefry key of the port's generator
(``repro_torch.core.prng``), the same words as ``jax.random.key_data``.

Both steps take a leading stream axis on the state and the frame (a
fleet), as ``jax.vmap`` gave them in JAX: the objects of all streams go
through filtration, RANSAC (one ``ransac_score`` launch) and box
estimation together, and each stream keeps its own key.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

from repro_torch.core import association, box_estimation, boxes as box_ops
from repro_torch.core import filtration, prng, projection, ransac, tracking
from repro_torch.core.batching import select, take


class TransformParams(NamedTuple):
    filtration: filtration.FiltrationParams = filtration.FiltrationParams()
    ransac: ransac.RansacParams = ransac.RansacParams()
    boxest: box_estimation.BoxEstParams = box_estimation.BoxEstParams()
    tracker: tracking.TrackerParams = tracking.TrackerParams()
    iou_assoc: float = 0.3        # association criterion (paper: 0.3)
    pts_per_obj: int = 256        # cluster buffer size
    use_tba: bool = True          # tracking-based association on/off (Table 4)


class MobyState(NamedTuple):
    tracks: tracking.TrackState
    avg_size: torch.Tensor       # (..., 3) running average size (l, w, h)
    key: torch.Tensor            # (..., 2) threefry key words


def init_state(max_tracks: int, key: torch.Tensor,
               avg_size: Sequence[float] = (4.0, 1.7, 1.6)) -> MobyState:
    """Default avg size ~ KITTI car mean (l, w, h). The state lives on the
    key's device; keys (S, 2) give S streams' states stacked."""
    dev = key.device
    one = MobyState(tracks=tracking.init_tracks(max_tracks, device=dev),
                    avg_size=torch.tensor(avg_size, dtype=torch.float32,
                                          device=dev),
                    key=key[(0,) * (key.dim() - 1)])
    batch = key.shape[:-1]

    def stack(x):
        return x.expand(*batch, *x.shape).clone() if batch else x
    return MobyState(tracks=tracking.TrackState(*map(stack, one.tracks)),
                     avg_size=stack(one.avg_size), key=key)


class FrameOutput(NamedTuple):
    boxes3d: torch.Tensor        # (..., D, 7)
    valid: torch.Tensor          # (..., D)
    det_to_track: torch.Tensor   # (..., D)
    track_boxes2d: torch.Tensor  # (..., T, 4) predicted boxes (diagnostics)


def anchor_step(state: MobyState, boxes3d: torch.Tensor, valid: torch.Tensor,
                calib: projection.Calibration,
                params: TransformParams = TransformParams()
                ) -> tuple[MobyState, FrameOutput]:
    """Ingest cloud 3D detections at an anchor frame (steps 1-2 in Fig. 4)."""
    boxes2d = box_ops.project_box3d_to_2d(boxes3d, calib.tr, calib.p)
    tracks, pred2d = tracking.predict(state.tracks)
    t2d, d2t, _ = association.associate(pred2d, tracks.active, boxes2d, valid,
                                        params.iou_assoc)
    tracks = tracking.update(tracks, t2d, boxes2d, params.tracker)
    tracks, d2t = tracking.spawn(tracks, boxes2d, valid, d2t)
    tracks = tracking.set_box3d(tracks, d2t, boxes3d, valid)
    # Refresh fleet-average size from the (trusted) anchor results.
    n_valid = valid.sum(-1)[..., None]
    mean_size = torch.where(valid[..., None], boxes3d[..., 3:6], 0.0) \
        .sum(dim=-2) / n_valid.clamp_min(1)
    avg_size = torch.where(n_valid > 0, mean_size, state.avg_size)
    out = FrameOutput(boxes3d=boxes3d, valid=valid, det_to_track=d2t,
                      track_boxes2d=pred2d)
    return MobyState(tracks=tracks, avg_size=avg_size, key=state.key), out


def transform_step(state: MobyState, points: torch.Tensor,
                   det_boxes2d: torch.Tensor, det_valid: torch.Tensor,
                   label_img: torch.Tensor, calib: projection.Calibration,
                   params: TransformParams = TransformParams()
                   ) -> tuple[MobyState, FrameOutput]:
    """Transform one non-anchor frame (steps 3-4 in Fig. 4).

    Args (any leading stream dims, the same on the state and the frame):
      state: Moby per-stream state.
      points: (..., N, 3) LiDAR points.
      det_boxes2d: (..., D, 4) 2D detections [x1,y1,x2,y2].
      det_valid: (..., D) mask.
      label_img: (..., H, W) int32 instance-id image; id i+1 = detection
        slot i.
      calib: sensor calibration.
    """
    d = det_boxes2d.shape[-2]
    batch = det_boxes2d.shape[:-2]
    keys = prng.split(state.key)
    key, sub = keys[..., 0, :], keys[..., 1, :]

    # --- tracking-based association (§3.2) --------------------------------
    tracks, pred2d = tracking.predict(state.tracks)
    if params.use_tba:
        t2d, d2t, _ = association.associate(pred2d, tracks.active, det_boxes2d,
                                            det_valid, params.iou_assoc)
        tracks = tracking.update(tracks, t2d, det_boxes2d, params.tracker)
        tracks, d2t = tracking.spawn(tracks, det_boxes2d, det_valid, d2t)
    else:
        # Ablation (Table 4, TRS-only): no association — every detection is
        # treated as a new object.
        d2t = torch.full((*batch, d), -1, dtype=torch.int64,
                         device=points.device)

    # --- point projection (§3.3) ------------------------------------------
    # Fused project + visibility + flat-index + label gather (one kernel).
    labels = projection.project_and_label(points, label_img, calib)
    clusters, cvalid, _ = projection.build_clusters(points, labels, d,
                                                    params.pts_per_obj)

    # --- point filtration (Algorithm 1) ------------------------------------
    # Associated objects carry a center prior from the previous 3D box.
    t_idx = d2t.clamp(0, state.tracks.x.shape[-2] - 1)
    associated = (d2t >= 0) & take(tracks.has_box3d, t_idx)
    prev_boxes = take(tracks.box3d, t_idx, 1)
    # Filtration and box estimation run over the objects of every stream
    # at once: (..., D) folds into one object axis.
    p = params.pts_per_obj
    keep = filtration.filter_clusters(
        clusters.reshape(-1, p, 3), cvalid.reshape(-1, p), params.filtration,
        prev_boxes[..., :3].reshape(-1, 3), associated.reshape(-1)
    ).reshape(cvalid.shape)

    # --- RANSAC surface fitting --------------------------------------------
    fit = ransac.ransac_planes(sub, clusters, keep, params.ransac)

    # --- 3D box estimation (Eqs. 1-2, Fig. 10) ------------------------------
    boxes3d, ok = box_estimation.estimate_boxes(
        clusters.reshape(-1, p, 3), fit.inliers.reshape(-1, p),
        keep.reshape(-1, p), fit.normal.reshape(-1, 3), fit.ok.reshape(-1),
        associated.reshape(-1), prev_boxes.reshape(-1, 7),
        state.avg_size[..., None, :].expand(*batch, d, 3).reshape(-1, 3),
        params.boxest)
    boxes3d = boxes3d.reshape(*batch, d, 7)
    valid = ok.reshape(*batch, d) & det_valid

    # --- write back for the next frame --------------------------------------
    if params.use_tba:
        tracks = tracking.set_box3d(tracks, d2t, boxes3d, valid)

    out = FrameOutput(boxes3d=boxes3d, valid=valid, det_to_track=d2t,
                      track_boxes2d=pred2d)
    return MobyState(tracks=tracks, avg_size=state.avg_size, key=key), out


def fused_step(state: MobyState, points: torch.Tensor,
               det_boxes2d: torch.Tensor, det_valid: torch.Tensor,
               label_img: torch.Tensor, cloud_boxes3d: torch.Tensor,
               cloud_valid: torch.Tensor,
               is_anchor: Union[bool, torch.Tensor],
               calib: projection.Calibration,
               params: TransformParams = TransformParams()
               ) -> tuple[MobyState, FrameOutput]:
    """One frame with its treatment chosen by ``is_anchor``.

    A host bool (one stream, ``MobyEngine``) makes the JAX version's
    ``lax.cond`` a Python branch. A bool tensor of the streams' shape (a
    fleet) computes both branches for every stream and selects each state
    leaf and output with it, as ``jax.vmap`` of ``lax.cond`` does: an
    anchor stream keeps its key, a transform stream advances it.
    """
    if isinstance(is_anchor, bool):
        if is_anchor:
            return anchor_step(state, cloud_boxes3d, cloud_valid, calib,
                               params)
        return transform_step(state, points, det_boxes2d, det_valid,
                              label_img, calib, params)
    a = anchor_step(state, cloud_boxes3d, cloud_valid, calib, params)
    t = transform_step(state, points, det_boxes2d, det_valid, label_img,
                       calib, params)
    return select(is_anchor, a[0], t[0]), select(is_anchor, a[1], t[1])
