"""3D bounding box estimation from point clusters (§3.3, Eqs. 1-2, Fig. 9-10).

Given a purified point cluster and the RANSAC surface plane, estimate the
box seven-tuple [x, y, z, l, w, h, theta]:

* Associated objects reuse the previous frame's size; the heading is derived
  from the plane normal and the previous heading (Eq. 1, with the
  perpendicular side-surface case handled by a 90-degree rotation); the
  center is the surface center displaced by half the relevant extent along
  the inward direction (Eq. 2).
* New objects get the fleet-average size and a two-hypothesis disambiguation:
  build both candidate boxes and keep the one containing more cluster points
  (Fig. 10).

Port of ``repro/core/box_estimation.py``: every function takes a leading
object axis O in place of ``vmap``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import boxes as box_ops
from repro_torch.core import fp


class BoxEstParams(NamedTuple):
    xi_deg: float = 30.0       # paper §4: xi = 30 degrees
    # Heading-continuity clamp (paper §3.3: "physically impossible to change
    # its heading dramatically in one frame", 0.1 s in KITTI): when the
    # plane-derived heading of an *associated* object deviates from the
    # previous heading beyond this angle, keep the previous heading. This
    # suppresses diagonal corner-plane RANSAC fits.
    max_turn_deg: float = 20.0
    # Center estimation: "surface" = the paper's Eq. (2) (surface center +
    # half extent); "extent" = L-shape fit (visible near-face extremes in
    # the heading frame + half extents); "hybrid" = compute both candidates
    # and keep the box containing more cluster points. The paper's Eq. (2)
    # is the default.
    center_mode: str = "surface"


def _deg2rad(deg: float) -> np.float32:
    # jnp.deg2rad on a float32: x * float32(pi / 180), rounded in float32.
    return np.float32(deg) * np.float32(np.pi / 180)


def _unit(v: torch.Tensor) -> torch.Tensor:
    n = fp.norm(v)[..., None]
    return v / torch.where(n < 1e-9, 1.0, n)


def _rot90(v: torch.Tensor) -> torch.Tensor:
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp.dot(a, b)


def heading_from_normal(normal: torch.Tensor, prev_heading: torch.Tensor,
                        params: BoxEstParams = BoxEstParams()):
    """Eq. (1): derive the current heading vector from the surface normal.

    Args:
      normal: (..., 3) plane normal from RANSAC.
      prev_heading: (..., 2) unit heading of the associated box at t-1.

    Returns:
      (heading (..., 2), is_frontal bool (...)) — is_frontal means the found
      surface is the front/rear (normal ~ parallel to heading); otherwise it
      is a side surface (normal ~ perpendicular).
    """
    v = _unit(normal[..., :2])
    cosang = _dot(v, prev_heading).clamp(-1.0, 1.0)
    ang = torch.arccos(cosang)
    xi = _deg2rad(params.xi_deg)
    par_same = ang < float(xi)                     # v ~ h_{t-1}
    par_opp = ang > float(np.float32(np.pi) - xi)  # v ~ -h_{t-1}
    is_frontal = par_same | par_opp
    h_frontal = torch.where(par_same[..., None], v, -v)
    # Side surface: rotate the normal by 90 or 270 degrees, keeping the
    # candidate closest to the previous heading (continuity argument in the
    # paper: heading cannot flip within 0.1 s).
    c1 = _rot90(v)
    c2 = -c1
    h_side = torch.where((_dot(c1, prev_heading)
                          >= _dot(c2, prev_heading))[..., None], c1, c2)
    h = torch.where(is_frontal[..., None], h_frontal, h_side)
    return _unit(h), is_frontal


def center_from_surface(surface_center: torch.Tensor, heading: torch.Tensor,
                        is_frontal: torch.Tensor, size_lwh: torch.Tensor,
                        z_center: torch.Tensor) -> torch.Tensor:
    """Eq. (2): displace the surface center to the box center.

    The visible surface faces the sensor, so the center lies half an extent
    *away from the sensor* along the heading axis (frontal surface) or the
    lateral axis (side surface); the sign is resolved so the displacement
    points away from the origin.
    """
    ext = torch.where(is_frontal, size_lwh[..., 0], size_lwh[..., 1])
    axis = torch.where(is_frontal[..., None], heading, _rot90(heading))
    away = _unit(surface_center[..., :2])
    sgn = torch.where(_dot(axis, away) >= 0.0, 1.0, -1.0)
    cxy = surface_center[..., :2] + (0.5 * ext * sgn)[..., None] * axis
    return torch.cat([cxy, z_center[..., None]], dim=-1)


def center_from_extents(points_xy: torch.Tensor, mask: torch.Tensor,
                        heading: torch.Tensor, size_lw: torch.Tensor
                        ) -> torch.Tensor:
    """L-shape center fit: in the heading frame, the sensor sees the NEAR
    faces, so the near extreme of the cluster along each axis plus half the
    known extent locates the center. Falls back to the far extreme when the
    origin is beyond the far side. points_xy (O, P, 2), mask (O, P)."""
    u = heading
    v = _rot90(heading)

    def axis_center(axis_vec, extent):
        c = fp.dot(points_xy, axis_vec[..., None, :])          # (O, P)
        lo = torch.where(mask, c, 1e9).amin(dim=-1)
        hi = torch.where(mask, c, -1e9).amax(dim=-1)
        origin = 0.0  # sensor at the LiDAR origin
        near_is_lo = (lo - origin).abs() <= (hi - origin).abs()
        return torch.where(near_is_lo, lo + extent / 2, hi - extent / 2)

    cu = axis_center(u, size_lw[..., 0])
    cv = axis_center(v, size_lw[..., 1])
    return cu[..., None] * u + cv[..., None] * v


def estimate_boxes(points: torch.Tensor, inlier_masks: torch.Tensor,
                   cluster_masks: torch.Tensor, normals: torch.Tensor,
                   plane_ok: torch.Tensor, associated: torch.Tensor,
                   prev_boxes: torch.Tensor, avg_size: torch.Tensor,
                   params: BoxEstParams = BoxEstParams()):
    """Estimate each object's box (leading O axis).

    Args:
      points: (O, P, 3) cluster buffers; inlier_masks, cluster_masks (O, P);
      normals (O, 3); plane_ok, associated (O,); prev_boxes (O, 7) (undefined
      where not associated); avg_size (3,) fleet average (l, w, h).

    Returns (boxes (O, 7), have_points (O,) bool).
    """
    pts = points
    cm = cluster_masks
    im = inlier_masks & cm
    n_in = im.sum(dim=1).clamp_min(1)
    n_cl = cm.sum(dim=1).clamp_min(1)

    surface_center = torch.where(im[..., None], pts, 0.0).sum(dim=1) \
        / n_in[:, None]
    zmin = torch.where(cm, pts[..., 2], 1e9).amin(dim=1)

    # --- associated path -------------------------------------------------
    prev_h = box_ops.heading_vector(prev_boxes[:, 6])
    size_assoc = prev_boxes[:, 3:6]
    h_assoc, is_frontal = heading_from_normal(normals, prev_h, params)
    # Heading-continuity clamp (see BoxEstParams.max_turn_deg).
    turn_cos = _dot(h_assoc, prev_h).clamp(-1.0, 1.0)
    max_cos = torch.cos(torch.tensor(_deg2rad(params.max_turn_deg)))
    too_sharp = turn_cos < float(max_cos)
    h_assoc = torch.where(too_sharp[:, None], prev_h, h_assoc)
    z_assoc = zmin + size_assoc[:, 2] / 2
    th_assoc = torch.arctan2(h_assoc[:, 1], h_assoc[:, 0])

    def boxify(cxy):
        return torch.cat([cxy, z_assoc[:, None], size_assoc,
                          th_assoc[:, None]], dim=1)

    def n_inside(box):
        return (box_ops.points_in_box_3d(pts, box) & cm).sum(dim=1)

    c_surface = center_from_surface(surface_center, h_assoc, is_frontal,
                                    size_assoc, z_assoc)[:, :2]
    if params.center_mode == "surface":
        box_assoc = boxify(c_surface)
    else:
        c_extent = center_from_extents(pts[..., :2], cm, h_assoc,
                                       size_assoc[:, :2])
        if params.center_mode == "extent":
            box_assoc = boxify(c_extent)
        else:  # hybrid: the candidate containing more cluster points wins.
            box_s = boxify(c_surface)
            box_e = boxify(c_extent)
            box_assoc = torch.where((n_inside(box_s) >= n_inside(box_e))
                                    [:, None], box_s, box_e)

    # --- new-object path (Fig. 10) ---------------------------------------
    o = pts.shape[0]
    size_new = avg_size.expand(o, 3)
    v = _unit(normals[:, :2])
    z_new = zmin + size_new[:, 2] / 2

    def new_center(heading, frontal):
        c_s = center_from_surface(surface_center, heading, frontal,
                                  size_new, z_new)
        if params.center_mode == "surface":
            return c_s
        c_e = torch.cat([center_from_extents(pts[..., :2], cm, heading,
                                             size_new[:, :2]),
                         z_new[:, None]], dim=1)
        if params.center_mode == "extent":
            return c_e
        th = torch.arctan2(heading[:, 1], heading[:, 0])[:, None]
        box_s = torch.cat([c_s, size_new, th], dim=1)
        box_e = torch.cat([c_e, size_new, th], dim=1)
        return torch.where((n_inside(box_s) >= n_inside(box_e))[:, None],
                           c_s, c_e)

    true_o = torch.ones((o,), dtype=torch.bool, device=pts.device)
    # Hypothesis A: surface is frontal (normal ~ heading).
    ha = v
    ca = new_center(ha, true_o)
    box_a = torch.cat([ca, size_new,
                       torch.arctan2(ha[:, 1], ha[:, 0])[:, None]], dim=1)
    # Hypothesis B: surface is lateral (heading = normal rotated 90 deg).
    hb = _rot90(v)
    cb = new_center(hb, ~true_o)
    box_b = torch.cat([cb, size_new,
                       torch.arctan2(hb[:, 1], hb[:, 0])[:, None]], dim=1)
    box_new = torch.where((n_inside(box_a) >= n_inside(box_b))[:, None],
                          box_a, box_b)

    box = torch.where(associated[:, None], box_assoc, box_new)
    ok = plane_ok & (cm.sum(dim=1) >= 3)
    # Fallback for clusters without a usable plane: centroid box with average
    # (or previous) size and previous (or zero) heading.
    centroid = torch.where(cm[..., None], pts, 0.0).sum(dim=1) / n_cl[:, None]
    fb_size = torch.where(associated[:, None], size_assoc, size_new)
    fb_th = torch.where(associated, prev_boxes[:, 6], 0.0)
    fb_z = zmin + fb_size[:, 2] / 2
    fallback = torch.cat([centroid[:, :2], fb_z[:, None], fb_size,
                          fb_th[:, None]], dim=1)
    box = torch.where(ok[:, None], box, fallback)
    have_pts = cm.sum(dim=1) > 0
    return box, have_pts


class EstimateInputs(NamedTuple):
    points: torch.Tensor        # (P, 3) cluster buffer
    inlier_mask: torch.Tensor   # (P,) RANSAC surface inliers
    cluster_mask: torch.Tensor  # (P,) filtered cluster membership
    normal: torch.Tensor        # (3,) RANSAC plane normal
    plane_ok: torch.Tensor      # bool
    associated: torch.Tensor    # bool: has a previous-frame box
    prev_box: torch.Tensor      # (7,) previous box (undefined if new)
    avg_size: torch.Tensor      # (3,) fleet average (l, w, h)


def estimate_box(inp: EstimateInputs,
                 params: BoxEstParams = BoxEstParams()):
    """Estimate one object's box. Returns (box (7,), ok bool)."""
    box, ok = estimate_boxes(
        inp.points[None], inp.inlier_mask[None], inp.cluster_mask[None],
        inp.normal[None], inp.plane_ok.reshape(1), inp.associated.reshape(1),
        inp.prev_box[None], inp.avg_size, params)
    return box[0], ok[0]
