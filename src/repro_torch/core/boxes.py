"""Box geometry: parameterization, corners, rotated-BEV 3D IoU.

A 3D box is the paper's seven-tuple ``[x, y, z, l, w, h, theta]`` in LiDAR
coordinates (x forward, y left, z up): center ``(x, y, z)``, size
``(l, w, h)`` (length along heading, width across, height up), heading
``theta`` measured from the +x axis in the x-y plane.

Port of ``repro/core/boxes.py``. Every function takes leading batch
dimensions in place of ``vmap``. The rotated-rectangle intersection is
Sutherland-Hodgman clipping into fixed 16-vertex buffers, batched over box
pairs: within one clip edge every vertex's emit decisions depend only on
the input polygon, so the sequential emit loop of the JAX version
(``fori_loop`` at ``boxes.py:96``) becomes a prefix sum of emit counts and
one scatter — the same output vertices in the same slots.
"""
from __future__ import annotations

import torch

from repro_torch import ops

# Maximum vertices for the clipped polygon buffer. The intersection of two
# convex quadrilaterals has at most 8 vertices; 16 leaves headroom for the
# interleaved emit pattern.
_MAX_VERTS = 16


def corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """BEV (x-y) corners of boxes ``(..., 7) -> (..., 4, 2)`` in CCW order."""
    x, y = boxes[..., 0], boxes[..., 1]
    l, w = boxes[..., 3], boxes[..., 4]
    th = boxes[..., 6]
    c, s = torch.cos(th), torch.sin(th)
    # Local corner offsets (CCW): (+l/2,+w/2), (-l/2,+w/2), (-l/2,-w/2), (+l/2,-w/2)
    dx = torch.stack([l / 2, -l / 2, -l / 2, l / 2], dim=-1)
    dy = torch.stack([w / 2, w / 2, -w / 2, -w / 2], dim=-1)
    cx = x[..., None] + dx * c[..., None] - dy * s[..., None]
    cy = y[..., None] + dx * s[..., None] + dy * c[..., None]
    return torch.stack([cx, cy], dim=-1)


def corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """Eight 3D corners ``(..., 7) -> (..., 8, 3)`` (bottom 4 then top 4)."""
    bev = corners_bev(boxes)  # (..., 4, 2)
    z, h = boxes[..., 2], boxes[..., 5]
    zlo = (z - h / 2)[..., None, None].expand(*bev.shape[:-1], 1)
    zhi = (z + h / 2)[..., None, None].expand(*bev.shape[:-1], 1)
    bot = torch.cat([bev, zlo], dim=-1)
    top = torch.cat([bev, zhi], dim=-1)
    return torch.cat([bot, top], dim=-2)


def _polygon_area(pts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Shoelace area of the first ``n`` vertices of ``pts`` (B, MAX_VERTS, 2)."""
    m = pts.shape[-2]
    idx = torch.arange(m, device=pts.device)
    valid = idx < n[:, None]
    # Out-of-range gathers clamp, as XLA's do.
    nxt = torch.where(idx + 1 < n[:, None], idx + 1, 0).clamp_max(m - 1)
    x, y = pts[..., 0], pts[..., 1]
    cross = x * torch.gather(y, 1, nxt) - torch.gather(x, 1, nxt) * y
    return 0.5 * torch.where(valid, cross, 0.0).sum(dim=-1).abs()


def _clip_against_edge(poly: torch.Tensor, n: torch.Tensor, p0: torch.Tensor,
                       p1: torch.Tensor):
    """Clip polygons (B, MAX_VERTS, 2) with ``n`` (B,) valid CCW vertices
    against the half-planes to the left of the directed edges ``p0 -> p1``
    (B, 2). Returns the clipped buffers and their vertex counts."""
    b, m = poly.shape[0], poly.shape[1]
    e = (p1 - p0)[:, None, :]                      # (B, 1, 2)
    q0 = p0[:, None, :]

    def side(q):
        return e[..., 0] * (q[..., 1] - q0[..., 1]) \
            - e[..., 1] * (q[..., 0] - q0[..., 0])

    idx = torch.arange(m, device=poly.device)
    active = idx < n[:, None]                      # (B, M)
    nxt_i = torch.where(idx + 1 < n[:, None], idx + 1, 0).clamp_max(m - 1)
    cur = poly
    nxt = torch.gather(poly, 1, nxt_i[..., None].expand(b, m, 2))
    da = side(cur)
    db = side(nxt)
    cur_in = da >= 0.0
    nxt_in = db >= 0.0
    denom = da - db
    t = da / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    ipt = cur + t[..., None] * (nxt - cur)
    emit1 = active & cur_in                        # emit cur
    emit2 = active & (cur_in != nxt_in)            # emit the crossing
    e1 = emit1.to(torch.int64)
    e2 = emit2.to(torch.int64)
    start = torch.cumsum(e1 + e2, dim=1) - e1 - e2  # slot of vertex i's first emit
    # Emits past the buffer are dropped (as XLA drops out-of-range
    # scatters); non-emits land in a spill slot.
    spill = 2 * m
    slot1 = torch.where(emit1, start, spill)
    slot2 = torch.where(emit2, start + e1, spill)
    out = poly.new_zeros((b, 2 * m + 1, 2))
    out.scatter_(1, slot1[..., None].expand(b, m, 2), cur)
    out.scatter_(1, slot2[..., None].expand(b, m, 2), ipt)
    return out[:, :m], (e1 + e2).sum(dim=1)


def rect_intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Intersection area of convex quads given CCW corners (B, 4, 2)."""
    b = c1.shape[0]
    poly = c1.new_zeros((b, _MAX_VERTS, 2))
    poly[:, :4] = c1
    n = torch.full((b,), 4, dtype=torch.int64, device=c1.device)
    for k in range(4):
        poly, n = _clip_against_edge(poly, n, c2[:, k], c2[:, (k + 1) % 4])
    return _polygon_area(poly, n)


def _flat_pairs(b1: torch.Tensor, b2: torch.Tensor):
    shape = torch.broadcast_shapes(b1.shape, b2.shape)
    return (b1.expand(shape).reshape(-1, 7), b2.expand(shape).reshape(-1, 7),
            shape[:-1])


def iou_bev(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU between boxes (..., 7) (the detector's NMS)."""
    f1, f2, batch = _flat_pairs(b1, b2)
    inter = rect_intersection_area(corners_bev(f1), corners_bev(f2))
    a1 = f1[:, 3] * f1[:, 4]
    a2 = f2[:, 3] * f2[:, 4]
    union = a1 + a2 - inter
    return torch.where(union > 1e-9, inter / union, 0.0).reshape(batch)


def pairwise_iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor
                     ) -> torch.Tensor:
    """Pairwise BEV IoU: (N, 7) x (M, 7) -> (N, M)."""
    return iou_bev(boxes1[:, None, :], boxes2[None, :, :])


def iou_3d(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Full 3D IoU between boxes (..., 7) (the paper's accuracy basis)."""
    f1, f2, batch = _flat_pairs(b1, b2)
    inter_bev = rect_intersection_area(corners_bev(f1), corners_bev(f2))
    zlo = torch.maximum(f1[:, 2] - f1[:, 5] / 2, f2[:, 2] - f2[:, 5] / 2)
    zhi = torch.minimum(f1[:, 2] + f1[:, 5] / 2, f2[:, 2] + f2[:, 5] / 2)
    inter_h = (zhi - zlo).clamp_min(0.0)
    inter = inter_bev * inter_h
    v1 = f1[:, 3] * f1[:, 4] * f1[:, 5]
    v2 = f2[:, 3] * f2[:, 4] * f2[:, 5]
    union = v1 + v2 - inter
    return torch.where(union > 1e-9, inter / union, 0.0).reshape(batch)


def pairwise_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise 3D IoU: (..., N, 7) x (..., M, 7) -> (..., N, M)."""
    return iou_3d(boxes1[..., :, None, :], boxes2[..., None, :, :])


def aabb_iou_2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise axis-aligned 2D IoU. a: (..., N, 4) [x1,y1,x2,y2]; b: (...,
    M, 4), the same leading dims (at most one on the card: a stream axis).

    Dispatches through ``repro_torch.ops`` (kernels/iou2d): the CUDA kernel
    for tensors on the card, the plain PyTorch version on the CPU.
    """
    return ops.iou2d(a, b)


def points_in_box_bev(points_xy: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Mask of points (..., P, 2) inside the BEV rectangles of ``box`` (..., 7)."""
    th = box[..., 6:7]
    c, s = torch.cos(th), torch.sin(th)
    rel = points_xy - box[..., None, :2]
    # Rotate into the box frame.
    lx = rel[..., 0] * c + rel[..., 1] * s
    ly = -rel[..., 0] * s + rel[..., 1] * c
    return (lx.abs() <= box[..., 3:4] / 2) & (ly.abs() <= box[..., 4:5] / 2)


def points_in_box_3d(points: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Mask of points (..., P, 3) inside the 3D boxes (..., 7)."""
    bev = points_in_box_bev(points[..., :2], box)
    zok = (points[..., 2] - box[..., 2:3]).abs() <= box[..., 5:6] / 2
    return bev & zok


def _row4(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor) -> torch.Tensor:
    # (a*m0 + b*m1) + (c*m2 + 1*m3): the order of XLA's 4-term CPU dot.
    return (a * m[0] + b * m[1]) + (c * m[2] + m[3])


def project_box3d_to_2d(box: torch.Tensor, tr: torch.Tensor,
                        P: torch.Tensor) -> torch.Tensor:
    """Project 3D boxes (..., 7) in the LiDAR frame to the image: Tr (3,4)
    LiDAR -> camera, then P (3,4) camera -> pixel. Returns (..., 4)
    [x1,y1,x2,y2].

    This is the paper's "Preparation" step 2: anchor-frame 3D results are
    projected to the image plane to seed 2D tracking.
    """
    corners = corners_3d(box)  # (..., 8, 3)
    x, y, z = corners.unbind(-1)
    cam = [_row4(tr[r], x, y, z) for r in range(3)]
    uvw = [_row4(P[r], *cam) for r in range(3)]
    w = torch.where(uvw[2].abs() < 1e-6, 1e-6, uvw[2])
    u = uvw[0] / w
    v = uvw[1] / w
    return torch.stack([u.amin(-1), v.amin(-1), u.amax(-1), v.amax(-1)],
                       dim=-1)


def heading_vector(theta: torch.Tensor) -> torch.Tensor:
    """Unit heading vector in the x-y plane from yaw angle."""
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
