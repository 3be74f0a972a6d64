"""Synthetic KITTI-like scene simulator.

Generates dynamic driving scenes with ground-truth 3D boxes, LiDAR-like
point clouds (visible-surface sampling with self-occlusion, ground plane,
and background clutter placed *behind* objects so it projects into their 2D
masks — the exact failure mode Algorithm 1 filters), a calibrated camera,
and instance-segmentation ground truth.

Everything here is host-side NumPy (data generation), consumed by the JAX
pipeline as device arrays. Oracle detectors with calibrated noise stand in
for pretrained YOLOv5/OpenPCDet checkpoints (see DESIGN.md §3): they expose
the same interface as the real JAX nets in ``repro.models``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    max_obj: int = 16            # object slots (D)
    n_points: int = 8192         # LiDAR points per frame (N)
    img_h: int = 128             # label-image height
    img_w: int = 416             # label-image width
    x_range: tuple = (5.0, 60.0)   # objects spawn ahead of the ego
    y_range: tuple = (-12.0, 12.0)
    lidar_height: float = 1.73   # ground plane at z = -lidar_height
    dt: float = 0.1              # 10 FPS, as KITTI
    mean_objects: int = 8
    seed: int = 0
    # Per-object LiDAR return budget ~ density_scale / distance. KITTI's
    # 120k-point scans put ~500 returns on a car at 30 m (density ~15k);
    # small values emulate sparse sensors.
    density_scale: float = 2200.0


# KITTI-like calibration, scaled to the reduced label image.
def make_calibration(cfg: SceneConfig):
    """Returns (tr (3,4), p (3,4)) LiDAR->camera and camera->pixel."""
    # LiDAR: x fwd, y left, z up.  Camera: z fwd, x right, y down.
    r = np.array([[0.0, -1.0, 0.0],
                  [0.0, 0.0, -1.0],
                  [1.0, 0.0, 0.0]])
    t = np.array([0.0, -0.08, -0.27])  # small KITTI-like offset
    tr = np.concatenate([r, t[:, None]], axis=1)
    # Intrinsics scaled from KITTI (f=721 at 1242x375).
    scale = cfg.img_w / 1242.0
    f = 721.5377 * scale
    cx = cfg.img_w / 2.0
    cy = cfg.img_h * 0.46
    p = np.array([[f, 0.0, cx, 0.0],
                  [0.0, f, cy, 0.0],
                  [0.0, 0.0, 1.0, 0.0]])
    return tr.astype(np.float32), p.astype(np.float32)


# ---------------------------------------------------------------------------
# Scene dynamics
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SceneState:
    boxes: np.ndarray       # (O, 7) [x, y, z, l, w, h, theta]
    vel: np.ndarray         # (O, 2) ground-plane velocity
    omega: np.ndarray       # (O,) yaw rate
    valid: np.ndarray       # (O,) bool
    rng: np.random.Generator


def init_scene(cfg: SceneConfig, rng: Optional[np.random.Generator] = None) -> SceneState:
    rng = rng or np.random.default_rng(cfg.seed)
    o = cfg.max_obj
    n = min(int(rng.poisson(cfg.mean_objects)) + 2, o)
    boxes = np.zeros((o, 7), np.float32)
    vel = np.zeros((o, 2), np.float32)
    omega = np.zeros((o,), np.float32)
    valid = np.zeros((o,), bool)
    for i in range(n):
        boxes[i], vel[i], omega[i] = _spawn_object(cfg, rng)
        valid[i] = True
    return SceneState(boxes=boxes, vel=vel, omega=omega, valid=valid, rng=rng)


def _spawn_object(cfg: SceneConfig, rng: np.random.Generator):
    x = rng.uniform(*cfg.x_range)
    y = rng.uniform(*cfg.y_range)
    # KITTI car size statistics.
    l = rng.normal(3.9, 0.35)
    w = rng.normal(1.65, 0.12)
    h = rng.normal(1.55, 0.1)
    theta = rng.uniform(-np.pi, np.pi) if rng.uniform() < 0.3 else \
        rng.choice([0.0, np.pi]) + rng.normal(0, 0.15)
    z = -cfg.lidar_height + h / 2
    speed = abs(rng.normal(5.0, 3.0))
    vel = speed * np.array([np.cos(theta), np.sin(theta)])
    omega = rng.normal(0.0, 0.05)
    box = np.array([x, y, z, max(l, 2.5), max(w, 1.3), max(h, 1.2), theta],
                   np.float32)
    return box, vel.astype(np.float32), np.float32(omega)


def step_scene(state: SceneState, cfg: SceneConfig) -> SceneState:
    boxes = state.boxes.copy()
    vel = state.vel.copy()
    omega = state.omega.copy()
    valid = state.valid.copy()
    boxes[:, 0] += vel[:, 0] * cfg.dt
    boxes[:, 1] += vel[:, 1] * cfg.dt
    boxes[:, 6] += omega * cfg.dt
    spd = np.linalg.norm(vel, axis=1)
    heading = boxes[:, 6]
    vel[:, 0] = spd * np.cos(heading)
    vel[:, 1] = spd * np.sin(heading)
    # Despawn objects that left the scene; occasionally spawn new ones.
    gone = (boxes[:, 0] < cfg.x_range[0] - 5) | (boxes[:, 0] > cfg.x_range[1] + 15) \
        | (np.abs(boxes[:, 1]) > cfg.y_range[1] + 8)
    valid &= ~gone
    if state.rng.uniform() < 0.08:
        free = np.flatnonzero(~valid)
        if free.size:
            i = free[0]
            boxes[i], vel[i], omega[i] = _spawn_object(cfg, state.rng)
            valid[i] = True
    return SceneState(boxes=boxes, vel=vel, omega=omega, valid=valid,
                      rng=state.rng)


# ---------------------------------------------------------------------------
# LiDAR rendering
# ---------------------------------------------------------------------------

_FACES = [  # (axis, sign): 4 vertical faces then top
    (0, +1), (0, -1), (1, +1), (1, -1), (2, +1),
]


def _sample_box_surface(box, n_pts, rng):
    """Sample points on the faces of ``box`` visible from the origin."""
    x, y, z, l, w, h, th = box
    c, s = np.cos(th), np.sin(th)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    ctr = np.array([x, y, z])
    half = np.array([l / 2, w / 2, h / 2])
    pts = []
    weights = []
    visible = []
    for axis, sign in _FACES:
        normal_local = np.zeros(3)
        normal_local[axis] = sign
        normal = rot @ normal_local
        fc = ctr + rot @ (normal_local * half)
        vis = np.dot(normal, fc) < 0  # faces the sensor at the origin
        if axis == 2:  # top face: grazing angle, few points
            vis = vis and False
        visible.append(vis)
        if not vis:
            continue
        dims = [i for i in range(3) if i != axis]
        area = 4 * half[dims[0]] * half[dims[1]]
        weights.append((axis, sign, dims, area))
    if not weights:
        return np.zeros((0, 3), np.float32)
    areas = np.array([wgt[3] for wgt in weights])
    counts = np.maximum((areas / areas.sum() * n_pts).astype(int), 1)
    out = []
    for (axis, sign, dims, _), cnt in zip(weights, counts):
        local = np.zeros((cnt, 3))
        local[:, axis] = sign * half[axis]
        local[:, dims[0]] = rng.uniform(-half[dims[0]], half[dims[0]], cnt)
        local[:, dims[1]] = rng.uniform(-half[dims[1]], half[dims[1]], cnt)
        world = (rot @ local.T).T + ctr
        out.append(world)
    pts = np.concatenate(out, axis=0)
    pts += rng.normal(0, 0.02, pts.shape)  # sensor noise
    return pts.astype(np.float32)


@dataclasses.dataclass
class Frame:
    points: np.ndarray        # (N, 3)
    point_labels: np.ndarray  # (N,) GT instance id, 0 = background
    gt_boxes: np.ndarray      # (O, 7)
    gt_valid: np.ndarray      # (O,)
    gt_boxes2d: np.ndarray    # (O, 4) pixel-space
    label_img: np.ndarray     # (H, W) int32, GT instance ids
    tainted_mask: np.ndarray  # (N,) True where a background point projects
                              # inside some object's 2D mask ("tainted")
    vis_counts: np.ndarray = None  # (O,) visible LiDAR returns per object

    def visible_gt(self, min_points: int = 5) -> np.ndarray:
        """KITTI-style evaluable ground truth: objects with enough visible
        returns (fully occluded objects are excluded from evaluation)."""
        return self.gt_valid & (self.vis_counts >= min_points)


def render_frame(state: SceneState, cfg: SceneConfig, tr: np.ndarray,
                 p: np.ndarray) -> Frame:
    rng = state.rng
    n_total = cfg.n_points
    pts_list = []
    lab_list = []
    obj_ids = np.flatnonzero(state.valid)
    # Per-object point budget falls off with distance (LiDAR sampling).
    dists = np.linalg.norm(state.boxes[obj_ids, :2], axis=1) + 1e-6
    budget = np.maximum((cfg.density_scale / dists).astype(int), 12)
    for oid, nb in zip(obj_ids, budget):
        sp = _sample_box_surface(state.boxes[oid], nb, rng)
        pts_list.append(sp)
        lab_list.append(np.full((len(sp),), oid + 1, np.int32))
        # Background clutter directly behind the object (walls/vegetation):
        # these project into the same mask region -> tainted points.
        ray = state.boxes[oid, :2] / dists[obj_ids.tolist().index(oid)]
        back_d = rng.uniform(6.0, 18.0)
        n_back = max(nb // 4, 4)
        bx = state.boxes[oid, 0] + ray[0] * back_d + rng.normal(0, 1.2, n_back)
        by = state.boxes[oid, 1] + ray[1] * back_d + rng.normal(0, 1.5, n_back)
        bz = rng.uniform(-cfg.lidar_height, 1.2, n_back)
        bp = np.stack([bx, by, bz], axis=1).astype(np.float32)
        pts_list.append(bp)
        lab_list.append(np.zeros((n_back,), np.int32))
    # Ground plane + scattered clutter fill the remaining budget.
    used = sum(len(q) for q in pts_list)
    n_bg = max(n_total - used, 0)
    gx = rng.uniform(cfg.x_range[0] - 4, cfg.x_range[1] + 10, n_bg)
    gy = rng.uniform(cfg.y_range[0] - 6, cfg.y_range[1] + 6, n_bg)
    gz = np.full(n_bg, -cfg.lidar_height) + rng.normal(0, 0.03, n_bg)
    clutter = rng.uniform(size=n_bg) < 0.15
    gz = np.where(clutter, rng.uniform(-cfg.lidar_height, 2.0, n_bg), gz)
    pts_list.append(np.stack([gx, gy, gz], axis=1).astype(np.float32))
    lab_list.append(np.zeros((n_bg,), np.int32))

    points = np.concatenate(pts_list, axis=0)[:n_total]
    labels = np.concatenate(lab_list, axis=0)[:n_total]
    if len(points) < n_total:  # pad
        pad = n_total - len(points)
        points = np.concatenate([points, np.zeros((pad, 3), np.float32)])
        labels = np.concatenate([labels, np.zeros((pad,), np.int32)])

    label_img, boxes2d = _render_masks(state, cfg, tr, p)
    # Inter-object occlusion: a LiDAR return cannot come from an object
    # hidden behind a nearer one. Points whose pixel is owned by a *nearer*
    # object are replaced by ground returns.
    uv, depth = _project_np(points, tr, p)
    ui = np.clip(np.round(uv[:, 0]).astype(int), 0, cfg.img_w - 1)
    vi = np.clip(np.round(uv[:, 1]).astype(int), 0, cfg.img_h - 1)
    vis = (depth > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < cfg.img_w) \
        & (uv[:, 1] >= 0) & (uv[:, 1] < cfg.img_h)
    pix_owner = np.where(vis, label_img[vi, ui], 0)
    obj_dist = np.full(cfg.max_obj + 1, np.inf)
    for oid in np.flatnonzero(state.valid):
        obj_dist[oid + 1] = np.linalg.norm(state.boxes[oid, :2])
    occluded = (labels > 0) & (pix_owner > 0) & (pix_owner != labels) \
        & (obj_dist[pix_owner] < obj_dist[labels] - 1.0)
    n_occ = int(occluded.sum())
    if n_occ:
        gx = rng.uniform(cfg.x_range[0], cfg.x_range[1], n_occ)
        gy = rng.uniform(cfg.y_range[0], cfg.y_range[1], n_occ)
        gz = np.full(n_occ, -cfg.lidar_height) + rng.normal(0, 0.03, n_occ)
        points[occluded] = np.stack([gx, gy, gz], axis=1).astype(np.float32)
        labels[occluded] = 0
    tainted = _tainted_points(points, labels, label_img, tr, p, cfg)
    vis_counts = np.bincount(labels, minlength=cfg.max_obj + 1)[1:]
    return Frame(points=points, point_labels=labels, gt_boxes=state.boxes,
                 gt_valid=state.valid, gt_boxes2d=boxes2d,
                 label_img=label_img, tainted_mask=tainted,
                 vis_counts=vis_counts)


def _project_np(points: np.ndarray, tr: np.ndarray, p: np.ndarray):
    hom = np.concatenate([points, np.ones((len(points), 1), points.dtype)], axis=1)
    cam = hom @ tr.T
    camh = np.concatenate([cam, np.ones((len(cam), 1), cam.dtype)], axis=1)
    pix = camh @ p.T
    depth = pix[:, 2]
    w = np.where(np.abs(depth) < 1e-6, 1e-6, depth)
    uv = pix[:, :2] / w[:, None]
    return uv, depth


def _box_corners3d_np(box):
    x, y, z, l, w, h, th = box
    c, s = np.cos(th), np.sin(th)
    dx = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * l / 2
    dy = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * w / 2
    dz = np.array([-1, -1, -1, -1, 1, 1, 1, 1]) * h / 2
    cx = x + dx * c - dy * s
    cy = y + dx * s + dy * c
    cz = z + dz
    return np.stack([cx, cy, cz], axis=1)


def _render_masks(state: SceneState, cfg: SceneConfig, tr, p):
    """Paint convex hulls of projected boxes far-to-near (occlusion order)."""
    h, w = cfg.img_h, cfg.img_w
    label_img = np.zeros((h, w), np.int32)
    boxes2d = np.zeros((cfg.max_obj, 4), np.float32)
    obj_ids = np.flatnonzero(state.valid)
    order = obj_ids[np.argsort(-np.linalg.norm(state.boxes[obj_ids, :2], axis=1))]
    yy, xx = np.mgrid[0:h, 0:w]
    grid = np.stack([xx.ravel(), yy.ravel()], axis=1).astype(np.float64)
    for oid in order:
        corners = _box_corners3d_np(state.boxes[oid])
        uv, depth = _project_np(corners, tr, p)
        if np.all(depth <= 0.1):
            continue
        uv = uv[depth > 0.1]
        if len(uv) < 3:
            continue
        x1, y1 = uv.min(axis=0)
        x2, y2 = uv.max(axis=0)
        boxes2d[oid] = [x1, y1, x2, y2]
        if x2 < 0 or y2 < 0 or x1 >= w or y1 >= h:
            continue
        hull = _convex_hull(uv)
        if len(hull) < 3:
            continue
        # Orientation-agnostic point-in-convex-polygon: same sign for all edges.
        cr = np.empty((len(hull), len(grid)))
        for i in range(len(hull)):
            a, b = hull[i], hull[(i + 1) % len(hull)]
            e = b - a
            cr[i] = e[0] * (grid[:, 1] - a[1]) - e[1] * (grid[:, 0] - a[0])
        inside = np.all(cr <= 1e-9, axis=0) | np.all(cr >= -1e-9, axis=0)
        label_img.ravel()[inside] = oid + 1
    return label_img, boxes2d


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain, CW order."""
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for q in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    for q in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    return np.array(lower[:-1] + upper[:-1])


def _tainted_points(points, labels, label_img, tr, p, cfg):
    uv, depth = _project_np(points, tr, p)
    ui = np.clip(np.round(uv[:, 0]).astype(int), 0, cfg.img_w - 1)
    vi = np.clip(np.round(uv[:, 1]).astype(int), 0, cfg.img_h - 1)
    vis = (depth > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < cfg.img_w) \
        & (uv[:, 1] >= 0) & (uv[:, 1] < cfg.img_h)
    proj_label = np.where(vis, label_img[vi, ui], 0)
    return (proj_label > 0) & (labels == 0)


# ---------------------------------------------------------------------------
# Oracle detectors (checkpoint stand-ins; see DESIGN.md §3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DetectorNoise:
    """Calibrated error model for a named detector."""
    center_sigma: float = 0.1     # metres
    size_sigma: float = 0.05
    heading_sigma: float = 0.03   # radians
    miss_rate: float = 0.03
    fp_rate: float = 0.02


# Noise levels calibrated so each stand-in's standalone F1@0.4-IoU on the
# synthetic benchmark matches the paper's measured accuracy (Fig. 13e:
# PointRCNN 0.751, others ~0.78-0.81; Fig. 14: monodle far weaker).
DETECTOR_PROFILES = {
    "pointpillar": DetectorNoise(0.305, 0.09, 0.06, 0.09, 0.045),
    "second": DetectorNoise(0.31, 0.09, 0.06, 0.09, 0.045),
    "pointrcnn": DetectorNoise(0.32, 0.09, 0.06, 0.08, 0.04),
    "pv_rcnn": DetectorNoise(0.30, 0.09, 0.06, 0.095, 0.045),
    "oracle": DetectorNoise(0.0, 0.0, 0.0, 0.0, 0.0),
    # Weaker baselines (Fig. 14): BEV-image and monocular methods.
    "complex_yolo": DetectorNoise(0.40, 0.11, 0.08, 0.12, 0.06),
    "frustum_convnet": DetectorNoise(0.35, 0.10, 0.07, 0.09, 0.05),
    "monodle": DetectorNoise(0.50, 0.14, 0.10, 0.20, 0.08),
}


def oracle_detect_3d(frame: Frame, rng: np.random.Generator,
                     noise: DetectorNoise):
    """Cloud 3D detector stand-in: GT + calibrated noise/misses/FPs.

    Objects with (almost) no visible LiDAR returns are undetectable by any
    point-cloud model and are dropped."""
    o = frame.gt_boxes.shape[0]
    boxes = frame.gt_boxes.copy()
    valid = frame.gt_valid.copy()
    if frame.vis_counts is not None:
        valid &= frame.vis_counts >= 5
    boxes[:, :2] += rng.normal(0, noise.center_sigma, (o, 2))
    boxes[:, 2] += rng.normal(0, noise.center_sigma / 2, o)
    boxes[:, 3:6] *= 1 + rng.normal(0, noise.size_sigma, (o, 3))
    boxes[:, 6] += rng.normal(0, noise.heading_sigma, o)
    valid &= rng.uniform(size=o) >= noise.miss_rate
    # False positives in free slots.
    for i in np.flatnonzero(~valid):
        if rng.uniform() < noise.fp_rate:
            boxes[i] = _spawn_object(
                SceneConfig(), rng)[0]
            valid[i] = True
    return boxes.astype(np.float32), valid


def oracle_detect_2d(frame: Frame, rng: np.random.Generator,
                     miss_rate: float = 0.03, jitter: float = 1.5):
    """Edge instance-segmentation stand-in: GT masks + box jitter + misses.

    Returns (det_boxes2d (O,4), det_valid (O,), label_img remapped to
    detection slots).
    """
    o = frame.gt_boxes2d.shape[0]
    boxes = frame.gt_boxes2d + rng.normal(0, jitter, (o, 4)).astype(np.float32)
    has_box = frame.gt_valid & (frame.gt_boxes2d[:, 2] > frame.gt_boxes2d[:, 0])
    if frame.vis_counts is not None:
        # Fully occluded objects have no visible mask to segment.
        has_box &= frame.vis_counts >= 5
    valid = has_box & (rng.uniform(size=o) >= miss_rate)
    # Remap the label image: GT id i+1 -> detection slot i+1 if kept, else 0.
    remap = np.zeros(o + 1, np.int32)
    for i in range(o):
        remap[i + 1] = (i + 1) if valid[i] else 0
    label_img = remap[frame.label_img]
    return boxes, valid, label_img


def render_rgb(frame: Frame, cfg: SceneConfig,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Cheap synthetic camera image (H, W, 3) for training the 2D detector:
    sky/ground gradient + per-object shaded mask + sensor noise."""
    rng = rng or np.random.default_rng(0)
    h, w = cfg.img_h, cfg.img_w
    img = np.zeros((h, w, 3), np.float32)
    horizon = int(h * 0.45)
    img[:horizon] = np.linspace(0.6, 0.8, horizon)[:, None, None]
    img[horizon:] = np.linspace(0.35, 0.25, h - horizon)[:, None, None]
    for oid in np.unique(frame.label_img):
        if oid == 0:
            continue
        mask = frame.label_img == oid
        dist = np.linalg.norm(frame.gt_boxes[oid - 1, :2])
        shade = np.clip(0.9 - dist / 80.0, 0.2, 0.9)
        color = np.array([shade, shade * 0.9, shade * 0.8])
        img[mask] = color
    img += rng.normal(0, 0.02, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


class SceneStream:
    """Iterator over synchronized (LiDAR, camera) frames of one stream."""

    def __init__(self, cfg: SceneConfig, seed: int = 0):
        self.cfg = cfg
        self.tr, self.p = make_calibration(cfg)
        self.state = init_scene(cfg, np.random.default_rng(seed))

    def frames(self, n: int):
        for _ in range(n):
            frame = render_frame(self.state, self.cfg, self.tr, self.p)
            yield frame
            self.state = step_scene(self.state, self.cfg)


class MultiStreamScenes:
    """S concurrent vehicle streams sharing one sensor configuration.

    Each stream is an independent world, decorrelated by seed; all streams
    share the calibration implied by ``cfg`` (one fleet, one sensor SKU),
    which is what lets batched engines use a single on-device calibration
    for every stream. serving.tape records these streams into the stacked
    (S, F, ...) arrays the fleet engine consumes.
    """

    SEED_STRIDE = 101  # keeps stream 0 equal to a single-stream run at seed

    def __init__(self, cfg: SceneConfig, n_streams: int, seed: int = 0):
        self.cfg = cfg
        self.n_streams = n_streams
        self.seed = seed
        self.streams = [SceneStream(cfg, seed=self.stream_seed(i))
                        for i in range(n_streams)]

    def stream_seed(self, i: int) -> int:
        return self.seed + self.SEED_STRIDE * i
