"""Pre-recorded frame tapes: the host-side data plane of the serving tier.

A :class:`FrameTape` precomputes, per frame of one vehicle stream,
everything the device pipeline consumes — LiDAR points, oracle 2D/3D
detections, the remapped instance-label image and the evaluable ground
truth. With the data plane factored out, the engines become pure control
planes over identical inputs:

* ``MobyEngine(..., tape=...)`` replays a tape through its per-frame Python
  loop (the seed single-stream engine);
* ``FleetEngine`` stacks S tapes on a leading stream axis and advances all
  streams in one device dispatch per frame (repro.fleet; not yet ported).

Sharing one tape between both engines is what makes the fleet parity test
exact: any divergence is attributable to the engine, not the data.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

from repro_torch.data import scenes


class FrameTape(NamedTuple):
    """Per-stream recording; every array has a leading frame axis F.

    ``stack_tapes`` prepends a stream axis S, giving the (S, F, ...) layout
    the fleet engine slices per frame.
    """
    points: np.ndarray       # (F, N, 3) float32
    det2d: np.ndarray        # (F, D, 4) float32 oracle 2D boxes
    val2d: np.ndarray        # (F, D) bool
    label_img: np.ndarray    # (F, H, W) int32, detection-slot ids
    det3d: np.ndarray        # (F, D, 7) float32 oracle cloud detections
    val3d: np.ndarray        # (F, D) bool
    gt_boxes: np.ndarray     # (F, D, 7) float32
    gt_visible: np.ndarray   # (F, D) bool (evaluable ground truth)

    @property
    def n_frames(self) -> int:
        return self.points.shape[-3]

    def frame(self, t: int) -> "FrameTape":
        """View of a single frame (drops the frame axis)."""
        return FrameTape(*(a[t] for a in self))


def record_tape(stream: scenes.SceneStream, detector: str, n_frames: int,
                rng: np.random.Generator) -> FrameTape:
    """Roll ``stream`` forward ``n_frames`` and record all per-frame inputs.

    The oracle detectors are sampled once per frame (3D then 2D) so the
    recording is independent of any engine's anchor/test decisions.
    """
    noise = scenes.DETECTOR_PROFILES[detector]
    cols = {k: [] for k in FrameTape._fields}
    for frame in stream.frames(n_frames):
        det3d, val3d = scenes.oracle_detect_3d(frame, rng, noise)
        det2d, val2d, label_img = scenes.oracle_detect_2d(frame, rng)
        cols["points"].append(frame.points)
        cols["det2d"].append(det2d.astype(np.float32))
        cols["val2d"].append(val2d.astype(bool))
        cols["label_img"].append(label_img.astype(np.int32))
        cols["det3d"].append(det3d.astype(np.float32))
        cols["val3d"].append(val3d.astype(bool))
        cols["gt_boxes"].append(frame.gt_boxes.astype(np.float32))
        cols["gt_visible"].append(frame.visible_gt().astype(bool))
    return FrameTape(**{k: np.stack(v) for k, v in cols.items()})


def record_stream_tape(cfg: scenes.SceneConfig, detector: str, n_frames: int,
                       seed: int = 0) -> FrameTape:
    """Record one stream's tape with the engine's seeding convention
    (scene from ``seed``, detector noise from ``seed + 1``)."""
    stream = scenes.SceneStream(cfg, seed=seed)
    return record_tape(stream, detector, n_frames,
                       np.random.default_rng(seed + 1))


def record_fleet_tapes(cfg: scenes.SceneConfig, detector: str, n_frames: int,
                       n_streams: int, seed: int = 0) -> List[FrameTape]:
    """Record S decorrelated streams (stream i reuses the single-stream
    seeding convention at ``seed + 101 * i``, so stream 0 of a fleet equals
    a single-stream recording at ``seed`` — the parity anchor)."""
    fleet = scenes.MultiStreamScenes(cfg, n_streams, seed=seed)
    return [record_tape(stream, detector, n_frames,
                        np.random.default_rng(fleet.stream_seed(i) + 1))
            for i, stream in enumerate(fleet.streams)]


def stack_tapes(tapes: Sequence[FrameTape]) -> FrameTape:
    """Stack per-stream tapes to (S, F, ...) arrays."""
    return FrameTape(*(np.stack(cols) for cols in zip(*tapes)))
