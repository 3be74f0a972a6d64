"""Device-profile registry: the single source of modeled latency.

Every latency number the Moby reproduction *models* (this container has no
Jetson TX2 / RTX 2080Ti / 4G link — DESIGN.md §3) comes from a
:class:`DeviceProfile` resolved through this registry:

* **Edge/cloud inference** — :func:`detector_latency` maps a named 3D/2D
  detector (published per-frame GFLOPs + calibrated sustained efficiency)
  onto any registered device.
* **On-board transformation components** — :class:`ComponentTimes` holds
  the Fig. 15 component model; its values are calibrated on the TX2, and
  :func:`component_times` rescales them for any other registered device,
  so ``device="tpu_v5e"`` runs report modeled on-board time from the
  active profile rather than this host's CPU wall time.
* **Kernel rooflines** — :func:`roofline_latency` turns (FLOPs, bytes)
  estimates into modeled per-op latency (benchmarks/kernel_backends.py
  reports these next to measured wall time).

Profiles are registered by name (``register_profile``), mirroring the ops
and scenario registries: TX2 and 2080Ti reproduce the paper's testbed,
``tpu_v5e`` is the accelerator target, and new hardware is one
``register_profile(DeviceProfile(...))`` away. The LM roofline helpers
that used to share a module with these (``lm_train_flops``,
``analytic_cell_cost``, ...) are *not* part of the Moby path and stay in
:mod:`repro.runtime.costmodel`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    peak_flops: float        # FLOP/s (dense fp16/bf16 unless noted)
    hbm_bw: float            # bytes/s
    link_bw: float = 0.0     # bytes/s per ICI/interconnect link
    # Empirical sustained efficiency for irregular workloads (conv/point
    # nets rarely exceed ~30-50% of peak on edge parts).
    efficiency: float = 0.35
    fixed_overhead_s: float = 0.004

    @property
    def effective_flops(self) -> float:
        """Sustained FLOP/s for irregular workloads."""
        return self.peak_flops * self.efficiency


# Jetson TX2: 256-core Pascal, ~1.33 TFLOP/s fp16, 58.3 GB/s LPDDR4 —
# the paper's edge device and the calibration anchor for ComponentTimes.
JETSON_TX2 = DeviceProfile(name="jetson_tx2", peak_flops=1.33e12,
                           hbm_bw=58.3e9, efficiency=0.30,
                           fixed_overhead_s=0.010)

# RTX 2080 Ti: ~26.9 TFLOP/s fp16 (tensor ~107), 616 GB/s GDDR6 — the
# paper's cloud GPU.
RTX_2080TI = DeviceProfile(name="rtx_2080ti", peak_flops=26.9e12,
                           hbm_bw=616e9, efficiency=0.40,
                           fixed_overhead_s=0.003)

# Jetson AGX Orin: 2048-core Ampere, ~10.6 TFLOP/s fp16 (GPU, MAXN),
# 204.8 GB/s LPDDR5 — the Orin-class edge device of mixed fleets (~8x the
# TX2's sustained throughput at a similar sustained-efficiency point).
JETSON_ORIN = DeviceProfile(name="jetson_orin", peak_flops=10.6e12,
                            hbm_bw=204.8e9, efficiency=0.32,
                            fixed_overhead_s=0.006)

# TPU v5e — the Pallas kernel target.
TPU_V5E = DeviceProfile(name="tpu_v5e", peak_flops=197e12, hbm_bw=819e9,
                        link_bw=50e9, efficiency=0.55,
                        fixed_overhead_s=0.0)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_PROFILES: Dict[str, DeviceProfile] = {}


def register_profile(profile: DeviceProfile, *aliases: str) -> None:
    """Register a device profile under its name (+ optional aliases).
    Idempotent per name, mirroring ``ops.registry.register_op``."""
    _PROFILES[profile.name] = profile
    for a in aliases:
        _PROFILES[a] = profile


def list_profiles() -> list[str]:
    return sorted(_PROFILES)


def get_profile(device: Union[str, DeviceProfile]) -> DeviceProfile:
    """Resolve a device name (or pass a profile through). Raises KeyError
    naming the registered profiles on an unknown name."""
    if isinstance(device, DeviceProfile):
        return device
    if device not in _PROFILES:
        raise KeyError(f"unknown device profile {device!r}; registered "
                       f"profiles: {list_profiles()}")
    return _PROFILES[device]


register_profile(JETSON_TX2, "tx2")
register_profile(JETSON_ORIN, "orin")
register_profile(RTX_2080TI, "2080ti")
register_profile(TPU_V5E, "v5e")


# ---------------------------------------------------------------------------
# Per-stream profile vectors (heterogeneous fleets)
# ---------------------------------------------------------------------------

# A device spec, as Scenario.device accepts it: one profile name (or
# profile) for the whole fleet, an explicit per-stream list of S names, or
# a named mix {"jetson_tx2": 0.75, "jetson_orin": 0.25} resolved onto S
# streams deterministically.
DeviceSpec = Union[str, DeviceProfile, Sequence[Union[str, DeviceProfile]],
                   Mapping[str, float]]


def _stream_profiles(spec: DeviceSpec,
                     n_streams: int) -> Tuple[DeviceProfile, ...]:
    """Resolve a device spec to per-stream profiles. Profile *instances*
    pass through as-is (registered or not, matching the scalar engine
    path); names go through the registry (KeyError lists it)."""
    if isinstance(spec, (str, DeviceProfile)):
        return (get_profile(spec),) * n_streams
    if isinstance(spec, Mapping):
        if not spec:
            raise ValueError("empty device mix spec")
        by_name: Dict[str, DeviceProfile] = {}
        fracs: Dict[str, float] = {}
        for d, w in spec.items():   # aliases accumulate onto one profile
            p = get_profile(d)
            if float(w) < 0:
                raise ValueError(
                    f"device mix weight for {p.name!r} is negative: {w!r}")
            by_name[p.name] = p
            fracs[p.name] = fracs.get(p.name, 0.0) + float(w)
        total = sum(fracs.values())
        if total <= 0:
            raise ValueError(f"device mix weights must sum > 0: {spec!r}")
        exact = {d: w / total * n_streams for d, w in fracs.items()}
        counts = {d: int(e) for d, e in exact.items()}
        # Largest remainder, ties broken by mapping order (stable sort).
        rest = sorted(exact, key=lambda d: exact[d] - counts[d],
                      reverse=True)
        for d in rest[:n_streams - sum(counts.values())]:
            counts[d] += 1
        out = tuple(by_name[d] for d in fracs for _ in range(counts[d]))
        assert len(out) == n_streams, (spec, n_streams, counts)
        return out
    profs = tuple(get_profile(d) for d in spec)
    if len(profs) != n_streams:
        raise ValueError(f"device list names {len(profs)} streams, "
                         f"fleet has {n_streams}")
    return profs


def resolve_stream_devices(spec: DeviceSpec, n_streams: int
                           ) -> Tuple[str, ...]:
    """Resolve a device spec to the per-stream tuple of S profile names.

    * a name / profile        -> that device on every stream;
    * a sequence of S entries -> per-stream assignment, verbatim;
    * a fraction mapping      -> largest-remainder proportional counts
      (weights must be non-negative), assigned in contiguous blocks
      following the mapping's iteration order (deterministic: no RNG, so
      a mix spec is reproducible and stream `i`'s device never depends
      on the seed).

    Names are validated against the registry (KeyError lists the
    registered profiles); :class:`DeviceProfile` instances pass through.
    """
    return tuple(p.name for p in _stream_profiles(spec, n_streams))


@dataclasses.dataclass(frozen=True)
class ProfileVector:
    """S device profiles stacked into per-stream arrays (float64, so the
    modeled-latency arithmetic is elementwise-identical to the scalar
    :class:`DeviceProfile` path — a uniform vector reproduces the scalar
    results bitwise). The arrays are plain numpy: usable directly inside
    jitted / ``lax.scan`` steps, where they enter the trace as constants.
    """
    profiles: Tuple[DeviceProfile, ...]
    names: Tuple[str, ...]
    peak_flops: np.ndarray       # (S,) float64
    hbm_bw: np.ndarray           # (S,)
    efficiency: np.ndarray       # (S,)
    fixed_overhead_s: np.ndarray  # (S,)

    @property
    def n_streams(self) -> int:
        return len(self.names)

    @property
    def effective_flops(self) -> np.ndarray:
        """Sustained FLOP/s per stream."""
        return self.peak_flops * self.efficiency

    def __getitem__(self, s: int) -> DeviceProfile:
        """Stream ``s``'s profile."""
        return self.profiles[s]


def profile_vector(spec: DeviceSpec, n_streams: int) -> ProfileVector:
    """Resolve a device spec (name / per-stream list / mix mapping — see
    :func:`resolve_stream_devices`) into a stacked :class:`ProfileVector`.
    Unregistered :class:`DeviceProfile` instances are accepted, matching
    the scalar ``get_profile`` pass-through."""
    profs = _stream_profiles(spec, n_streams)

    def col(attr):
        return np.asarray([getattr(p, attr) for p in profs], np.float64)

    return ProfileVector(profiles=profs,
                         names=tuple(p.name for p in profs),
                         peak_flops=col("peak_flops"),
                         hbm_bw=col("hbm_bw"),
                         efficiency=col("efficiency"),
                         fixed_overhead_s=col("fixed_overhead_s"))


# ---------------------------------------------------------------------------
# Roofline latency (per-kernel modeled time)
# ---------------------------------------------------------------------------


def roofline_latency(profile: DeviceProfile, flops: float, bytes_moved: float
                     ) -> float:
    """max(compute, memory) + fixed overhead, with sustained efficiency."""
    t_c = flops / profile.effective_flops
    t_m = bytes_moved / profile.hbm_bw
    return max(t_c, t_m) + profile.fixed_overhead_s


# ---------------------------------------------------------------------------
# Detector latency (edge/cloud inference; Fig. 2/3/13 reproduction)
# ---------------------------------------------------------------------------

# Published per-frame inference GFLOPs (KITTI-scale inputs) for the paper's
# models; used only by the latency *reproduction* figures.
DETECTOR_GFLOPS: Dict[str, float] = {
    "pointpillar": 64.0,
    "second": 76.9,
    "pointrcnn": 27.4,      # point ops — low FLOPs, latency dominated by
    "pv_rcnn": 89.0,        # irregular memory access (handled by per-model
    "complex_yolo": 15.5,   # efficiency below)
    "frustum_convnet": 24.0,
    "monodle": 27.0,
    "deep3dbox": 42.0,
    "pseudo_lidar_pp": 120.0,
    "yolov5n": 7.7,         # seg variants at 1242x375-ish input
    "yolov5s": 26.4,
    "yolov5m": 78.9,
    "yolov5l": 147.7,
    # The zero-noise oracle stand-in (data.scenes) costs like the default
    # PointPillar it replaces, so detector="oracle" runs end to end.
    "oracle": 64.0,
}

# Per-model sustained-efficiency fudge factors calibrated so TX2 latencies
# match the paper's measurements (Fig. 2: PointPillar 293 ms, SECOND 677 ms,
# 912 ms mean across the four models; YOLOv5n 33 ms, YOLOv5l ~62 % of
# PointPillar; §5.2.2: Deep3DBox 2834 ms, Pseudo-LiDAR++ 5889 ms).
# Two-stage point-based models are gather/memory-bound, hence tiny values.
DETECTOR_EFFICIENCY: Dict[str, float] = {
    "pointpillar": 0.170,
    "second": 0.087,
    "pointrcnn": 0.023,
    "pv_rcnn": 0.038,
    "complex_yolo": 0.050,
    "frustum_convnet": 0.077,
    "monodle": 0.053,
    "deep3dbox": 0.0112,
    "pseudo_lidar_pp": 0.0153,
    "yolov5n": 0.250,
    "yolov5s": 0.440,
    "yolov5m": 0.590,
    "yolov5l": 0.645,
    "oracle": 0.170,        # = pointpillar (see DETECTOR_GFLOPS)
}


def detector_latency(model: str,
                     device: Union[str, DeviceProfile, ProfileVector]
                     ) -> Union[float, np.ndarray]:
    """Inference latency (s) of a named detector on a device profile.
    A :class:`ProfileVector` yields the per-stream (S,) latency array
    (float64 — elementwise the same arithmetic as the scalar path)."""
    profile = device if isinstance(device, ProfileVector) \
        else get_profile(device)
    flops = DETECTOR_GFLOPS[model] * 1e9
    eff = DETECTOR_EFFICIENCY[model]
    return flops / (profile.peak_flops * eff) + profile.fixed_overhead_s


# ---------------------------------------------------------------------------
# On-board transformation component model (Fig. 15)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ComponentTimes:
    """Modeled on-board component times, seconds. The *default values* are
    the TX2 calibration derived from Fig. 15 / Table 4 (documented in
    benchmarks/fig15_breakdown.py); :func:`component_times` is the single
    sanctioned way to obtain them for any device — it rescales this
    calibration by the profile's sustained throughput."""
    seg_2d: float = 0.033          # YOLOv5n instance segmentation
    point_proj: float = 0.0127
    filtration: float = 0.00201
    bbox_est_assoc: float = 0.023
    bbox_est_new: float = 0.0407   # two-hypothesis path (no prior)
    tba: float = 0.00514
    fos: float = 0.0006


def component_times(device: Union[str, DeviceProfile]) -> ComponentTimes:
    """The Fig. 15 component model on an arbitrary device: the calibrated
    TX2 values scaled by the effective-throughput ratio (compute-bound
    approximation; the TX2 itself maps to the calibration exactly)."""
    profile = get_profile(device)
    if profile.name == JETSON_TX2.name:
        return ComponentTimes()
    scale = JETSON_TX2.effective_flops / profile.effective_flops
    base = ComponentTimes()
    return ComponentTimes(**{
        f.name: getattr(base, f.name) * scale
        for f in dataclasses.fields(ComponentTimes)})


def component_times_vector(pvec: ProfileVector) -> ComponentTimes:
    """Per-stream component model: a :class:`ComponentTimes` whose fields
    are (S,) float64 arrays — the TX2 calibration scaled per stream.

    The float64 numpy arithmetic is elementwise identical to the scalar
    :func:`component_times` path (python floats are 64-bit), so a uniform
    fleet reproduces the scalar model bitwise; inside jitted steps the
    arrays enter the trace as constants and broadcast against the
    per-stream detection counts.
    """
    scale = JETSON_TX2.effective_flops / pvec.effective_flops   # (S,) f64
    base = ComponentTimes()
    return ComponentTimes(**{
        f.name: getattr(base, f.name) * scale
        for f in dataclasses.fields(ComponentTimes)})


def component_slice(comp: ComponentTimes, s: int) -> ComponentTimes:
    """Stream ``s``'s scalar :class:`ComponentTimes` out of a stacked
    per-stream one (scalar fields pass through unchanged)."""
    def pick(v):
        return float(np.asarray(v).reshape(-1)[s]) \
            if np.ndim(v) else float(v)

    return ComponentTimes(**{
        f.name: pick(getattr(comp, f.name))
        for f in dataclasses.fields(ComponentTimes)})
