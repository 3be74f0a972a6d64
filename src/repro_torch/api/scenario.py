"""Declarative scenarios: everything a serving run needs, in one frozen
dataclass, plus a named preset registry mirroring ``ops.registry``.

A :class:`Scenario` captures what the seed spread across a dozen engine
constructor kwargs — scene configuration, detector profile, network trace,
deployment mode, fleet size, ablation switches, parameter overrides, ops
backend and seed — so a run is reproducible from one declarative value::

    from repro_torch import api
    report = api.Session(api.scenario("kitti-urban", seed=3)).run(40)

``scenario(name, **overrides)`` resolves a preset and applies overrides;
override keys may name either :class:`Scenario` fields (``detector``,
``policy``, ...) or :class:`repro.data.scenes.SceneConfig` fields
(``n_points``, ``density_scale``, ...), which are routed into the nested
scene config. Unknown keys raise ``KeyError`` listing the valid ones.

Port of ``repro/api/scenario.py``: the same presets and override routing.
The JAX package's ``backend`` field (ops backend) and ``mesh`` field
(stream-axis device mesh) are not fields here: the port dispatches each op
by tensor device, and the multi-device stream axis waits for the port's
fleet engine. Where a run computes is ``Session(..., torch_device=...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.core import scheduler, transform
from repro_torch.data import scenes
from repro_torch.fleet import cloud as cloud_lib
from repro_torch.runtime import profiles
from repro_torch.serving.common import ComponentTimes


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One serving run, declaratively. ``n_streams`` selects the engine
    (1 -> MobyEngine, >1 -> FleetEngine); ``policy`` names a registered
    scheduler policy (None keeps ``sparams.policy``)."""
    name: str = "custom"
    scene: scenes.SceneConfig = scenes.SceneConfig()
    detector: str = "pointpillar"
    trace: str = "belgium2"
    mode: str = "moby"                 # moby | moby_onboard | edge_only |
                                       # cloud_only (S=1 only for baselines)
    n_streams: int = 1                 # fleet size S
    use_fos: bool = True               # ablations (Table 4)
    use_tba: bool = True
    policy: Optional[str] = None       # scheduler policy slot
    tparams: Optional[transform.TransformParams] = None
    sparams: Optional[scheduler.SchedulerParams] = None
    comp: Optional[ComponentTimes] = None  # None = derive from device
    cloud: Optional[cloud_lib.CloudBatcherConfig] = None
    # Edge device slot (runtime.profiles registry). A profile name fleets
    # every stream on that device; heterogeneous fleets pass a list of S
    # names or a mix spec like {"jetson_tx2": 0.75, "jetson_orin": 0.25}
    # (resolved deterministically — see profiles.resolve_stream_devices).
    device: profiles.DeviceSpec = "jetson_tx2"
    seed: int = 0

    def device_profile(self) -> profiles.DeviceProfile:
        """The effective edge device profile of stream 0 (validated
        against the profile registry — unknown names raise KeyError
        listing it). Heterogeneous fleets read :meth:`stream_devices`."""
        return profiles.get_profile(self.stream_devices()[0])

    def stream_devices(self) -> tuple:
        """The per-stream device names this scenario resolves to (length
        ``n_streams``; validates every name against the registry)."""
        return profiles.resolve_stream_devices(self.device, self.n_streams)

    def scheduler_params(self) -> scheduler.SchedulerParams:
        """The effective SchedulerParams: explicit ``sparams`` plus the
        ``policy`` override, validated against the policy registry."""
        sp = self.sparams or scheduler.SchedulerParams()
        if self.policy is not None:
            sp = sp._replace(policy=self.policy)
        non_default = sp.policy != scheduler.SchedulerParams().policy
        if not self.use_fos and (self.policy is not None or non_default):
            raise ValueError(
                f"policy={sp.policy!r} with use_fos=False: the use_fos "
                f"ablation bypasses the scheduler entirely, so an explicit "
                f"policy would be silently ignored")
        scheduler.get_policy(sp.policy)   # fail fast on unknown names
        return sp


# ---------------------------------------------------------------------------
# Preset registry
# ---------------------------------------------------------------------------

_PRESETS: Dict[str, Callable[[], Scenario]] = {}


def register_scenario(name: str, factory: Callable[[], Scenario]) -> None:
    """Register a named preset. Idempotent per name (mirrors
    ``ops.registry.register_op``)."""
    _PRESETS[name] = factory


def list_scenarios() -> list[str]:
    return sorted(_PRESETS)


_SCENE_FIELDS = {f.name for f in dataclasses.fields(scenes.SceneConfig)}
_SCENARIO_FIELDS = {f.name for f in dataclasses.fields(Scenario)}


def scenario(name: str = "kitti-urban", **overrides) -> Scenario:
    """Resolve a preset by name and apply field overrides.

    Overrides naming SceneConfig fields are routed into ``scene``;
    ``seed`` seeds both the scenario (engine RNG/netsim) and the scene
    stream. Unknown names raise KeyError listing what is valid.
    """
    if name not in _PRESETS:
        raise KeyError(f"unknown scenario {name!r}; registered scenarios: "
                       f"{list_scenarios()}")
    sc = _PRESETS[name]()
    unknown = set(overrides) - _SCENARIO_FIELDS - _SCENE_FIELDS
    if unknown:
        raise KeyError(
            f"unknown scenario override(s) {sorted(unknown)}; valid keys: "
            f"{sorted(_SCENARIO_FIELDS | _SCENE_FIELDS)}")
    scene_kw = {k: v for k, v in overrides.items() if k in _SCENE_FIELDS}
    scen_kw = {k: v for k, v in overrides.items()
               if k in _SCENARIO_FIELDS and k != "scene"}
    scene = overrides.get("scene", sc.scene)
    if scene_kw:
        scene = dataclasses.replace(scene, **scene_kw)
    return dataclasses.replace(sc, scene=scene, **scen_kw)


# ---------------------------------------------------------------------------
# Built-in presets
# ---------------------------------------------------------------------------

def _kitti_scene(**kw) -> scenes.SceneConfig:
    """KITTI-like point density (the paper's environment), reduced frame
    point count for CPU speed — the scene every benchmark used via the old
    ``benchmarks.common.small_scene``."""
    base = dict(max_obj=12, n_points=8192, mean_objects=6,
                density_scale=15000.0)
    base.update(kw)
    return scenes.SceneConfig(**base)


def _lean_scene(**kw) -> scenes.SceneConfig:
    """Small frames for fast smoke runs and large fleets (matches the
    tier-1 test scenes)."""
    base = dict(max_obj=6, n_points=1024, img_h=48, img_w=160,
                mean_objects=3, density_scale=4000.0)
    base.update(kw)
    return scenes.SceneConfig(**base)


register_scenario("kitti-urban", lambda: Scenario(
    name="kitti-urban", scene=_kitti_scene()))

register_scenario("smoke", lambda: Scenario(
    name="smoke", scene=_lean_scene()))

# Scenario diversity: sparse sensor (16-beam-like return budget).
register_scenario("sparse-lidar", lambda: Scenario(
    name="sparse-lidar",
    scene=_kitti_scene(n_points=4096, density_scale=2200.0)))

# Dense urban traffic: many concurrent objects per frame.
register_scenario("dense-traffic", lambda: Scenario(
    name="dense-traffic",
    scene=_kitti_scene(max_obj=20, mean_objects=12)))

# Degraded cell uplink: the worst measured trace, tighter test cadence so
# FOS reacts to drift while transfers are slow.
register_scenario("lossy-uplink", lambda: Scenario(
    name="lossy-uplink", scene=_kitti_scene(), trace="fcc1",
    sparams=scheduler.SchedulerParams(n_t=3)))

# A 16-vehicle fleet contending for one congested cell + one cloud GPU.
register_scenario("fleet-16-congested", lambda: Scenario(
    name="fleet-16-congested",
    scene=_lean_scene(n_points=2048, img_h=64, img_w=208, max_obj=8,
                      density_scale=8000.0),
    n_streams=16, trace="fcc1"))

# Heterogeneous 64-vehicle fleet: 3/4 TX2-class, 1/4 Orin-class edges
# sharing one cell and a 4-GPU cloud pool (ultra-lean frames keep the
# vmapped step cheap at S=64).
register_scenario("fleet-64-mixed", lambda: Scenario(
    name="fleet-64-mixed",
    scene=_lean_scene(n_points=512, img_h=32, img_w=104,
                      density_scale=2500.0),
    n_streams=64, trace="belgium2",
    device={"jetson_tx2": 0.75, "jetson_orin": 0.25},
    cloud=cloud_lib.CloudBatcherConfig(n_gpus=4)))

# 256 streams on a degraded cell: the congested extreme of the fleet
# family — even an 8-GPU pool queues, and the shared uplink dominates.
register_scenario("fleet-256-congested", lambda: Scenario(
    name="fleet-256-congested",
    scene=_lean_scene(n_points=256, img_h=32, img_w=104, max_obj=4,
                      mean_objects=2, density_scale=1500.0),
    n_streams=256, trace="fcc1",
    device={"jetson_tx2": 0.5, "jetson_orin": 0.5},
    cloud=cloud_lib.CloudBatcherConfig(n_gpus=8)))
