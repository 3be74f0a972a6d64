"""repro_torch.api — the declarative facade over the ported Moby stack.

    from repro_torch import api

    report = api.Session(api.scenario("kitti-urban", seed=3)).run(40)
    print(report.mean_latency, report.mean_f1)

* :func:`scenario` / :func:`list_scenarios` / :func:`register_scenario` —
  named presets of :class:`Scenario`, the frozen run spec (the JAX
  package's presets, field for field);
* :class:`Session` — builds the single-stream ``MobyEngine``, or the
  orchestrated ``FleetEngine`` for ``n_streams > 1``, on ``torch_device``
  (default ``"cuda"``) and runs;
* :class:`RunReport` — the canonical packed outcome;
* :class:`ObsConfig` — observability (metrics, trace, decision audit):
  ``Session(scn, obs=ObsConfig(trace=True, metrics=True, audit=True))``
  and the report grows ``to_trace`` / ``to_prometheus`` / ``to_audit``.
  Off by default and free when off;
* scheduler policies and device profiles resolve through the same
  registries as in ``repro.api``.
"""
from repro_torch.api.scenario import (Scenario, list_scenarios,
                                      register_scenario, scenario)
from repro_torch.api.session import Session
from repro_torch.core.scheduler import (SchedulerPolicy, get_policy,
                                        list_policies, register_policy)
from repro_torch.obs import ObsConfig
from repro_torch.runtime.profiles import (DeviceProfile, ProfileVector,
                                          get_profile, list_profiles,
                                          profile_vector, register_profile,
                                          resolve_stream_devices)
from repro_torch.serving.common import FrameRecord, RunReport

__all__ = [
    "DeviceProfile", "FrameRecord", "ObsConfig", "ProfileVector",
    "RunReport", "Scenario", "SchedulerPolicy", "Session", "get_policy",
    "get_profile", "list_policies", "list_profiles", "list_scenarios",
    "profile_vector", "register_policy", "register_profile",
    "register_scenario", "resolve_stream_devices", "scenario",
]
