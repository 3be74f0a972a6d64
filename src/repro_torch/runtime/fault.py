"""Fault tolerance: failure detection, elastic re-meshing, stragglers.

On a real multi-pod deployment these hooks wrap ``jax.distributed`` and the
coordination service; in this container the transport is simulated, but the
*logic* (what the controller does on heartbeat loss, how the mesh shrinks,
how stragglers are cut off) is the deliverable and is unit-tested.

Components:
* HeartbeatMonitor  — per-host liveness with configurable timeout.
* ElasticMesh       — maps a (possibly degraded) healthy-host set onto the
                      largest valid (data, model) mesh, preserving the
                      model-axis size (TP groups must stay intact; data
                      parallelism absorbs the loss).
* StragglerPolicy   — p99-based deadline; slow hosts are marked and their
                      shards re-fetched from redundant input pipelines.
* run_elastic_loop  — restart-driver glue: detect -> checkpoint-restore ->
                      re-mesh -> continue (exercised in tests with injected
                      failures).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    healthy: bool = True


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        now = clock()
        self.hosts: Dict[int, HostState] = {
            i: HostState(i, now) for i in range(n_hosts)}

    def heartbeat(self, host_id: int):
        st = self.hosts[host_id]
        st.last_heartbeat = self.clock()
        st.healthy = True

    def sweep(self) -> List[int]:
        """Mark hosts that missed the deadline; returns newly failed ids."""
        now = self.clock()
        failed = []
        for st in self.hosts.values():
            if st.healthy and now - st.last_heartbeat > self.timeout:
                st.healthy = False
                failed.append(st.host_id)
        return failed

    def healthy_hosts(self) -> List[int]:
        return [i for i, st in self.hosts.items() if st.healthy]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    hosts: tuple

    @property
    def n_devices(self):
        return self.data * self.model


def plan_elastic_mesh(healthy_hosts: Sequence[int], devices_per_host: int,
                      model_size: int) -> MeshPlan:
    """Largest (data, model) mesh from the healthy hosts.

    The model axis is fixed (TP groups need all their shards); the data
    axis shrinks to the largest multiple the healthy devices support.
    """
    n_dev = len(healthy_hosts) * devices_per_host
    assert n_dev >= model_size, "not enough devices for one model replica"
    data = n_dev // model_size
    used_hosts = len(healthy_hosts)
    return MeshPlan(data=data, model=model_size,
                    hosts=tuple(sorted(healthy_hosts)[:used_hosts]))


class StragglerPolicy:
    """Track per-host step times; hosts beyond k x median are stragglers."""

    def __init__(self, n_hosts: int, k: float = 3.0, window: int = 20):
        self.k = k
        self.window = window
        self.times: Dict[int, List[float]] = {i: [] for i in range(n_hosts)}

    def record(self, host_id: int, step_time: float):
        ts = self.times[host_id]
        ts.append(step_time)
        if len(ts) > self.window:
            ts.pop(0)

    def stragglers(self) -> List[int]:
        import statistics
        meds = {i: statistics.median(ts) for i, ts in self.times.items() if ts}
        if not meds:
            return []
        global_med = statistics.median(meds.values())
        return [i for i, m in meds.items() if m > self.k * global_med]


@dataclasses.dataclass
class ElasticEvent:
    step: int
    kind: str          # "failure" | "remesh" | "restore" | "straggler"
    detail: str


def run_elastic_loop(n_steps: int, monitor: HeartbeatMonitor,
                     devices_per_host: int, model_size: int,
                     do_step: Callable[[int, MeshPlan], float],
                     save_fn: Callable[[int], None],
                     restore_fn: Callable[[MeshPlan], int],
                     heartbeat_fn: Callable[[int], None],
                     checkpoint_every: int = 10) -> List[ElasticEvent]:
    """Controller loop: step, checkpoint, detect failures, re-mesh, resume.

    ``do_step(step, plan)`` runs one training step on the current plan and
    returns its duration; ``restore_fn(plan)`` reloads state onto the new
    mesh and returns the step to resume from. Failure injection happens via
    the monitor/heartbeat_fn in tests.
    """
    events: List[ElasticEvent] = []
    plan = plan_elastic_mesh(monitor.healthy_hosts(), devices_per_host,
                             model_size)
    step = 0
    while step < n_steps:
        heartbeat_fn(step)
        failed = monitor.sweep()
        if failed:
            events.append(ElasticEvent(step, "failure", f"hosts={failed}"))
            plan = plan_elastic_mesh(monitor.healthy_hosts(),
                                     devices_per_host, model_size)
            events.append(ElasticEvent(
                step, "remesh", f"data={plan.data} model={plan.model}"))
            step = restore_fn(plan)
            events.append(ElasticEvent(step, "restore", f"resume@{step}"))
            continue
        do_step(step, plan)
        step += 1
        if step % checkpoint_every == 0:
            save_fn(step)
    return events
