"""Fleet serving: batched multi-stream Moby (port of ``repro.fleet``).

S concurrent vehicle streams advance through one step per frame (a
leading stream axis on every core function, both frame treatments
computed and selected per stream), contending for a shared cell uplink
and a batching cloud detector. See fleet.engine.FleetEngine: ``run``
(orchestrated) and ``run_scan`` (scan mode, fleet.step.FleetScan: a CUDA
graph of the frame on the card).
"""
from repro_torch.fleet.cloud import CloudBatcher, CloudBatcherConfig
from repro_torch.fleet.engine import FleetEngine
from repro_torch.fleet.step import (FleetState, FrameInputs, init_fleet_state,
                                    make_fleet_step)

__all__ = [
    "CloudBatcher", "CloudBatcherConfig", "FleetEngine", "FleetState",
    "FrameInputs", "init_fleet_state", "make_fleet_step",
]
