"""Runtime: netsim and the device-profile registry (numpy copies of
``repro.runtime.netsim`` and ``repro.runtime.profiles``), checkpointing,
fault tolerance (a copy of ``repro.runtime.fault``) and gradient
compression."""
