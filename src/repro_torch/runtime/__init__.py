"""Modeled network and device profiles (numpy copies of
``repro.runtime.netsim`` and ``repro.runtime.profiles``)."""
