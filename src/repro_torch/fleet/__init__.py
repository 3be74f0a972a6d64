"""The cloud batcher configuration (a copy of ``repro.fleet.cloud``); the
fleet engine itself waits for a later slice of the port."""
