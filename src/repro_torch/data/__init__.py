"""Host-side scene simulation (a numpy copy of ``repro.data.scenes``)."""
