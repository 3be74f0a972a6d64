"""Data substrate: synthetic KITTI-like scenes and LM token pipelines
(numpy copies of ``repro.data.scenes`` and ``repro.data.tokens``)."""
