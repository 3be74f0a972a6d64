"""repro_torch.core — the per-frame Moby pipeline on torch tensors."""
from repro_torch.core import (  # noqa: F401
    association, box_estimation, boxes, filtration, fp, metrics, prng,
    projection, ransac, scheduler, tracking, transform)
