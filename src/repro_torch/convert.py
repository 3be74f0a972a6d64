"""Carry the JAX package's state across into the port's tensors.

The JAX package's state and parameters are NamedTuples of arrays and plain
values. Given as numpy arrays (``np.asarray`` of every leaf, and
``jax.random.key_data(key)`` for a typed PRNG key), they convert here into
the port's NamedTuples, matched by class and field names — duck-typed, so
nothing of JAX or ``repro`` is imported:

* ``MobyState`` (``tracks``, ``avg_size``, ``key``): the key as the (2,)
  uint32 words of ``key_data``;
* ``TrackState``, ``SchedulerState``, ``Calibration``;
* any NamedTuple of parameters (``TransformParams``, ``RansacParams``, ...),
  whose fields are plain values; the JAX package's ``backend`` field has no
  counterpart in the port and is dropped.

Floats become float32, integers int64 (the port's index type; the PRNG
key's 32-bit words included) and bools stay bool. Moby's serving path has
no learned weights: this state is what makes both sides compute the same
thing from any frame.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.core import (box_estimation, filtration, projection, ransac,
                              scheduler, tracking, transform)

# Port NamedTuples by class name; a JAX-side value converts into the class
# of the same name.
_TYPES = {cls.__name__: cls for cls in (
    transform.MobyState, transform.TransformParams, tracking.TrackState,
    tracking.TrackerParams, scheduler.SchedulerState,
    scheduler.SchedulerParams, projection.Calibration,
    filtration.FiltrationParams, ransac.RansacParams,
    box_estimation.BoxEstParams)}


def to_tensor(a: Any, device: Union[str, torch.device] = "cpu"
              ) -> torch.Tensor:
    """One array leaf: float -> float32, integer -> int64, bool -> bool."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        out = a
    elif np.issubdtype(a.dtype, np.integer):
        out = a.astype(np.int64)
    elif np.issubdtype(a.dtype, np.floating):
        out = a.astype(np.float32)
    else:
        raise TypeError(f"cannot convert an array of dtype {a.dtype}")
    # A copy: arrays read back from JAX are read-only.
    return torch.tensor(out, device=device)


def _is_array(x: Any) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def from_jax(value: Any, device: Union[str, torch.device] = "cpu") -> Any:
    """Convert a JAX-side NamedTuple (of numpy arrays and plain values) into
    the port's NamedTuple of the same class name, recursively. Array leaves
    become tensors on ``device``; plain Python values pass through."""
    if _is_array(value):
        return to_tensor(value, device)
    if not (isinstance(value, tuple) and hasattr(value, "_fields")):
        return value
    name = type(value).__name__
    if name not in _TYPES:
        raise TypeError(f"no port counterpart for {name}; known: "
                        f"{sorted(_TYPES)}")
    cls = _TYPES[name]
    fields = dict(zip(value._fields, value))
    unknown = set(fields) - set(cls._fields) - {"backend"}
    if unknown:
        raise TypeError(f"{name} has fields {sorted(unknown)} the port's "
                        f"{name} lacks")
    kwargs = {k: from_jax(v, device) for k, v in fields.items()
              if k in cls._fields}
    if name == "Calibration":
        kwargs["height"] = int(kwargs["height"])
        kwargs["width"] = int(kwargs["width"])
    return cls(**kwargs)


def to_numpy(value: Any) -> Any:
    """The port's NamedTuples (or tensors) back to numpy, recursively."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(to_numpy(v) for v in value))
    return value
