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

The language models' and the detectors' weights convert by structure
instead: :func:`params_from_jax`, :func:`detector_params_from_jax` and
:func:`detector2d_params_from_jax` take the parameter tree of
``init_params`` (nested dicts of numpy arrays), check it against the
port's ``lm.model_defs``, ``detector3d.detector_defs`` or
``detector2d.detector2d_defs`` and keep it float32;
:func:`decode_state_from_jax` takes a ``DecodeState`` and keeps the
caches' dtype and ``cache_pos`` int32.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.core import (box_estimation, filtration, projection, ransac,
                              scheduler, tracking, transform)
from repro_torch.models import decode, detector2d, detector3d, lm
from repro_torch.models import params as params_mod

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


def _float_tensor(a: Any, device: Union[str, torch.device]
                  ) -> torch.Tensor:
    """A float leaf in its own dtype; bfloat16 (numpy's ``ml_dtypes``
    type, which torch cannot read) goes through float32 exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32),
                            device=device).to(torch.bfloat16)
    if not np.issubdtype(a.dtype, np.floating):
        raise TypeError(f"expected a float array, got {a.dtype}")
    return torch.tensor(a, device=device)


def _tree_from_jax(tree: Any, defs: Any, what: str,
                   device: Union[str, torch.device]) -> dict:
    want = {p: tuple(d.shape) for p, d in params_mod.leaves(defs)}
    got = {p: tuple(np.shape(a)) for p, a in params_mod.leaves(tree)}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"{what}: parameter tree differs from the port's "
                         f"definitions at {diff}")
    return params_mod.tree_map(lambda a: to_tensor(a, device), tree)


def params_from_jax(tree: Any, cfg: Any,
                    device: Union[str, torch.device] = "cpu") -> dict:
    """The JAX package's LM parameter tree (nested dicts of numpy arrays,
    ``np.asarray`` of every leaf) -> the port's tree of float32 tensors on
    ``device``. Raises unless the paths and shapes are those of
    ``lm.model_defs(cfg)``."""
    return _tree_from_jax(tree, lm.model_defs(cfg), cfg.name, device)


def detector_params_from_jax(tree: Any, cfg: Any,
                             device: Union[str, torch.device] = "cpu"
                             ) -> dict:
    """The 3D detector's JAX parameter tree (numpy leaves) -> float32
    tensors on ``device``; raises unless it matches
    ``detector3d.detector_defs(cfg)`` path for path, shape for shape."""
    return _tree_from_jax(tree, detector3d.detector_defs(cfg), "detector3d",
                          device)


def detector2d_params_from_jax(tree: Any, cfg: Any,
                               device: Union[str, torch.device] = "cpu"
                               ) -> dict:
    """The 2D detector's JAX parameter tree -> float32 tensors, checked
    against ``detector2d.detector2d_defs(cfg)``."""
    return _tree_from_jax(tree, detector2d.detector2d_defs(cfg),
                          "detector2d", device)


def decode_state_from_jax(state: Any,
                          device: Union[str, torch.device] = "cpu"):
    """A JAX ``DecodeState`` (caches as numpy arrays) -> the port's
    ``DecodeState``: caches and ``enc_out`` in their dtype, ``cache_pos``
    int32. The moe family's nested caches keep their layout, ``"dense":
    None`` included where the model has no leading dense layers, MLA's
    compressed caches (``{"ckv", "krope"}`` a stack) theirs and the
    encoder-decoder's (``{"self": {"k", "v"}, "cross_k", "cross_v"}``)
    theirs."""
    def leaf(a):
        return None if a is None else _float_tensor(a, device)
    caches = params_mod.tree_map(leaf, dict(state.caches))
    pos = torch.tensor(np.asarray(state.cache_pos, np.int32), device=device)
    return decode.DecodeState(caches=caches, cache_pos=pos,
                              enc_out=leaf(state.enc_out))


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
