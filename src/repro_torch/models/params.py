"""Parameter definitions: shapes, logical axes and initialisers -> tensors
(``repro/models/params.py``).

Layers declare parameters as trees (nested dicts) of :class:`ParamDef`;
:func:`init_params` materialises a tree into tensors of the same structure.
The logical axes are kept so the trees compare with the JAX package's, but
nothing maps them to a mesh: ``to_pspec`` and ``default_rules`` have no
counterpart here.

The initialisers draw from an explicit ``torch.Generator`` on the target
device, leaf by leaf in the order of :func:`leaves` (sorted dict keys, as
JAX flattens a dict). Their values differ from ``jax.random``'s; tests
carry JAX's weights across with ``repro_torch.convert.params_from_jax``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Iterator, Tuple, Union

import torch

from repro_torch import device as _device

# init(generator, shape, dtype, device) -> tensor
Init = Callable[[torch.Generator, tuple, torch.dtype, torch.device],
                torch.Tensor]


def normal_init(stddev: float = 0.02) -> Init:
    def init(gen, shape, dtype, dev):
        return (torch.randn(shape, generator=gen, device=dev) * stddev
                ).to(dtype)
    return init


def zeros_init() -> Init:
    def init(gen, shape, dtype, dev):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return init


def ones_init() -> Init:
    def init(gen, shape, dtype, dev):
        return torch.ones(shape, dtype=dtype, device=dev)
    return init


def fanin_init() -> Init:
    def init(gen, shape, dtype, dev):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = (1.0 / max(fan_in, 1)) ** 0.5
        return (torch.randn(shape, generator=gen, device=dev) * std
                ).to(dtype)
    return init


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    logical_axes: tuple  # one logical name (or None) per dim
    dtype: torch.dtype = torch.float32
    init: Init = normal_init()

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} vs axes "
                             f"{self.logical_axes}")


def leaves(tree: Any, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def from_leaves(pairs: Iterable[Tuple[Tuple[str, ...], Any]]) -> dict:
    """The nested dict with the given (path, leaf) pairs."""
    out: dict = {}
    for path, x in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(defs: Any, generator: torch.Generator,
                torch_device: Union[str, torch.device] = _device.DEFAULT):
    """Materialise a ParamDef tree into tensors on ``torch_device``.

    ``generator`` must live on that device (``torch.Generator(device=...)``
    seeded by the caller). The default device is the card; without one the
    call raises.
    """
    dev = _device.resolve(torch_device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the "
                         f"parameters on {dev}")
    return from_leaves((path, d.init(generator, tuple(d.shape), d.dtype,
                                     dev)) for path, d in leaves(defs))


def param_count(defs: Any) -> int:
    return sum(math.prod(d.shape) for _, d in leaves(defs))


def param_bytes(defs: Any) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize
               for _, d in leaves(defs))

