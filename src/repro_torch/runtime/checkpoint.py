"""Checkpointing: sharded, atomic, async (``repro/runtime/checkpoint.py``).

The layout is the JAX package's, so a checkpoint that either package
writes restores in the other:

    <dir>/step_00000010.tmp/          staging (atomic rename at the end)
    <dir>/step_00000010/
        manifest.json                 step, structure, shapes, dtypes, shards
        shard_00000.npz[.zst]         leaves ``leaf_<i>``, chunked by bytes

* Leaves are flattened in ``jax.tree_util`` order: dict keys sorted,
  tuple, list and NamedTuple fields in order, ``None`` an empty subtree.
* A writer stages into ``.tmp`` and publishes with ``os.replace``; each
  shard's crc32 is in the manifest and checked on restore; ``keep`` most
  recent steps are kept.
* ``save_async`` copies every leaf to host memory before it returns (the
  train step updates the parameters in place), then writes on a thread.
* ``restore(step, like)`` returns the structure of ``like`` with each leaf
  on ``like``'s leaf's device and dtype. There is no ``shardings``
  argument: the port has no mesh.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

try:
    import zstandard as zstd
except ImportError:  # pragma: no cover
    zstd = None

_SHARD_BYTES = 256 * 1024 * 1024


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def structure(tree: Any) -> str:
    """A description of ``tree``'s structure for the manifest (``*`` a
    leaf)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={structure(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(structure(v) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf, taken now (a dtype numpy lacks, such as
    bf16, raises: the trees to save are the f32 masters and moments)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any):
        """Synchronous sharded save with atomic publish."""
        self._write(step, tree, [_host(x) for x in flatten(tree)])

    def save_async(self, step: int, tree: Any):
        """Copy every leaf to host memory now; write in the background. A
        failed write raises from the next ``wait`` (or ``save_async``)."""
        self.wait()
        host_leaves = [_host(x) for x in flatten(tree)]

        def work():
            try:
                self._write(step, tree, host_leaves)
            except BaseException as e:  # re-raised by wait()
                self._error = e
        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    # ------------------------------------------------------------------
    def _write(self, step: int, tree: Any, host_leaves):
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        shards, cur, cur_bytes = [], [], 0
        for i, leaf in enumerate(host_leaves):
            cur.append((i, leaf))
            cur_bytes += leaf.nbytes
            if cur_bytes >= _SHARD_BYTES:
                shards.append(cur)
                cur, cur_bytes = [], 0
        if cur:
            shards.append(cur)
        manifest = {
            "step": step,
            "treedef": structure(tree),
            "leaves": [{"shape": list(x.shape), "dtype": str(x.dtype)}
                       for x in host_leaves],
            "shards": [],
        }
        for si, shard in enumerate(shards):
            fname = f"shard_{si:05d}.npz.zst" if zstd else f"shard_{si:05d}.npz"
            buf = io.BytesIO()
            np.savez(buf, **{f"leaf_{i}": x for i, x in shard})
            raw = buf.getvalue()
            if zstd:
                raw = zstd.ZstdCompressor(level=3).compress(raw)
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(raw)
            manifest["shards"].append(
                {"file": fname, "leaves": [i for i, _ in shard],
                 "crc32": zlib.crc32(raw) & 0xFFFFFFFF})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        return sorted(int(d[5:]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like: Any) -> Any:
        """The checkpoint of ``step`` (the latest if None) in the structure
        of ``like``: a tensor leaf of ``like`` gives a tensor on its device
        and of its dtype, any other leaf a numpy array of its dtype."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        n_leaves = len(manifest["leaves"])
        host = [None] * n_leaves
        for shard in manifest["shards"]:
            with open(os.path.join(path, shard["file"]), "rb") as f:
                raw = f.read()
            if (zlib.crc32(raw) & 0xFFFFFFFF) != shard["crc32"]:
                raise ValueError(f"corrupt shard {shard['file']} of step "
                                 f"{step}")
            if shard["file"].endswith(".zst"):
                if zstd is None:
                    raise RuntimeError(f"{shard['file']} is zstd-compressed "
                                       f"and zstandard is not installed")
                raw = zstd.ZstdDecompressor().decompress(raw)
            data = np.load(io.BytesIO(raw))
            for i in shard["leaves"]:
                host[i] = data[f"leaf_{i}"]
        targets = flatten(like)
        if len(targets) != n_leaves:
            raise ValueError(f"tree mismatch: {len(targets)} leaves vs "
                             f"{n_leaves} in the checkpoint")
        out = []
        for tgt, val in zip(targets, host):
            if isinstance(tgt, torch.Tensor):
                out.append(torch.as_tensor(val).to(device=tgt.device,
                                                   dtype=tgt.dtype))
            elif hasattr(tgt, "dtype"):
                out.append(val.astype(tgt.dtype))
            else:
                out.append(val)
        return unflatten(like, iter(out))
