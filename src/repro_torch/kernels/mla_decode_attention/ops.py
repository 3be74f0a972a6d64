"""Wrapper of the MLA decode attention kernel
(``csrc/mla_decode_attention.cu``): a port-only op, the absorbed attention
of ``repro/models/mla.py::mla_decode_apply`` over the compressed cache.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel (a pass over the cache and a merge of its partials,
one launch of the C entry point), or the call raises. ``launches`` counts
those launches, ``route_launches`` the same by instance. ``route`` names
the instance: ``"tc"`` (bf16 at (R, P) = (512, 64): wgmma fed by TMA, 64
heads a CTA, a cluster of two CTAs above 64 heads), ``"tf32x3"`` (f32 at
(512, 64): 3xTF32 mma.sync fed by cp.async, 16 heads a CTA) or ``"simt"``
(f32 and bf16 at SMOKE's (16, 8): 8 heads a block).

The kernel reads its operands through their strides (the last dim
contiguous) and ``lengths`` on the card, with no host sync. The
instances at (512, 64) copy by TMA, cp.async and 16-byte loads, so there
every base address and byte stride must be a multiple of 16: the wrapper
checks and raises, it never copies. The scratch of the partials (maxima,
sums and accumulators, f32) is allocated here: at (512, 64) ``runs + B``
slots of (H, R), ``runs`` the clusters (``tc``) or the groups of CTAs
(``tf32x3``) that fit on the card at once; for the SIMT instance
``n_split`` splits a request.

``plan`` is the schedule of both (512, 64) instances in Python (the
kernel computes the same on the device from ``lengths``): every request's
live tiles (64 positions for ``tc``, 32 for ``tf32x3``), in request order,
cut into equal runs; ``merge_clusters`` is which runs' partials the merge
reads for a request.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.mla_decode_attention import ref as _ref

launches = 0
route_launches = {"tc": 0, "tf32x3": 0, "simt": 0}

DTYPES = (torch.float32, torch.bfloat16)
# (R, P): the latent (kv_lora) and rope dims of deepseek-v2 at full width
# and at SMOKE.
DIMS = ((512, 64), (16, 8))
MAX_HEADS = 128
# Query heads a CTA of the tensor-core instance serves (kHeads in its
# source); above it a cluster of two CTAs shares each tile.
TC_HEADS = 64
# Positions a tile of the tensor-core instance: the schedule's unit.
TC_TILE = 64
# The tf32x3 instance: heads a CTA, positions a tile (its schedule's unit).
TF_HEADS = 16
TF_TILE = 32
# The SIMT instance: heads a block, positions a tile (a split takes whole
# tiles), blocks an SM that n_splits aims at.
SIMT_HEADS = 8
SIMT_TILE = 32
WAVES = 4


def route(dtype: torch.dtype, r: int, p: int) -> str:
    """The instance that takes a CUDA call: ``"tc"`` (bf16 at (512, 64)),
    ``"tf32x3"`` (f32 at (512, 64)), ``"simt"`` (both dtypes at (16, 8));
    anything else raises."""
    if dtype not in DTYPES:
        raise TypeError(f"mla_decode_attention: dtype {dtype}, the kernel "
                        f"takes {DTYPES}")
    if (r, p) not in DIMS:
        raise ValueError(f"mla_decode_attention: (latent, rope) dims "
                         f"({r}, {p}), the kernel takes {DIMS}")
    if (r, p) != DIMS[0]:
        return "simt"
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


def cluster_size(h: int) -> int:
    """CTAs a cluster of the tensor-core instance: 2 above 64 heads."""
    return 1 if h <= TC_HEADS else 2


def live_tiles(length: int, s: int, tile: int = TC_TILE) -> int:
    """Tiles of ``tile`` positions (the tensor-core instance's 64 by
    default) that hold a request's live positions [0, min(length, S))."""
    return -(-min(max(length, 0), s) // tile)


def run_start(c: int, n_clusters: int, total: int) -> int:
    """First global tile of cluster c's run: runs differ by at most a
    tile."""
    return c * total // n_clusters


def plan(lengths: Sequence[int], s: int, n_clusters: int,
         tile: int = TC_TILE) -> List[Tuple[int, int, int, int]]:
    """The schedule of the (512, 64) instances: segments (run, request,
    first tile, end tile) in order, tiles of ``tile`` positions counted
    within the request (64, the tensor-core instance's clusters, by
    default; ``TF_TILE`` for the tf32x3 instance's runs). Run c takes
    global tiles [run_start(c), run_start(c + 1)) of all requests' live
    tiles laid end to end; its stretch of request b is a segment, whose
    partial goes to slot c + b."""
    n = [live_tiles(x, s, tile) for x in lengths]
    total, segs = sum(n), []
    for c in range(n_clusters):
        lo, hi = run_start(c, n_clusters, total), \
            run_start(c + 1, n_clusters, total)
        first = 0
        for b, nb in enumerate(n):
            j0, j1 = max(lo - first, 0), min(nb, hi - first)
            if j1 > j0:
                segs.append((c, b, j0, j1))
            first += nb
    return segs


def merge_clusters(lengths: Sequence[int], s: int, n_clusters: int,
                   tile: int = TC_TILE) -> List[List[int]]:
    """For each request, the runs (clusters) that hold its tiles, as the
    merge finds them (none for a request with no live position): those
    from the run of its first global tile to that of its last (the run of
    tile i being the last c with run_start(c) <= i) that are not empty
    (with more runs than tiles, some are)."""
    n = [live_tiles(x, s, tile) for x in lengths]
    total, out, first = sum(n), [], 0
    for nb in n:
        out.append([])
        if nb:
            lo, hi = (-(-(i + 1) * n_clusters // total) - 1
                      for i in (first, first + nb - 1))
            out[-1] = [c for c in range(lo, hi + 1)
                       if run_start(c, n_clusters, total)
                       < run_start(c + 1, n_clusters, total)]
        first += nb
    return out


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _clusters(index: int, size: int) -> int:
    """Clusters of ``size`` CTAs of the tensor-core instance that fit on
    card ``index`` at once (asked of the CUDA runtime)."""
    with torch.cuda.device(index):
        n = _build.load().moby_mla_decode_clusters(TC_HEADS * size)
    if n <= 0:
        _build.check(-n or 1, "mla_decode_attention (clusters)")
    return n


@functools.cache
def _runs(index: int, h: int) -> int:
    """Runs of the tf32x3 instance at ``h`` heads on card ``index``: the
    groups of ceil(h / 16) CTAs that fit on it at once (asked of the CUDA
    runtime)."""
    with torch.cuda.device(index):
        n = _build.load().moby_mla_decode_runs(h)
    if n <= 0:
        _build.check(-n or 1, "mla_decode_attention (runs)")
    return n


def tf_runs(h: int, sms: int, ctas_per_sm: int = 1) -> int:
    """The tf32x3 instance's runs on a card of ``sms`` SMs holding
    ``ctas_per_sm`` of its CTAs each (one on an H100): what
    ``moby_mla_decode_runs`` computes from the runtime's occupancy."""
    return max(1, ctas_per_sm * sms // -(-h // TF_HEADS))


def n_splits(b: int, h: int, s: int, sms: int) -> int:
    """The SIMT instance's splits of each request's positions: about four
    blocks an SM over the B x ceil(H / 8) (request, head group) pairs, at
    least 1 and at most a split a tile of S."""
    pairs = b * -(-h // SIMT_HEADS)
    return max(1, min(WAVES * sms // max(pairs, 1), -(-s // SIMT_TILE)))


def mla_decode_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                         ckv: torch.Tensor, krope: torch.Tensor,
                         lengths: torch.Tensor, scale: float
                         ) -> torch.Tensor:
    """q_lat (B, H, R), q_rope (B, H, P), ckv (B, S, R), krope (B, S, P),
    lengths (B,) int32 -> o_lat (B, H, R) in the inputs' dtype: softmax
    over positions [0, min(lengths, S)) of (q_lat . ckv + q_rope . krope)
    * scale, times ckv."""
    global launches
    if _launch.dispatch_device("mla_decode_attention", q_lat) == "cpu":
        return _ref.mla_decode_attention_ref(q_lat, q_rope, ckv, krope,
                                             lengths, scale)
    b, h, r = q_lat.shape
    s, p = ckv.shape[1], krope.shape[-1]
    dev, dt = q_lat.device, q_lat.dtype
    path = route(dt, r, p)
    for name, t, shape in (("q_lat", q_lat, (b, h, r)),
                           ("q_rope", q_rope, (b, h, p)),
                           ("ckv", ckv, (b, s, r)),
                           ("krope", krope, (b, s, p))):
        _launch.check_cuda("mla_decode_attention", name, t, dt, shape, dev,
                           strided=True)
        if path != "simt" and (t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:2])):
            raise ValueError(f"mla_decode_attention: {name} (address "
                             f"{t.data_ptr():#x}, strides {t.stride()}) is "
                             f"not 16-byte aligned, as the {path} "
                             f"instance's 16-byte copies need")
    _launch.check_cuda("mla_decode_attention", "lengths", lengths,
                       torch.int32, (b,), dev)
    if h > MAX_HEADS:
        raise ValueError(f"mla_decode_attention: {h} heads, the kernel "
                         f"takes at most {MAX_HEADS}")
    if b > 65535:
        raise ValueError(f"mla_decode_attention: {b} requests exceed the "
                         f"kernel's grid (65,535)")
    if path != "simt":
        n_part = _clusters(dev.index, cluster_size(h)) if path == "tc" \
            else _runs(dev.index, h)
        rows = (n_part + b, h)
    else:
        n_part = n_splits(b, h, s, _sm_count(dev.index))
        rows = (n_part, b * h)
    out = torch.empty((b, h, r), dtype=dt, device=dev)
    part_m = torch.empty(rows, dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((*rows, r), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 8)(*q_lat.stride()[:2],
                                      *q_rope.stride()[:2],
                                      *ckv.stride()[:2], *krope.stride()[:2])
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.moby_mla_decode_attention(
            q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
            krope.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            strides, b, h, s, r, p, n_part, int(dt == torch.bfloat16),
            float(scale), _launch.stream_handle(dev))
    _build.check(code, f"mla_decode_attention ({path})")
    launches += 1
    route_launches[path] += 1
    return out
