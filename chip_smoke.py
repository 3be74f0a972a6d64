#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) serves
Moby (one stream and a fleet), the dense LMs and the PointPillars detector
on an NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels flash_attention,pillar_scatter

With ``--kernels`` it builds and runs phase 3 for the named kernels only
(their checks, times and profiles) and stops there, printing no result
line: a short bring-up call for a kernel being worked on.

Needs one CUDA card, ``nvcc`` (the kernels build from ``src/repro_torch/csrc``
on first use) and ``nvidia-smi``; imports nothing of JAX or of the JAX
package ``repro``. It exits non-zero, before printing any result, when torch
sees no card or the port's sources are not beside the script. Phases, each
fatal on failure:

1. the card's name and power limit, torch and CUDA versions;
2. the kernel build (``nvcc`` for ``sm_90a``, one process per source),
   timed;
3. the launch floor (a one-element ``zero_()`` timed as the kernels are),
   then each kernel against its plain PyTorch version on the card, at the
   serving paths' shapes (and a few others: K1 ``point_proj``'s two
   instances, uv, depth, visible and flat (``point_proj``) and the labels
   alone (``point_proj_labels``, the serving path's launch), each bit for
   bit at 122,880 points, at an unaligned base (a points view 12 bytes
   past a 16-byte boundary), at N = 77, the
   full one also at 1,000,003 points, the labels one also on kitti-urban
   frame 0's own points, instance-id image and calibration (timed too,
   its visible share printed), and with a stream axis (points (S, N, 3),
   label images (S, H, W): the fleet's one launch a frame) bit for bit
   against the plain version and, stream by stream, the 2-D kernel, at
   the three fleets' shapes (timed: the full-width fleet's 16 x 122,880
   points, fleet-16-congested, fleet-64-mixed), S = 1 and a ragged S = 3;
   K2 ``iou2d`` bit for bit at 24x12, 130x250,
   1x1 and on each side of its one-CTA limit (32x32, 33x33), and with a
   stream axis ((S, T, 4) x (S, D, 4), the same two checks) at the
   fleets' shapes (timed: 16 x 24x12, 16 x 16x8, 64 x 12x6), S = 1, S = 3
   at 33x33 and S = 64 at 130x250; K3
   ``ransac_score`` also at
   one point and one plane, with an object of invalid points, at 4,000
   points an object and at the fleets' S x O objects (timed: 192, 128 and
   384 objects); the attention kernels in f32 at
   2e-5, and in bf16 against the plain version's f32 result on the same
   bf16 inputs, each value within half a bf16 ulp, plus, for the
   tensor-core flash route, which rounds p to bf16 for its P.V product, an
   allowance for that rounding; see ``attention_close``; the worst
   difference over its limit is printed for every case), flash attention
   once per route (``flash_attention``: the 3xTF32 kernel, f32 and bf16
   at hd 16-64, timed at LM B's shape and, in f32, at LM C's prefill
   shape; ``flash_attention_tc``: the bf16 tensor-core kernel, hd 128,
   timed at LM C's prefill shape), then timed with CUDA events after a
   warm-up:
   device time per call from replays of a CUDA graph of up to 50 calls
   (median of 20), and the eager per-call time; the attention kernels'
   plain versions eagerly (a few calls: the flash one holds a 4.3 GB score
   tensor at the prefill shape), and PyTorch's
   ``scaled_dot_product_attention`` on the same inputs as their library
   yardstick (timed here, used nowhere in the port; the kernels it ran
   are named from a profile); K4 ``pillar_scatter`` forward (equal by
   value) and backward (bit for bit) at Det B's shape (the real pillar ids
   of a kitti-urban frame at 122,880 points), dense collisions, all points
   masked out, planted ties, special values, every point in one pillar,
   points sorted by pillar, rows of 7 and of 40 channels and rows at an
   unaligned base, beside ``scatter_reduce(..., "amax")`` and autograd's
   gradient of it, with each direction's passes timed from a profile; the
   auction kernel (no Pallas counterpart: JAX's ``lax.while_loop``
   auction) bit for bit in the assignment, the prices and the rounds
   against its plain version, with the assignment's total benefit within
   n x 1e-4 of the optimum (``hungarian_numpy``'s up to 128 persons,
   SciPy's ``linear_sum_assignment`` above, the two held equal at 129), on
   the benefits of a kitti-urban transform frame and of the full-width
   fleet's transform branch (both recorded from the serving path on the
   card, both timed, its plain version eagerly, as it synchronises, with
   the time of a round and of a skeleton of the same rounds that only
   synchronises the warp and tests for the end), seeded benefits on the
   1e-3 grid with many exact ties at n = 1, 2, 12, 16, 24, 31, 32, 33, 40,
   64 and the row instances' cap (128) with batch 1, 16, 64 and 256, rows
   and columns of zeros, every row equal (all persons bid on one object)
   and all zeros, each of these timed too (device ms and us a round; the
   plain version too at n = 40 and 128, one auction); its wide instance
   (``auction_wide``, n > 128) the same way on the benefits of a
   kitti-urban transform frame with max_obj = 80 (n = 160, recorded on
   the card, measured in full) and on seeded tied benefits at n = 129,
   256, 512 and 1024 (batch 1 and 16), rows and columns of zeros and every
   row equal at n = 256, these at 20,000 rounds a phase (their ties need
   more than 4,000 from n = 512), each timed;
4. the Moby serving path at KITTI's own size (``kitti-urban`` at 122,880
   points and a 375x1242 image, 24 frames) on the card, with every
   kernel's launch count checked against the run's frame kinds (K1's
   labels instance once a transform frame and its full instance never,
   K2 and the auction once a frame, K3 once a transform frame), after a
   2-frame warm-up; then a torch.profiler window over 4 frames (device busy
   share, device ops per frame, the ops with the most device time);
5. the same run on the CPU in this process: frame kinds equal, floats within
   the golden tolerance; then kitti-urban at KITTI's size with max_obj = 80
   (auctions of n = 160 persons: the wide instance once a frame, the row
   instances never, checked) on the card after a warm-up, 6 frames, held
   to its CPU run the same way; then the observability hooks on the card
   (``Session(obs=ObsConfig(...))``): kitti-urban, 8 frames, unobserved,
   with metrics and the trace, and with every switch on, each counting
   its synchronising CUDA calls under ``set_sync_debug_mode("warn")``: the
   observed reports equal the unobserved one bit for bit, metrics and the
   trace add no synchronisation (fatal), the all-on run's audit rows and
   modelled trace lanes equal its CPU run's at the golden tolerance; the
   medians of the host spans ``moby/transform_step`` (the host's enqueue)
   and ``moby/frame_stats_fetch`` (its wait on the card) beside the
   transform frame's wall ms, observed and not; fleet-16-congested
   orchestrated with every switch on (4 frames, bit for bit with its
   unobserved run, audit rows, cloud and uplink records) and in scan mode
   with metrics and the trace (the first ``fleet/scan_dispatch`` span
   marked compiled: the graph capture), scan mode's refusal of the audit;
   one ``{"observability": ...}`` JSON line;
6. the fleet, orchestrated mode (``api.Session`` builds the port's
   ``FleetEngine`` for ``n_streams > 1``): ``fleet-16-congested`` (8
   frames), ``fleet-64-mixed`` (6 frames; TX2/Orin edges, a 4-GPU cloud
   pool), each as the preset defines it, and the full-width fleet,
   ``kitti-urban`` with 16 streams at KITTI's own size on the ``fcc1``
   cell (8 frames), each after a 2-frame warm-up, its tapes recorded
   before the timed run; the launches checked per fleet frame (K1's
   labels instance 1, K2 and the auction 2: the anchor and the transform
   branch, K3 1, the others 0); wall ms per fleet frame and per
   stream-frame (median),
   the share spent copying the frame's inputs to the card, peak device
   memory; a torch.profiler window over 2 frames of the full-width fleet;
   each run held to the port's CPU run of the same preset in this
   process (the full-width fleet's first 4 frames): kinds exact, floats
   within the golden tolerance; one ``{"fleets": [...]}`` JSON line;
   then the same three fleets in scan mode (``run(scan=True)``: the tape
   copied to the card once, one frame of the body captured in a CUDA
   graph and replayed a frame under sync debug mode "error", one fetch),
   each after a warm-up: the captured frame's launches checked (as a
   fleet frame's), replays of a second capture bit for bit against the
   same body run eagerly on the card, a profiled replay window (busy
   share, device ops a fleet frame, each kernel's launches by name), wall
   ms a fleet frame and a stream-frame, the tape's copy, warm-up and
   capture times, peak memory, and the rows held to the port's CPU scan
   (the full-width fleet's first 4 frames); ``fleet-256-congested`` (4
   frames) against ``tests/goldens/fleet-256-congested-scan.csv`` (stream,
   frame, kind, device exact; the modelled times at the golden tolerance)
   and, every column, against its CPU scan; one ``{"scans": [...]}`` JSON
   line;
7. the ``smoke`` preset on the card against ``tests/goldens/smoke.csv``;
8. LM A, the card against JAX: qwen2.5-3B SMOKE in f32 with the weights of
   ``tests/goldens/lm_qwen2_5_3b_smoke.npz``, prefill and four decode
   steps within 1e-5 of the golden's logits;
9. LM B, the card against the port's CPU run at full width: qwen2.5-3B with
   2 of its 36 layers in f32 (attention weights rescaled so the scores are
   of order 1, see ``check_lm``), prefill at B=2, S=256 and four decode
   steps (max_len 512), logits within 1e-4; the launches of A and B
   checked (the 3xTF32 flash route and decode attention, one a layer);
10. LM C, serving qwen2.5-3B at full width (36 layers, bf16, seeded random
   weights): prefill at B=1, S=8192 (median of 3 after a warm-up) and 32
   greedy decode steps at B=16 over a 32,768-position cache filled from a
   seeded generator with ragged positions, every kernel's launch count
   checked (the bf16 tensor-core flash route 36 per prefill and the
   3xTF32 route none, decode 36 per step); ms per prefill and
   per step, decode tokens/s, peak device memory, and a torch.profiler
   window over 4 decode steps;
11. Det A, the card against JAX: the PointPillars detector at a small
   config (32x32 pillars) with the weights and frame of
   ``tests/goldens/det3d_smoke.npz``: forward, loss, every gradient,
   detect and three AdamW steps at the CPU parity tests' tolerances;
12. Det B, the detector at full width (128x128 pillars, feat 32, backbone
   (32, 64, 128), seeded random weights) on 24 kitti-urban frames at
   122,880 points: detect per frame and 8 training steps (loss, backward,
   AdamW) after a warm-up, K4's launches checked (one forward a forward
   pass, one backward a step), peak device memory, a torch.profiler window
   over 4 detect calls; then 2 frames on the CPU against the card;
13. one ``{"kernels": [...]}`` JSON line, the card line again, and last the
   ``{"ok": true, "device": ...}`` line.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "goldens" / "smoke.csv"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
# the float32 rate outside the tensor cores and the dense bf16 and TF32
# tensor rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_TF32_PER_S = 495e12

# The golden CSV tolerance (tests/test_goldens.py).
RTOL, ATOL = 1e-4, 1e-5
FLOAT_COLS = ("latency_s", "onboard_s", "f1", "precision", "recall")

KITTI = dict(n_points=122880, img_h=375, img_w=1242)
KITTI_FRAMES = 24

# The fleet phase: the two fleet presets as they are defined, and the
# full-width fleet: 16 kitti-urban vehicles at KITTI's own size on the
# congested fcc1 cell. (name, scenario overrides, frames on the card,
# frames of the CPU run it is held to, timing keys of its phase-3 cases.)
FLEETS = (
    ("fleet-16-congested", {}, 8, 8, "fleet_16"),
    ("fleet-64-mixed", {}, 6, 6, "fleet_64"),
    ("kitti-urban", dict(n_streams=16, trace="fcc1", **KITTI), 8, 4,
     "fleet_kitti"),
)
FLEET_WARMUP, FLEET_PROFILE_FRAMES = 2, 2
# The kernels of the Moby serving path (one stream, a fleet, scan mode).
MOBY_KERNELS = ("point_proj", "point_proj_labels", "iou2d", "ransac_score",
                "auction", "auction_wide")
# The single-stream path past 128 persons an auction: kitti-urban at KITTI's
# size with max_obj = 80 (n = 160), on the card and on the CPU.
WIDE_MAX_OBJ, WIDE_FRAMES = 80, 6
# The observability phase: kitti-urban (single stream) and
# fleet-16-congested frames observed on the card.
OBS_FRAMES, OBS_FLEET_FRAMES = 8, 4

# LM serving, qwen2.5-3B at full width. The repo's prefill_32k (S 32768,
# batch 32) and decode_32k (batch 128) shapes are cut to what one card
# holds beside the weights: see PERF.md.
LM_ARCH = "qwen2_5_3b"
LM_GOLDEN = ROOT / "tests" / "goldens" / "lm_qwen2_5_3b_smoke.npz"
PREFILL_B, PREFILL_S = 1, 8192
DECODE_B, DECODE_MAX, DECODE_STEPS = 16, 32768, 32
DECODE_POS_LO = 8192
# LM B: full width with 2 layers in f32, prefill at B 2, S 256 (the 3xTF32
# flash route's shape on the main path).
LM_B_BATCH, LM_B_S, LM_B_LAYERS = 2, 256, 2

# The PointPillars detector (models/detector3d.py). Det A holds the card to
# the JAX golden at a small config; Det B runs the default config (128x128
# pillars, feat 32, backbone (32, 64, 128)) on kitti-urban frames.
DET_GOLDEN = ROOT / "tests" / "goldens" / "det3d_smoke.npz"
DET_FRAMES, DET_STEPS, DET_CPU_FRAMES = 24, 8, 2

KERNELS = {
    # K1's two instances: the full outputs, and the labels alone (the
    # serving path's project_and_label).
    "point_proj": ("src/repro_torch/csrc/point_proj.cu",
                   "src/repro/kernels/point_proj/point_proj.py:43"),
    "point_proj_labels": ("src/repro_torch/csrc/point_proj.cu",
                          "src/repro/kernels/point_proj/point_proj.py:43"),
    "iou2d": ("src/repro_torch/csrc/iou2d.cu",
              "src/repro/kernels/iou2d/iou2d.py:36"),
    "ransac_score": ("src/repro_torch/csrc/ransac_score.cu",
                     "src/repro/kernels/ransac_score/ransac_score.py:34"),
    # The 3xTF32 route (f32; bf16 at head dims 16-64).
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:78"),
    # The same TPU kernel's bf16 tensor-core route (head dim 128).
    "flash_attention_tc": (
        "src/repro_torch/csrc/flash_attention_tc.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:78"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:63"),
    "pillar_scatter": (
        "src/repro_torch/csrc/pillar_scatter.cu",
        "src/repro/kernels/pillar_scatter/pillar_scatter.py:50"),
    # The gradient: the VJP around the Pallas call (repro/ops/api.py).
    "pillar_scatter_bwd": ("src/repro_torch/csrc/pillar_scatter.cu",
                           "src/repro/ops/api.py:105"),
    # No Pallas counterpart: the association's lax.while_loop auction; its
    # wide instance takes n > 128.
    "auction": ("src/repro_torch/csrc/auction.cu",
                "src/repro/core/association.py:121"),
    "auction_wide": ("src/repro_torch/csrc/auction.cu",
                     "src/repro/core/association.py:121"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def eager_ms(fn, torch, runs: int = 100, warmup: int = 10) -> float:
    """Median of ``runs`` CUDA-event timings of one eager call each: what a
    Python caller waits per call, launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def graph_ms(fn, torch, reps: int = 50, replays: int = 20) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph, the
    median over ``replays`` event-timed replays divided by ``reps``. The
    inputs stay in the 50 MB L2 cache between calls (warm-cache time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def profile_window(torch, label: str, run, n: int, unit: str) -> str:
    """A torch.profiler window over ``run()`` (``n`` ``unit``s of work):
    device busy share of the window, device ops per unit, and the ops (and
    kernels) with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    if not busy_us:
        return "profile: no device time in the trace (not measured)"
    launches = sum(e.count for e in dev)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)[:6]
    top = ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.1f} ms "
                    f"x{e.count}" for e in ops)
    kern = sorted(dev, key=lambda e: e.self_device_time_total,
                  reverse=True)[:4]
    top_k = ", ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms"
                      f" x{e.count}" for e in kern)
    return (f"profile {label} x{n} {unit}s: wall "
            f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
            f"({100 * busy_us / wall_us:.1f}% of wall), "
            f"{launches / n:.0f} device ops/{unit}; top device time: "
            f"{top}; top kernels: {top_k}")


def device_kernels(torch, fn, calls: int = 10):
    """Device time per call of each kernel (and memset) that ``fn()``
    launches, from a torch.profiler window over ``calls`` calls after a
    warm-up: [(name, ms a call, launches a call)], the longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    return sorted(((e.key, e.self_device_time_total / 1e3 / calls,
                    e.count / calls) for e in dev), key=lambda x: -x[1])


def kernels_line(label: str, kerns) -> str:
    if not kerns:
        return f"profile {label}: no device time in the trace (not measured)"
    return f"profile {label}: " + "; ".join(
        f"{name[:90]} {ms:.5f} ms x{n:g}" for name, ms, n in kerns)


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def on_card(torch, dev, pts, unaligned: bool):
    """(N, 3) numpy points on the card: contiguous, or a contiguous view
    one row into a larger tensor (``big[1:]``, a base 12 bytes past a
    16-byte boundary)."""
    if not unaligned:
        return torch.from_numpy(pts).to(dev)
    big = torch.zeros((len(pts) + 1, 3), dtype=torch.float32, device=dev)
    big[1:] = torch.from_numpy(pts).to(dev)
    return big[1:]


def proj_inputs(torch, np, dev, scenes, n, h, w, seed, unaligned=False):
    """K1's synthetic inputs on the card: n points spread over KITTI's
    field of view, KITTI's calibration, a random (h, w) label image."""
    rng = np.random.default_rng(seed)
    tr, p = scenes.make_calibration(scenes.SceneConfig(img_h=h, img_w=w))
    pts = np.concatenate([rng.uniform(-5, 70, (n, 1)),
                          rng.uniform(-25, 25, (n, 1)),
                          rng.uniform(-2, 2, (n, 1))], 1).astype(np.float32)
    lab = rng.integers(0, 13, (h, w)).astype(np.int32)
    return (on_card(torch, dev, pts, unaligned),
            *(torch.from_numpy(a).to(dev) for a in (tr, p, lab)))


def proj_shape(pts, lab, visible, what: str = "") -> str:
    n, (h, w) = pts.shape[0], lab.shape
    n_vis = int(visible.sum())
    base = f", base +{pts.data_ptr() % 16} B" if pts.data_ptr() % 16 else ""
    return (f"N={n} image={h}x{w}{what}{base}, {n_vis} visible "
            f"({n_vis / max(n, 1):.4f})")


def check_point_proj(torch, pp_ops, pp_ref, pts, tr, p, lab):
    """K1's full instance vs its plain version, every output bit for bit;
    returns the record. ``lab`` gives the image's shape (the labels are
    the other instance's)."""
    h, w = lab.shape
    got = pp_ops.point_proj(pts, tr, p, h, w)
    want = pp_ref.point_proj_ref(pts, tr, p, h, w)[:4]
    shape = proj_shape(pts, lab, want[2])
    for name, g, r in zip(("uv", "depth", "visible", "flat"), got, want):
        if not torch.equal(g, r):
            fail(f"point_proj {shape}: {name} differs from the plain version"
                 + (f" (max abs err {float((g - r).abs().max())})"
                    if g.dtype == torch.float32 else ""))
    n = pts.shape[0]
    # Bytes: xyz + calibration in, uv + depth + visible + flat out. Ops:
    # two 3x4 affine maps, the divide, bounds and index arithmetic (~60
    # f32 ops a point).
    rec = dict(shape=shape, exact=True, max_abs_err=0.0, tol="bit for bit",
               bytes=n * 12 + 96 + n * 17, ops=60 * n)
    return rec, (lambda: pp_ops.point_proj(pts, tr, p, h, w)), \
        (lambda: pp_ref.point_proj_ref(pts, tr, p, h, w))


def check_point_proj_labels(torch, pp_ops, pp_ref, pts, tr, p, lab,
                            what: str = ""):
    """K1's labels instance vs the plain version's labels, bit for bit;
    returns the record. Its bound counts what it moves: xyz and the
    calibration in, the visible points' gathers, the labels out."""
    h, w = lab.shape
    got = pp_ops.project_and_label(pts, tr, p, lab)
    want = pp_ref.point_proj_ref(pts, tr, p, h, w, lab)
    shape = proj_shape(pts, lab, want[2], what)
    if not torch.equal(got, want[4]):
        fail(f"point_proj_labels {shape}: labels differ from the plain "
             f"version")
    n, n_vis = pts.shape[0], int(want[2].sum())
    rec = dict(shape=shape, exact=True, max_abs_err=0.0, tol="bit for bit",
               bytes=n * 12 + 96 + n_vis * 4 + n * 4, ops=60 * n)
    return rec, (lambda: pp_ops.project_and_label(pts, tr, p, lab)), \
        (lambda: pp_ref.point_proj_ref(pts, tr, p, h, w, lab)[4])


def proj_fleet_inputs(torch, np, dev, scenes, s, n, h, w, seed):
    """K1's labels instance with a stream axis: S streams of ``proj_inputs``
    stacked, (S, N, 3) points and (S, H, W) images, one calibration."""
    ins = [proj_inputs(torch, np, dev, scenes, n, h, w, seed + i)
           for i in range(s)]
    return (torch.stack([x[0] for x in ins]), ins[0][1], ins[0][2],
            torch.stack([x[3] for x in ins]))


def check_labels_fleet(torch, pp_ops, pp_ref, pts, tr, p, lab,
                       what: str = ""):
    """The labels instance over a stream axis: bit for bit against the
    plain version and, stream by stream, against the 2-D kernel (those
    launches compare, they are no main path's)."""
    s_n, n = pts.shape[:2]
    h, w = lab.shape[1:]
    got = pp_ops.project_and_label(pts, tr, p, lab)
    want = pp_ref.point_proj_ref(pts, tr, p, h, w, lab)
    n_vis = int(want[2].sum())
    shape = (f"S={s_n} N={n} image={h}x{w}{what}, {n_vis} visible "
             f"({n_vis / max(s_n * n, 1):.4f})")
    if not torch.equal(got, want[4]):
        fail(f"point_proj_labels {shape}: labels differ from the plain "
             f"version")
    for i in range(s_n):
        if not torch.equal(got[i], pp_ops.project_and_label(pts[i], tr, p,
                                                            lab[i])):
            fail(f"point_proj_labels {shape}: stream {i} differs from the "
                 f"2-D kernel")
    rec = dict(shape=shape, exact=True, max_abs_err=0.0,
               tol="bit for bit, and the 2-D kernel stream by stream",
               bytes=s_n * n * 12 + 96 + n_vis * 4 + s_n * n * 4,
               ops=60 * s_n * n)
    return rec, (lambda: pp_ops.project_and_label(pts, tr, p, lab)), \
        (lambda: pp_ref.point_proj_ref(pts, tr, p, h, w, lab)[4])


def check_iou2d(torch, np, dev, iou_ops, iou_ref, n, m, seed, s=None):
    """K2 against its plain version, bit for bit; with ``s``, over a stream
    axis (S, N, 4) x (S, M, 4), also against the 2-D kernel stream by
    stream."""
    rng = np.random.default_rng(seed)
    lead = () if s is None else (s,)

    def boxes(cnt):
        xy = rng.uniform(0, 1242, (*lead, cnt, 2))
        wh = rng.uniform(1, 200, (*lead, cnt, 2))
        return torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                                .astype(np.float32)).to(dev)
    a, b = boxes(n), boxes(m)
    got, want = iou_ops.iou2d(a, b), iou_ref.iou2d_ref(a, b)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    shape = f"{n}x{m}" if s is None else f"S={s} {n}x{m}"
    if not torch.equal(got, want):
        fail(f"iou2d {shape}: not bit-equal to the plain version (off by "
             f"{err})")
    for i in range(s or 0):
        if not torch.equal(got[i], iou_ops.iou2d(a[i], b[i])):
            fail(f"iou2d {shape}: stream {i} differs from the 2-D kernel")
    k = s or 1
    rec = dict(shape=shape, exact=True, max_abs_err=err,
               tol="bit for bit" + ("" if s is None else
                                    ", and the 2-D kernel stream by stream"),
               bytes=k * ((n + m) * 16 + n * m * 4), ops=17 * k * n * m)
    return rec, (lambda: iou_ops.iou2d(a, b)), \
        (lambda: iou_ref.iou2d_ref(a, b))


def check_ransac(torch, np, dev, rs_ops, rs_ref, o, k, p, seed, dead=None):
    """Kernel vs plain version, counts exact; object ``dead`` (if given)
    has every point masked out."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.normal(0, 5, (o, p, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(o, p)) < 0.8)
    if dead is not None:
        valid[dead] = False
    nrm = rng.normal(size=(o, k, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = torch.from_numpy(nrm.astype(np.float32))
    off = torch.from_numpy(rng.normal(0, 3, (o, k)).astype(np.float32))
    args = [t.to(dev) for t in (pts, valid, nrm, off)]
    got = rs_ops.ransac_score(*args, 0.5)
    want = rs_ref.ransac_score_ref(*args, 0.5)
    if not torch.equal(got, want):
        fail(f"ransac_score (O,K,P)=({o},{k},{p}): counts differ")
    shape = f"O={o} K={k} P={p}" + (
        f", object {dead} all invalid" if dead is not None else "")
    rec = dict(shape=shape, exact=True, max_abs_err=0.0,
               bytes=o * p * 13 + o * k * 16 + o * k * 4, ops=8 * o * k * p)
    return rec, (lambda: rs_ops.ransac_score(*args, 0.5)), \
        (lambda: rs_ref.ransac_score_ref(*args, 0.5))


# The auction's phase-3 cases: persons a matrix (each side of one warp's 32,
# two warps' 64, the row instances' cap last) and auctions a launch; the
# plain version is timed too at n = 40 and 128, one auction.
AUCTION_NS = (1, 2, 12, 16, 24, 31, 32, 33, 40, 64, 128)
AUCTION_BATCHES = (1, 16, 64, 256)
AUCTION_PLAIN_TIMED = ((40, 1), (128, 1))
# The wide instance's seeded cases (n > 128). Their ties take more rounds a
# phase than the serving default of 4,000 from n = 512 (at n = 1024 one
# phase needs more), so both versions run them with this cap.
AUCTION_WIDE_NS = (129, 256, 512, 1024)
AUCTION_WIDE_BATCHES = (1, 16)
WIDE_MAX_ITER = 20000


def auction_benefits(np, n, batch, seed, zero_rows=False, equal_rows=False):
    """Seeded (batch, n, n) benefits on the association's 1e-3 grid, drawn
    from 20 levels so that many tie exactly; with ``zero_rows`` about a
    third of the rows and of the columns are 0 (the invalid pairs and the
    padding of a non-square association); with ``equal_rows`` every row is
    the first (all persons bid on one object each round)."""
    rng = np.random.default_rng(seed)
    b = (rng.integers(0, 20, (batch, n, n)) * np.float32(1e-3)) \
        .astype(np.float32)
    if zero_rows:
        b[:, rng.uniform(size=n) < 1 / 3, :] = 0.0
        b[:, :, rng.uniform(size=n) < 1 / 3] = 0.0
    if equal_rows:
        b[:] = b[:, :1]
    return b


def record_auctions(torch, au_ops, run):
    """The benefit matrices that ``run()`` hands the auction, in call
    order (copies on the card)."""
    real, seen = au_ops.auction, []

    def recording(benefit, *args, **kw):
        seen.append(benefit.clone())
        return real(benefit, *args, **kw)
    au_ops.auction = recording
    try:
        run()
    finally:
        au_ops.auction = real
    torch.cuda.synchronize()
    return seen


def optimum_cols(np, hungarian, b):
    """A maximum-benefit assignment of the square matrix ``b``:
    ``hungarian_numpy`` (pure Python, O(n^3)) up to 128 persons, SciPy's
    ``linear_sum_assignment`` above; at n = 129 both, their optima held
    equal."""
    n = b.shape[0]
    if n <= 128:
        return hungarian(-b)
    from scipy.optimize import linear_sum_assignment
    cols = linear_sum_assignment(-b)[1]
    if n == 129:
        ar = np.arange(n)
        h = hungarian(-b)
        if abs(b[ar, h].sum() - b[ar, cols].sum()) > 1e-9:
            fail(f"auction: hungarian_numpy's and SciPy's optima differ at "
                 f"n = {n}")
    return cols


def check_auction(torch, np, au_ops, au_ref, hungarian, benefit, what,
                  max_iter: int = 4000, skeleton: bool = True):
    """The auction kernel against its plain version on the card, bit for bit
    in person_to_obj, the prices and the rounds; the assignment a
    permutation whose total benefit is within n x eps_final (1e-4) of the
    optimum (``optimum_cols``) on the first matrices (up to 4; 1 at
    n > 40). ``max_iter``: rounds a phase, both versions."""
    lead, n = tuple(benefit.shape[:-2]), benefit.shape[-1]
    got = au_ops.auction(benefit, max_iter_per_phase=max_iter)
    want = au_ref.auction_ref(benefit, max_iter_per_phase=max_iter)
    shape = f"B={math.prod(lead)} n={n}{what}" + (
        f", {max_iter} rounds a phase" if max_iter != 4000 else "")
    for name, g, w in zip(("person_to_obj", "prices", "rounds"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(
                g.view(torch.int32) if g.dtype == torch.float32 else g,
                w.view(torch.int32) if w.dtype == torch.float32 else w):
            fail(f"auction {shape}: {name} differs from the plain version")
    b = benefit.reshape(-1, n, n).cpu().double().numpy()
    p2o = got[0].reshape(-1, n).cpu().numpy()
    ar = np.arange(n)
    worst = 0.0
    for i in range(len(b)):
        if sorted(p2o[i]) != list(ar):
            fail(f"auction {shape}: matrix {i} is not assigned a permutation")
        if i < (4 if n <= 40 else 1):
            opt = b[i][ar, optimum_cols(np, hungarian, b[i])].sum()
            gap = opt - b[i][ar, p2o[i]].sum()
            worst = max(worst, gap)
            if gap > n * 1e-4 + 1e-6:
                fail(f"auction {shape}: matrix {i}'s total benefit is "
                     f"{gap} under the optimum (limit n x 1e-4)")
    rounds = got[2].reshape(-1).cpu()
    rec = dict(shape=shape, exact=True, max_abs_err=0.0,
               tol="bit for bit (person_to_obj, prices, rounds); total "
                   "benefit within n x 1e-4 of the optimum",
               optimality_gap=worst, rounds_max=int(rounds.max()),
               rounds_sum=int(rounds.sum()),
               bytes=len(b) * (n * n * 4 + n * 12 + 4),
               ops=6 * n * n * int(rounds.sum()), plain_eager=True)
    # The probe of a round's synchronisation and end test alone (a tree
    # from before it, timed with this script, has none), for the one-warp
    # instance's rounds.
    probe = getattr(au_ops, "auction_skeleton", None)
    if skeleton and probe is not None:
        rec["skeleton"] = lambda: probe(got[2])
    return rec, (lambda: au_ops.auction(benefit,
                                        max_iter_per_phase=max_iter)), \
        (lambda: au_ref.auction_ref(benefit, max_iter_per_phase=max_iter))


def time_auction(torch, rec, kern, plain=None) -> None:
    """Device ms of an auction case that is not measured in full, its time
    a round (over its longest auction's rounds) and, given ``plain``, its
    plain version's ms (eagerly: it synchronises)."""
    est = eager_ms(kern, torch, runs=3, warmup=1)
    rec["kernel_ms"] = graph_ms(kern, torch,
                                reps=max(1, min(20, int(40 / est))),
                                replays=5)
    rec["us_per_round"] = rec["kernel_ms"] * 1e3 / rec["rounds_max"]
    rec["plain_ms"] = None if plain is None else eager_ms(
        plain, torch, runs=3, warmup=1)
    print(f"  device {rec['kernel_ms']:.5f} ms, {rec['us_per_round']:.4f} us"
          f" a round ({rec['rounds_max']} rounds)"
          + ("" if plain is None else f"; plain {rec['plain_ms']:.4f} ms"),
          flush=True)


def bf16_limit(torch, want):
    """Per-value tolerance of a bf16 attention output held against the f32
    result of the plain version on the same bf16 inputs: half a bf16 ulp of
    the value (the output's own rounding; bf16 keeps 8 significant bits)
    plus 2e-5 of it and 1e-6 for the f32 sums taken in another order. A
    kernel that loses one 512-position chunk of a 20k-position request, or
    one 64-key tile of a row, is off by some 1e-3 and fails."""
    _, e = torch.frexp(want)
    half_ulp = torch.where(want == 0, 0.0,
                           torch.ldexp(torch.ones_like(want), e - 9))
    return half_ulp + 2e-5 * want.abs() + 1e-6


# The tensor-core flash attention rounds p to bf16 (round to nearest, a
# relative error of at most 2^-8) before its P.V product, as every
# tensor-core flash attention does. Its check adds P_ROUNDING times the
# root-sum-square of those errors, sqrt(sum_j a_ij^2 v_jd^2) with
# a = p / l the softmax weights (``p_rounding_term``).
P_ROUNDING = 4 * 2.0 ** -8


def p_rounding_term(torch, q, k, v, causal: bool):
    """sqrt(sum_j a_ij^2 v_jd^2) in f32 for attention inputs q (B, H, SQ,
    hd), k/v (B, KV, SK, hd), a = the plain version's softmax weights with
    its masking; one head at a time, so a prefill-size call holds one
    (SQ, SK) score matrix."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, hd), dtype=torch.float32, device=q.device)
    live = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        live = live.tril()
    for head in range(h):
        kh = head // (h // kv)
        s = q[:, head].float() @ k[:, kh].float().transpose(-1, -2) \
            * hd ** -0.5
        s = torch.where(live, s, -1e30)
        p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        a = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        del s, p
        out[:, head] = torch.sqrt((a * a) @ v[:, kh].float().square())
    return out


def attention_close(torch, got, plain, f32_args, args, what: str,
                    p_rounding=None):
    """Hold an attention kernel's output against its plain version: in f32
    within 2e-5 (absolute and relative); in bf16 against the plain
    version's f32 result on the same inputs (``f32_args``), within
    ``bf16_limit``, plus ``P_ROUNDING * p_rounding`` where the kernel
    rounds p to bf16 (``p_rounding``: ``p_rounding_term`` of the inputs).
    Returns (max abs err, tolerance, exact, worst), where exact says the
    output equals the plain result rounded to its type and worst is the
    largest difference over its limit."""
    if got.dtype == torch.float32:
        want = plain(*args)
        diff = (got - want).abs()
        err = float(diff.max()) if got.numel() else 0.0
        worst = float((diff / (2e-5 + 2e-5 * want.abs())).max()) \
            if got.numel() else 0.0
        if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
            fail(f"{what}: off by {err}, {worst:.3g} times the tolerance "
                 f"(2e-5 abs + 2e-5 rel)")
        return err, f"2e-5 abs + 2e-5 rel (worst {worst:.3g} of it)", \
            bool(torch.equal(got, want)), worst
    want = plain(*f32_args)
    diff = (got.float() - want).abs()
    limit = bf16_limit(torch, want)
    tol = "half a bf16 ulp + 2e-5 rel + 1e-6"
    if p_rounding is not None:
        limit = limit + P_ROUNDING * p_rounding
        tol += " + 2^-6 sqrt(sum a^2 v^2) (p rounded to bf16)"
    worst = float((diff / limit).max()) if got.numel() else 0.0
    err = float(diff.max()) if got.numel() else 0.0
    if worst > 1:
        fail(f"{what}: off by {err}, {worst:.3g} times the tolerance "
             f"({tol})")
    return err, f"{tol} (worst {worst:.3g} of it)", \
        bool(torch.equal(got, want.to(got.dtype))), worst


def check_flash(torch, dev, fa_ops, fa_ref, b, h, kv, sq, sk, hd, dtype,
                causal, seed):
    """Kernel vs plain version on (B, S, heads, hd) activations passed as
    (B, heads, S, hd) views, as the model passes them. The wrapper's route
    (``fa_ops.route``) picks the kernel; the tensor-core route's check
    allows for its p rounded to bf16 (``attention_close``)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def act(heads, s):
        return torch.randn(b, s, heads, hd, generator=g, device=dev,
                           dtype=dtype).transpose(1, 2)
    q, k, v = act(h, sq), act(kv, sk), act(kv, sk)
    route = fa_ops.route(dtype, hd)
    counter = "tc_launches" if route == "tc" else "launches"
    before = getattr(fa_ops, counter)
    got = fa_ops.flash_attention(q, k, v, causal)
    if getattr(fa_ops, counter) != before + 1:
        fail(f"flash_attention: the {route} route's kernel did not launch")
    shape = f"({b},{h},{kv},{sq},{sk},{hd}) {str(dtype)[6:]} " + \
        ("causal" if causal else "full")
    p_rounding = p_rounding_term(torch, q, k, v, causal) \
        if route == "tc" else None
    err, tol, exact, worst = attention_close(
        torch, got, fa_ref.flash_attention_ref,
        (q.float(), k.float(), v.float(), causal), (q, k, v, causal),
        f"flash_attention ({route}) {shape}", p_rounding)
    del p_rounding
    # Live (query, key) pairs: query i sees keys [0, i] when causal.
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    elt = q.element_size()
    ops = 4 * hd * b * h * pairs
    # The bf16 route's products are single bf16 products; the 3xTF32
    # route's are three TF32 products each in f32 (Q.K^T one and P.V two
    # for bf16 inputs, which TF32 holds exactly).
    tf32_terms = 3 if dtype == torch.float32 else 1.5
    rec = dict(shape=shape, exact=exact, max_abs_err=err, tol=tol,
               worst=worst,
               bytes=(2 * b * h * sq * hd + 2 * b * kv * sk * hd) * elt,
               ops=ops if route == "tc" else tf32_terms * ops,
               peak=PEAK_BF16_PER_S if route == "tc" else PEAK_TF32_PER_S,
               f32_simt_ms=ops / PEAK_F32_PER_S * 1e3,
               library=lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=causal, enable_gqa=True))
    return rec, (lambda: fa_ops.flash_attention(q, k, v, causal)), \
        (lambda: fa_ref.flash_attention_ref(q, k, v, causal))


def check_decode(torch, dev, dec_ops, dec_ref, b, h, kv, s, hd, dtype,
                 pos, seed):
    """Kernel vs plain version on (B, S, KV, hd) caches passed as
    (B, KV, S, hd) views; ``pos`` is a list, or (lo, hi) for ragged
    positions drawn in [lo, hi)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, 1, h, hd, generator=g, device=dev, dtype=dtype)[:, 0]
    ck, cv = (torch.randn(b, s, kv, hd, generator=g, device=dev,
                          dtype=dtype).transpose(1, 2) for _ in range(2))
    if isinstance(pos, tuple):
        pos = torch.randint(*pos, (b,), generator=g, device=dev,
                            dtype=torch.int32)
    else:
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    got = dec_ops.decode_attention(q, ck, cv, pos)
    shape = (f"B={b} H={h} KV={kv} S={s} hd={hd} {str(dtype)[6:]} "
             f"pos {int(pos.min())}..{int(pos.max())}")
    err, tol, exact, worst = attention_close(
        torch, got, dec_ref.decode_attention_ref,
        (q.float(), ck.float(), cv.float(), pos), (q, ck, cv, pos),
        f"decode_attention {shape}")
    live = int(pos.clamp(max=s).sum())
    elt = q.element_size()
    mask = (torch.arange(s, device=dev)[None, :] < pos[:, None])[:, None,
                                                                  None]
    rec = dict(shape=shape, exact=exact, max_abs_err=err, tol=tol,
               worst=worst,
               bytes=(2 * b * h * hd + 2 * kv * hd * live) * elt + 4 * b,
               ops=4 * hd * (h // kv) * kv * live,
               peak=PEAK_BF16_PER_S if dtype == torch.bfloat16
               else PEAK_F32_PER_S,
               library=lambda: torch.nn.functional.scaled_dot_product_attention(
                   q[:, :, None], ck, cv, attn_mask=mask, enable_gqa=True))
    return rec, (lambda: dec_ops.decode_attention(q, ck, cv, pos)), \
        (lambda: dec_ref.decode_attention_ref(q, ck, cv, pos))


def kitti_frames(np, api, scenes, n: int, seed: int = 0):
    """``n`` kitti-urban frames at KITTI's point count (stream seed 0):
    (N, 4) points with an intensity column from a seeded generator, the
    ground-truth boxes and flags and the (H, W) int32 instance-id image, as
    numpy arrays; and the stream's calibration (Tr, P)."""
    scn = api.scenario("kitti-urban", seed=0, **KITTI)
    rng = np.random.default_rng(seed)
    stream = scenes.SceneStream(scn.scene, seed=0)
    out = []
    for fr in stream.frames(n):
        inten = rng.uniform(0, 1, (len(fr.points), 1))
        out.append((np.concatenate([fr.points, inten], 1).astype(np.float32),
                    fr.gt_boxes.astype(np.float32), fr.gt_valid,
                    fr.label_img.astype(np.int32)))
    return out, (stream.tr.astype(np.float32), stream.p.astype(np.float32))


def pillar_special_inputs(np, seed: int = 0):
    """K4's ``specials`` case as numpy arrays (feats (N, C) f32, ids (N,)
    i32, mask (N,) bool, G): +-0, +-inf, NaN of either sign, subnormals
    and the smallest normals sprinkled over normal values; pillars 0-7 hold
    only negative values, pillar 8 only -inf, pillar 9 only zeros and
    subnormals; pillar G-1 is occupied; kept points with ids at or past G
    are dropped. C = 32: the 16-byte path. ``tests/test_torch_pillar_
    scatter.py`` holds the plain version to JAX's on these inputs."""
    rng = np.random.default_rng(seed)
    n, c, g = 4096, 32, 256
    f = rng.normal(size=(n, c)).astype(np.float32)
    idx = rng.integers(10, g, n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.9
    tiny = np.finfo(np.float32).tiny
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40,
                         -1e-40, 1e-45, -1e-45, tiny, -tiny], np.float32)
    hit = rng.uniform(size=(n, c)) < 0.1
    f[hit] = rng.choice(specials, size=int(hit.sum()))
    idx[48:448] = rng.integers(0, 8, 400)          # all-negative pillars
    f[48:448] = -np.abs(f[48:448])
    idx[:16], valid[:16], f[:16] = 8, True, -np.inf
    idx[16:32], valid[16:32] = 9, True
    f[16:32] = rng.choice(specials[[0, 1, 6, 7, 8, 9]], size=(16, c))
    idx[32:40], valid[32:40] = g - 1, True
    idx[40:44], valid[40:44] = [g, g + 3, g + 100, 2 ** 31 - 1], True
    return f, idx, valid, g


def pillar_inputs(torch, np, dev, detector3d, kitti, kind: str, seed: int):
    """K4's inputs on the card: (feats, ids, mask, G, cotangent, label).
    ``kitti``: the real pillar ids of a kitti-urban frame under the default
    PillarConfig and ReLU'd PointNet features from seeded weights (ties at
    0, as on the detector's path); ``sorted``: the same points sorted by
    pillar; ``dense``: N=4096 points in 256 pillars, C=64; ``invalid``:
    every point masked out; ``ties``: ReLU'd features rounded to 0.1, so
    most channels hold several equal maxima; ``specials``:
    ``pillar_special_inputs``; ``one-pillar``: every kept point in one
    pillar (the most contention, the most combining); ``rows-c7``: rows of
    7 channels; ``rows-c40``: rows of 40 channels (the backward's second
    mask word partial); ``unaligned``: rows at a base 4 bytes past a
    16-byte boundary."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind in ("kitti", "sorted"):
        cfg = detector3d.PillarConfig()
        pts = torch.from_numpy(kitti[0][0]).to(dev)
        f9, idx, valid = detector3d.pillarize(
            cfg, pts, torch.ones(len(pts), dtype=torch.bool, device=dev))
        w = torch.randn((9, cfg.feat_dim), generator=g, device=dev) / 3
        feats = torch.relu(f9 @ w).contiguous()
        n_pillars = cfg.grid_h * cfg.grid_w
        if kind == "sorted":
            order = torch.sort(idx, stable=True).indices
            feats, idx, valid = feats[order], idx[order], valid[order]
    elif kind == "specials":
        feats, idx, valid, n_pillars = (
            torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
            for a in pillar_special_inputs(np, seed))
    else:
        n, c, n_pillars = {"dense": (4096, 64, 256),
                           "invalid": (4096, 32, 1024),
                           "ties": (8192, 32, 512),
                           "one-pillar": (8192, 32, 1024),
                           "rows-c7": (4096, 7, 512),
                           "rows-c40": (4096, 40, 512),
                           "unaligned": (4096, 32, 512)}[kind]
        if kind == "unaligned":
            feats = torch.randn((n * c + 1,), generator=g,
                                device=dev)[1:].view(n, c)
        else:
            feats = torch.randn((n, c), generator=g, device=dev)
        if kind == "ties":
            feats = torch.round(torch.relu(feats) * 10) / 10
        idx = torch.randint(0, n_pillars, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        if kind == "one-pillar":
            idx.fill_(n_pillars // 3)
        valid = torch.rand((n,), generator=g, device=dev) < (
            0.0 if kind == "invalid" else 0.9)
    ct = torch.randn((n_pillars, feats.shape[1]), generator=g, device=dev)
    return feats, idx, valid, n_pillars, ct, kind


# Points a warp of K4's forward takes at a time (kBatch in
# src/repro_torch/csrc/pillar_scatter.cu).
K4_BATCH = 8


def combining(torch, idx, kept) -> str:
    """What the forward's combining can save on these ids, counted on the
    host: the share of adjacent kept points in the same pillar, and the
    row atomics the kernel sends (one for each run of consecutive kept
    points in one pillar, within a warp's batch of K4_BATCH points)
    against one a kept point."""
    ids = torch.where(kept, idx, -1).cpu()
    kid = ids[ids >= 0]
    adjacent = float((kid[1:] == kid[:-1]).float().mean()) \
        if len(kid) > 1 else 0.0
    batch = torch.cat([ids, ids.new_full(((-len(ids)) % K4_BATCH,), -1)])
    batch = batch.view(-1, K4_BATCH)
    head = batch >= 0
    head[:, 1:] &= batch[:, 1:] != batch[:, :-1]
    sends = int(head.sum())
    return (f"{adjacent:.4f} of adjacent kept points share a pillar; "
            f"{sends} row atomics for {len(kid)} kept points "
            f"({sends / max(len(kid), 1):.4f})")


def check_pillar_scatter(torch, ps_ops, ps_ref, inputs, backward: bool):
    """K4's forward (equal to its plain version value for value) or its
    backward (bit for bit) on the card. The library yardstick is PyTorch's
    ``scatter_reduce(..., "amax")`` (dropped points sent to a spare row)
    and, for the backward, autograd's gradient of it, timed eagerly."""
    f, idx, valid, n_pillars, ct, kind = inputs
    n, c = f.shape
    kept = valid & (idx >= 0) & (idx < n_pillars)
    n_kept = int(kept.sum())
    per_pillar = torch.bincount(idx[kept].long(), minlength=n_pillars)
    occupied = int((per_pillar > 0).sum())
    shape = (f"N={n} C={c} G={n_pillars} ({kind}, {n_kept} kept in "
             f"{occupied} pillars, at most {int(per_pillar.max())} a "
             f"pillar; {combining(torch, idx, kept)})")
    out = ps_ops.pillar_scatter(f, idx, valid, n_pillars)
    want = ps_ref.pillar_scatter_ref(f, idx, valid, n_pillars)
    if not torch.equal(out, want):
        fail(f"pillar_scatter {shape}: differs from the plain version")
    lib_idx = torch.where(kept, idx, n_pillars).long()[:, None].expand(n, c)
    spare = torch.full((n_pillars + 1, c), -torch.inf, device=f.device)
    if not backward:
        # Bytes: the kept points' features, every id and mask in, the grid
        # out (a dropped point's row is never read). Operations: one max a
        # kept value.
        rec = dict(shape=shape, exact=True, max_abs_err=0.0,
                   tol="equal by value",
                   bytes=n_kept * c * 4 + n * 5 + n_pillars * c * 4,
                   ops=n_kept * c,
                   library=lambda: spare.scatter_reduce(0, lib_idx, f,
                                                        "amax"))
        return rec, (lambda: ps_ops.pillar_scatter(f, idx, valid,
                                                   n_pillars)), \
            (lambda: ps_ref.pillar_scatter_ref(f, idx, valid, n_pillars))
    safe = torch.where(kept, idx, 0).long()
    ties = int((kept[:, None] & (f == want[safe])).sum())
    shape += f"; {ties} tied values ({ties / max(n * c, 1):.4f} of the grad)"
    got = ps_ops.pillar_scatter_bwd(f, idx, valid, out, ct)
    ref = ps_ref.pillar_scatter_bwd_ref(f, idx, valid, want, ct)
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        err = float((got - ref).abs().max())
        fail(f"pillar_scatter_bwd {shape}: not bit-equal to the plain "
             f"version (max abs err {err})")
    fx = f.detach().clone().requires_grad_()
    lib_out = spare.scatter_reduce(0, lib_idx, fx, "amax")
    lib_ct = torch.cat([ct, ct.new_zeros((1, c))])
    # Bytes: the kept points' features, every id and mask, the occupied
    # pillars' rows of the grid and its cotangent in, the whole gradient
    # out. Operations: a compare, a count, a multiply a value.
    rec = dict(shape=shape, exact=True, max_abs_err=0.0, tol="bit for bit",
               bytes=(n * c * 4 + n_kept * c * 4 + n * 5
                      + 2 * occupied * c * 4),
               ops=3 * n_kept * c, library_eager=True,
               library=lambda: torch.autograd.grad(lib_out, fx, lib_ct,
                                                   retain_graph=True))
    return rec, (lambda: ps_ops.pillar_scatter_bwd(f, idx, valid, out, ct)), \
        (lambda: ps_ref.pillar_scatter_bwd_ref(f, idx, valid, want, ct))


def measure(torch, rec, kern, plain) -> None:
    """Time a kernel at the serving shape: device ms from CUDA-graph replays
    (as many calls a graph as fit ~100 ms, at most 50), eager ms per call;
    its plain version as a graph of 50 calls too, or, where the record
    carries a library yardstick (the attention kernels, whose plain
    versions hold GBs of scores; K4, whose plain forward masks with a host
    sync), eagerly over a few calls; the library call from graph replays,
    or eagerly where the record says so (an autograd backward). The
    kernels (and memsets) that the kernel's and the library's calls
    launch, with device time a call, come from a profile."""
    def reps(fn):
        est = eager_ms(fn, torch, runs=3, warmup=1)
        return est, max(1, min(50, int(100 / max(est, 1e-3))))
    est, n = reps(kern)
    rec["kernel_ms"] = graph_ms(kern, torch, reps=n)
    if "rounds_max" in rec:
        rec["us_per_round"] = rec["kernel_ms"] * 1e3 / rec["rounds_max"]
    if "skeleton" in rec:
        rec["skeleton_ms"] = graph_ms(rec.pop("skeleton"), torch, reps=n)
    rec["kernel_eager_ms"] = eager_ms(
        kern, torch, runs=max(5, min(100, int(1000 / max(est, 1e-2)))))
    rec["kernels"] = device_kernels(torch, kern)
    library = rec.pop("library", None)
    if rec.pop("plain_eager", False):
        # The plain version synchronises with the host (the auction's end
        # check), which a graph cannot hold: timed eagerly.
        rec["plain_ms"] = rec["plain_eager_ms"] = eager_ms(
            plain, torch, runs=3, warmup=1)
        return
    if library is None:
        rec["plain_ms"] = graph_ms(plain, torch)
        rec["plain_eager_ms"] = eager_ms(plain, torch)
        return
    rec["plain_ms"] = rec["plain_eager_ms"] = eager_ms(plain, torch, runs=3,
                                                       warmup=1)
    if rec.pop("library_eager", False):
        rec["library_ms"] = eager_ms(library, torch, runs=20, warmup=3)
    else:
        rec["library_ms"] = graph_ms(library, torch, reps=reps(library)[1])
    rec["library_kernels"] = device_kernels(torch, library, calls=3)


def lm_run(torch, lm, decode, cfg, p, tokens, dec_tokens, max_len, dev):
    """Prefill logits and the logits of one decode step per row of
    ``dec_tokens``, from empty caches of ``max_len`` positions."""
    logits = lm.forward(p, cfg, tokens.to(dev))
    state = decode.init_decode(cfg, tokens.shape[0], max_len, dev)
    steps = []
    for t in dec_tokens:
        lg, state = decode.decode_step(p, cfg, state, t.to(dev))
        steps.append(lg)
    return logits, torch.stack(steps)


def lm_compare(torch, got, want, tol: float, what: str) -> float:
    """Prefill and decode logits finite, of the expected shapes, and within
    ``tol`` (absolute and relative); returns the largest difference."""
    err = 0.0
    for name, g, w in zip(("prefill", "decode"), got, want):
        g, w = g.float().cpu(), w.float().cpu()
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"{what}: {name} logits {tuple(g.shape)} (want "
                 f"{tuple(w.shape)}) or not finite")
        err = max(err, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=tol, atol=tol):
            fail(f"{what}: {name} logits off by {err} (tolerance {tol})")
    return err


def check_lm(torch, np, dev, kernels, lm_configs, convert, lm, decode,
             params):
    """LM phases A (qwen2.5-3B SMOKE in f32 with the JAX golden's weights,
    against its logits) and B (full width with 2 layers in f32, the card
    against the CPU). Both are the f32 serving path: their attention goes
    to the 3xTF32 flash route and to decode attention, one launch a layer a
    prefill or step; returns those launch counts, checked."""
    f32 = torch.float32
    kernels.reset_launch_counts()
    # -- 8. LM A: qwen2.5-3B SMOKE on the card vs the JAX golden -------------
    cfg = dataclasses.replace(lm_configs.get_smoke(LM_ARCH), dtype=f32)
    smoke_layers = cfg.n_layers
    with np.load(LM_GOLDEN) as f:
        gold = {k: f[k] for k in f.files}
    tree = params.from_leaves((tuple(k.split("/")[1:]), v)
                              for k, v in gold.items()
                              if k.startswith("params/"))
    logits, steps = lm_run(torch, lm, decode, cfg,
                           convert.params_from_jax(tree, cfg, dev),
                           torch.from_numpy(gold["tokens"]),
                           torch.from_numpy(gold["decode_tokens"]), 32, dev)
    err = lm_compare(torch, (logits, steps),
                     (torch.from_numpy(gold["logits"]),
                      torch.from_numpy(gold["decode_logits"])), 1e-5,
                     f"{cfg.name} on the card vs {LM_GOLDEN.name}")
    print(f"LM A: {cfg.name} f32 prefill + 4 decode steps on the card match "
          f"{LM_GOLDEN.name} (max abs err {err:.3g}, tolerance 1e-5)",
          flush=True)

    # -- 9. LM B: full width, 2 layers, f32: the card vs the CPU ------------
    cfg = dataclasses.replace(lm_configs.get(LM_ARCH), n_layers=LM_B_LAYERS,
                              dtype=f32)
    p_card = params.init_params(lm.model_defs(cfg),
                                torch.Generator(device=dev).manual_seed(1),
                                dev)
    # The JAX package's fanin init takes fan_in = shape[-2] of the 3-d
    # attention weights (the head count, or hd for wo): at full width the
    # attention scores then have a std of ~360 and the softmax is nearly
    # one-hot, so a 1-ulp change of the weights moves the logits by ~1e-2
    # and no two summation orders agree to 1e-4. Rescaled to fan_in =
    # d_model (and H*hd for wo) the scores have a std of ~1 and a 1-ulp
    # change moves the logits by ~1e-5.
    attn = p_card["blocks"]["attn"]
    for name in ("wq", "wk", "wv"):
        attn[name].mul_((attn[name].shape[-2] / cfg.d_model) ** 0.5)
    attn["wo"].mul_((attn["wo"].shape[-2] / cfg.d_head_total) ** 0.5)
    p_cpu = params.tree_map(lambda t: t.cpu(), p_card)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (LM_B_BATCH, LM_B_S), generator=gen,
                           dtype=torch.int32)
    dec_tokens = torch.randint(0, cfg.vocab, (4, LM_B_BATCH), generator=gen,
                               dtype=torch.int32)
    t0 = time.perf_counter()
    card = lm_run(torch, lm, decode, cfg, p_card, tokens, dec_tokens, 512,
                  dev)
    cpu = lm_run(torch, lm, decode, cfg, p_cpu, tokens, dec_tokens, 512,
                 torch.device("cpu"))
    err = lm_compare(torch, card, cpu, 1e-4,
                     f"{cfg.name} x2 layers on the card vs the CPU")
    print(f"LM B: {cfg.name} at full width ({LM_B_LAYERS} layers, f32) "
          f"B={LM_B_BATCH} S={LM_B_S} prefill "
          f"+ 4 decode steps: the card matches the CPU (max abs err "
          f"{err:.3g}, tolerance 1e-4; {time.perf_counter() - t0:.1f} s)",
          flush=True)
    launches = kernels.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attention=smoke_layers + LM_B_LAYERS,
                  decode_attention=4 * (smoke_layers + LM_B_LAYERS))
    if launches != expect:
        fail(f"LM A and B launch counts {launches} != {expect}")
    print(f"LM A and B: launches {launches}", flush=True)
    return {"flash_attention": launches["flash_attention"]}


def serve_lm(torch, dev, kernels, lm_configs, lm, decode, params):
    """LM phase C: qwen2.5-3B at full width in bf16 on the card. Returns
    the attention kernels' launch counts over the counted run (3 prefills
    and DECODE_STEPS greedy decode steps, after one warm-up of each)."""
    cfg = lm_configs.get(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(3)
    t0 = time.perf_counter()
    p32 = params.init_params(lm.model_defs(cfg), gen, dev)
    p = lm.cast_params(p32, cfg)      # matrices bf16 once; norms stay f32
    del p32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                           device=dev, dtype=torch.int32)
    state = decode.init_decode(cfg, DECODE_B, DECODE_MAX, dev)
    for cache in state.caches.values():
        cache.normal_(generator=gen)
    # Ragged positions; the top leaves room for every step of this phase
    # (warm-up, counted run, profile) to write a slot of its own.
    state = state._replace(cache_pos=torch.randint(
        DECODE_POS_LO, DECODE_MAX - DECODE_STEPS - 8, (DECODE_B,),
        generator=gen, device=dev, dtype=torch.int32))
    live = int(state.cache_pos.sum())
    step_tokens = torch.randint(0, cfg.vocab, (DECODE_B,), generator=gen,
                                device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    print(f"LM C: {cfg.name} ({cfg.n_layers} layers, bf16) weights and a "
          f"{DECODE_B}x{DECODE_MAX} KV cache on the card in "
          f"{time.perf_counter() - t0:.1f} s; cache positions "
          f"{int(state.cache_pos.min())}..{int(state.cache_pos.max())} "
          f"(mean {live / DECODE_B:.0f})", flush=True)

    def step():
        nonlocal state, step_tokens
        logits, state = decode.decode_step(p, cfg, state, step_tokens)
        step_tokens = logits.argmax(-1).to(torch.int32)
        return logits

    lm.forward(p, cfg, tokens)          # warm-ups, outside the counted run
    step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prefill_ms, step_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        logits = lm.forward(p, cfg, tokens)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(DECODE_STEPS):
        t0 = time.perf_counter()
        step_logits = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = kernels.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attention_tc=3 * cfg.n_layers,
                  decode_attention=DECODE_STEPS * cfg.n_layers)
    if launches != expect:
        fail(f"LM C launch counts {launches} != {expect}")
    for name, x, shape in (("prefill", logits,
                            (PREFILL_B, PREFILL_S, cfg.vocab)),
                           ("decode", step_logits, (DECODE_B, cfg.vocab))):
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            fail(f"LM C {name} logits {tuple(x.shape)} (want {shape}) or "
                 f"not finite")
    total_s = sum(step_ms) / 1e3
    print(f"LM C: prefill B={PREFILL_B} S={PREFILL_S}: median "
          f"{statistics.median(prefill_ms):.2f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in prefill_ms)}); decode "
          f"B={DECODE_B} max_len {DECODE_MAX}: median "
          f"{statistics.median(step_ms):.3f} ms/step (min {min(step_ms):.3f},"
          f" max {max(step_ms):.3f}), {DECODE_B * DECODE_STEPS / total_s:.1f} "
          f"tokens/s over {DECODE_STEPS} steps; launches {launches}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print(profile_window(torch, f"{cfg.name} decode B={DECODE_B}",
                         lambda: [step() for _ in range(4)], 4, "step"),
          flush=True)
    return {k: launches[k] for k in ("flash_attention_tc",
                                     "decode_attention")}


def checked(what: str, check, *args):
    """Run one of ``repro_torch.testing``'s checks; a difference fails."""
    try:
        return check(*args)
    except AssertionError as e:
        fail(f"{what}: {e}")


def check_detector_golden(testing):
    """Det A: the small PointPillars config on the card against
    ``tests/goldens/det3d_smoke.npz`` (written by the JAX package) by the
    check the CPU test runs (``repro_torch.testing.check_golden``):
    forward, loss, every gradient, detect and three AdamW steps, at the CPU
    parity tests' tolerances; an element whose gradient lay within the
    gradient tolerance of 0 at some step is held to AdamW's step bound, and
    such elements must stay under 1%."""
    res = checked("Det A", testing.check_golden, DET_GOLDEN, "cuda")
    cfg = res["cfg"]
    print(f"Det A: PointPillars {cfg.grid_h}x{cfg.grid_w} (feat "
          f"{cfg.feat_dim}, dims {cfg.backbone_dims}) on the card matches "
          f"{DET_GOLDEN.name}: forward, loss, {res['n_grads']} gradients, "
          f"detect ({res['n_kept']} kept) and {res['steps']} AdamW steps; "
          f"largest difference over each tensor's largest magnitude "
          + ", ".join(f"{k} {v:.3g}"
                                      for k, v in res["errs"].items())
          + f"; {res['loose']} of {res['total']} trained values at the step "
          f"bound (tolerance {testing.OUT_TOL} / {testing.GRAD_TOL})",
          flush=True)


def serve_detector(torch, dev, kernels, detector3d, params, optimizer,
                   testing, kitti):
    """Det B: the default PointPillars config at full width on the card,
    seeded random weights, kitti-urban frames at 122,880 points: detect
    over DET_FRAMES frames and DET_STEPS training steps (loss, backward,
    AdamW), K4's launch counts checked; a profile of 4 detect calls; then
    DET_CPU_FRAMES frames on the CPU against the card. Returns K4's launch
    counts over the counted run."""
    cfg = detector3d.PillarConfig()
    ocfg = optimizer.AdamWConfig()
    p0 = params.init_params(detector3d.detector_defs(cfg),
                            torch.Generator(device=dev).manual_seed(4), dev)
    frames = [(torch.from_numpy(pts).to(dev),
               torch.ones(len(pts), dtype=torch.bool, device=dev),
               torch.from_numpy(gtb).to(dev), torch.from_numpy(gtv).to(dev))
              for pts, gtb, gtv, _ in kitti]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def train_step(p, state, frame):
        loss, _, grads = testing.loss_grads(p, cfg, *frame)
        p, state, metrics = optimizer.update(ocfg, grads, state, p)
        return p, state, loss

    detector3d.detect(p0, cfg, *frames[0][:2])         # warm-ups
    train_step(p0, optimizer.init(p0), frames[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    det_ms = []
    for fr in frames:
        t0 = time.perf_counter()
        boxes, keep = detector3d.detect(p0, cfg, fr[0], fr[1])
        torch.cuda.synchronize()
        det_ms.append((time.perf_counter() - t0) * 1e3)
    p, state, step_ms, losses = p0, optimizer.init(p0), [], []
    for i in range(DET_STEPS):
        t0 = time.perf_counter()
        p, state, loss = train_step(p, state, frames[i % len(frames)])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = kernels.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update(pillar_scatter=DET_FRAMES + DET_STEPS,
                  pillar_scatter_bwd=DET_STEPS)
    if launches != expect:
        fail(f"Det B launch counts {launches} != {expect}")
    if tuple(boxes.shape) != (32, 7) or not bool(torch.isfinite(boxes).all()) \
            or not all(math.isfinite(x) for x in losses) or \
            not all(bool(torch.isfinite(t).all())
                    for _, t in params.leaves(p)):
        fail("Det B: detect boxes, losses or trained weights not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"Det B: PointPillars {cfg.grid_h}x{cfg.grid_w} at {cfg.pillar} m "
          f"(feat {cfg.feat_dim}, dims {cfg.backbone_dims}, "
          f"{params.param_count(detector3d.detector_defs(cfg))} parameters) "
          f"on kitti-urban x{DET_FRAMES} at {KITTI['n_points']} points: "
          f"detect median {statistics.median(det_ms):.3f} ms/frame (min "
          f"{min(det_ms):.3f}, max {max(det_ms):.3f}); {DET_STEPS} training "
          f"steps median {statistics.median(step_ms):.3f} ms/step (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}), losses "
          f"{losses[0]:.4g} -> {losses[-1]:.4g}; launches {launches}; peak "
          f"device memory {peak:.3f} GiB", flush=True)
    print(profile_window(
        torch, "detector3d detect",
        lambda: [detector3d.detect(p0, cfg, fr[0], fr[1])
                 for fr in frames[:4]], 4, "frame"), flush=True)

    # The same weights and frames on the CPU: outputs and every gradient
    # within the CPU parity tests' tolerances (float32 sums in another
    # order, as between the port and JAX); detect's kept flags equal.
    def close(got, want, tol, what):
        return checked(what, testing.close, got, want, tol, what)
    cpu = torch.device("cpu")
    p_cpu = params.tree_map(lambda t: t.to(cpu), p0)
    errs = {"forward": 0.0, "loss": 0.0, "grads": 0.0, "detect": 0.0}
    t0 = time.perf_counter()
    for i in range(DET_CPU_FRAMES):
        fr, fr_cpu = frames[i], [t.to(cpu) for t in frames[i]]
        for name, d, c in zip(("cls", "box"),
                              detector3d.forward(p0, cfg, fr[0], fr[1]),
                              detector3d.forward(p_cpu, cfg, *fr_cpu[:2])):
            errs["forward"] = max(errs["forward"], close(
                d, c, testing.OUT_TOL, f"Det B frame {i} {name}"))
        loss_d, _, grads_d = testing.loss_grads(p0, cfg, *fr)
        loss_c, _, grads_c = testing.loss_grads(p_cpu, cfg, *fr_cpu)
        errs["loss"] = max(errs["loss"], close(
            loss_d, loss_c, testing.OUT_TOL, f"Det B frame {i} loss"))
        gc = dict(params.leaves(grads_c))
        for path, g in params.leaves(grads_d):
            errs["grads"] = max(errs["grads"], close(
                g, gc[path], testing.GRAD_TOL,
                f"Det B frame {i} grad {'/'.join(path)}"))
        (bd, kd), (bc, kc) = (detector3d.detect(p0, cfg, fr[0], fr[1]),
                              detector3d.detect(p_cpu, cfg, *fr_cpu[:2]))
        if not torch.equal(kd.cpu(), kc):
            fail(f"Det B frame {i}: detect's kept flags differ from the CPU")
        errs["detect"] = max(errs["detect"], close(
            bd, bc, testing.OUT_TOL, f"Det B frame {i} detect boxes"))
    print(f"Det B: {DET_CPU_FRAMES} frames on the CPU "
          f"({time.perf_counter() - t0:.1f} s) match the card: largest "
          f"difference over each tensor's largest magnitude "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tolerance {testing.OUT_TOL} / {testing.GRAD_TOL})",
          flush=True)
    return {k: launches[k] for k in ("pillar_scatter", "pillar_scatter_bwd")}


def serve_fleet(torch, api, kernels, name: str, overrides, frames: int,
                cpu_frames: int, profile: bool):
    """One fleet run on the card through ``api.Session`` (the orchestrated
    ``FleetEngine``) after a warm-up, its launches checked per fleet frame
    (K1's labels instance 1, K2 2 (the anchor and the transform branch),
    K3 1, every other kernel 0), then held to the port's CPU run of the
    same preset (its first ``cpu_frames`` frames): kinds exact, floats
    within the golden tolerance. Returns the run's launch counts and
    numbers; prints wall ms per fleet frame and per stream-frame (median),
    the share of it spent copying the frame's inputs to the card, peak
    device memory and, with ``profile``, a torch.profiler window."""
    scn = api.scenario(name, **overrides)
    s_n = scn.n_streams
    # Warm-up (allocator, cuSOLVER) outside the timed run.
    api.Session(scn, torch_device="cuda").run(FLEET_WARMUP)
    session = api.Session(scn, torch_device="cuda")
    # The tapes (the streams' frames, rendered on the host) are set-up:
    # recorded before the timed run.
    t0 = time.perf_counter()
    session.engine._stacked(frames)
    record_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = session.run(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update(point_proj_labels=frames, iou2d=2 * frames,
                  ransac_score=frames, auction=2 * frames)
    if launches != expect:
        fail(f"fleet {name}: launch counts {launches} != {expect} "
             f"(1 labels, 2 iou2d, 1 ransac_score, 2 auction a fleet "
             f"frame)")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    eng = session.engine
    frame_ms = statistics.median(eng.frame_wall_s) * 1e3
    input_ms = statistics.median(eng.input_wall_s) * 1e3
    kinds = [k for s in range(s_n) for k in report.kinds(s)]
    counts = {k: kinds.count(k) for k in ("anchor", "test", "transform")}
    rows = csv_rows(report.to_csv())
    if not all(math.isfinite(float(r[k])) for r in rows for k in FLOAT_COLS):
        fail(f"fleet {name}: non-finite values in the card's report")
    print(f"fleet {name}: {s_n} streams x {frames} frames on the card in "
          f"{wall:.2f} s (tapes recorded beforehand in {record_s:.1f} s); "
          f"median wall {frame_ms:.2f} ms a fleet frame, "
          f"{frame_ms / s_n:.3f} ms a stream-frame, of which inputs to the "
          f"card {input_ms:.2f} ms a fleet frame; peak device memory "
          f"{peak_gib:.3f} GiB; kinds {counts}; launches {launches}; mean "
          f"F1 {report.mean_f1:.4f}", flush=True)
    line = None
    if profile:
        prof = api.Session(scn, torch_device="cuda")
        prof.engine._stacked(FLEET_PROFILE_FRAMES)
        line = profile_window(
            torch, f"fleet {name}", lambda: prof.run(FLEET_PROFILE_FRAMES),
            FLEET_PROFILE_FRAMES, "fleet frame")
        print(line, flush=True)
    t0 = time.perf_counter()
    cpu = api.Session(scn, torch_device="cpu").run(cpu_frames)
    compare_rows([r for r in rows if int(r["frame"]) < cpu_frames],
                 csv_rows(cpu.to_csv()), f"fleet {name} card vs CPU")
    print(f"fleet {name} x{cpu_frames} on the CPU: "
          f"{time.perf_counter() - t0:.2f} s; the card's first {cpu_frames} "
          f"frames of every stream match it", flush=True)
    return launches, dict(
        name=name, streams=s_n, frames=frames, cpu_frames=cpu_frames,
        wall_s=wall, frame_ms=frame_ms, stream_frame_ms=frame_ms / s_n,
        input_ms=input_ms, peak_gib=peak_gib, kinds=counts,
        profile=line)


# The kernels of one captured scan frame: K1's labels instance, K2 and the
# auction in each branch (anchor and transform), K3.
SCAN_FRAME_LAUNCHES = dict(point_proj_labels=1, iou2d=2, ransac_score=1,
                           auction=2)
# The kernels' names as the profiler shows them.
SCAN_KERNEL_NAMES = dict(point_proj_labels="point_proj_kernel",
                         iou2d="iou2d_kernel",
                         ransac_score="ransac_score_kernel",
                         auction="auction_kernel")
SCAN_GOLDEN = ROOT / "tests" / "goldens" / "fleet-256-congested-scan.csv"
SCAN_GOLDEN_FRAMES = 4


def replay_profile(torch, run, n: int):
    """A torch.profiler window over ``run()`` (``n`` fleet frames of graph
    replays): the device busy share, device ops a fleet frame, and the
    launches of each scan kernel by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    counts = {k: sum(e.count for e in dev if name in e.key)
              for k, name in SCAN_KERNEL_NAMES.items()}
    top = sorted(dev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:4]
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                busy_share=busy_us / wall_us if busy_us else None,
                device_ops_per_frame=sum(e.count for e in dev) / n,
                kernel_counts=counts,
                top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                     for e in top])


def serve_scan(torch, api, kernels, report_from_packed, name: str,
               overrides, frames: int, cpu_frames: int):
    """One fleet run in scan mode on the card through ``api.Session``
    (``run(scan=True)``: the tape copied to the card once, one frame of
    the body captured in a CUDA graph, replayed a frame under sync debug
    mode "error", one fetch) after a warm-up. Checks the captured frame's
    launches (SCAN_FRAME_LAUNCHES) and the counters (the warm-up's call of
    the body and the capture), replays of a second capture against the
    same body run eagerly on the card (bit for bit) and against the run's
    report, a profiled replay window (each kernel launched its captured
    count a frame), and the card's rows against the port's CPU scan of
    the same preset (its first ``cpu_frames`` frames): kinds exact, floats
    within the golden tolerance. Returns the counters and the numbers."""
    scn = api.scenario(name, **overrides)
    s_n = scn.n_streams
    api.Session(scn, torch_device="cuda").run(FLEET_WARMUP, scan=True)
    session = api.Session(scn, torch_device="cuda")
    eng = session.engine
    t0 = time.perf_counter()
    eng._stacked(frames)
    record_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = session.run(frames, scan=True)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    scan = eng._scan_fn()
    expect = dict.fromkeys(launches, 0)
    expect.update(SCAN_FRAME_LAUNCHES)
    if scan.captured_launches != expect:
        fail(f"scan {name}: captured launches {scan.captured_launches} != "
             f"{expect}")
    if launches != {k: 2 * v for k, v in expect.items()}:
        fail(f"scan {name}: counted launches {launches} != twice the "
             f"captured frame's (warm-up and capture)")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    timing = dict(eng.scan_timing)
    frame_ms = timing["replay_s"] / frames * 1e3

    stacked = eng._scan_inputs(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, eager = scan.run_eager(eng._init_state(), stacked, frames)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / frames * 1e3
    graph = scan.capture(eng._init_state(), stacked, frames)
    _, replayed = graph.replay(stacked)
    if not torch.equal(replayed, eager):
        fail(f"scan {name}: graph replays differ from the eager body on "
             f"the card")
    again = report_from_packed(replayed.cpu().numpy().transpose(1, 0, 2))
    for col in ("kind", "latency_s", "onboard_s", "f1", "precision",
                "recall"):
        if not (getattr(again, col) == getattr(report, col)).all():
            fail(f"scan {name}: a second capture's {col} differs from the "
                 f"run's")
    prof = replay_profile(torch, lambda: graph.replay(stacked), frames)
    want_counts = {k: v * frames for k, v in SCAN_FRAME_LAUNCHES.items()}
    if prof["busy_ms"] and prof["kernel_counts"] != want_counts:
        fail(f"scan {name}: profiled kernel launches "
             f"{prof['kernel_counts']} != {want_counts}")
    del graph, eager, replayed
    kinds = [k for s in range(s_n) for k in report.kinds(s)]
    counts = {k: kinds.count(k) for k in ("anchor", "test", "transform")}
    rows = csv_rows(report.to_csv())
    if not all(math.isfinite(float(r[k])) for r in rows for k in FLOAT_COLS):
        fail(f"scan {name}: non-finite values in the card's report")
    print(f"scan {name}: {s_n} streams x {frames} frames on the card in "
          f"{wall:.3f} s (tapes recorded beforehand in {record_s:.1f} s): "
          f"tape to the card {timing['tape_s'] * 1e3:.2f} ms, warm-up "
          f"{timing['warmup_s'] * 1e3:.1f} ms, capture "
          f"{timing['capture_s'] * 1e3:.1f} ms, replays and the fetch "
          f"{timing['replay_s'] * 1e3:.2f} ms: {frame_ms:.3f} ms a fleet "
          f"frame, {frame_ms / s_n:.4f} ms a stream-frame (the same body "
          f"eagerly on the card {eager_ms:.2f} ms a fleet frame); peak "
          f"device memory {peak_gib:.3f} GiB; kinds {counts}; captured "
          f"launches a frame {SCAN_FRAME_LAUNCHES}; replays equal the "
          f"eager body bit for bit; mean F1 {report.mean_f1:.4f}",
          flush=True)
    if prof["busy_ms"]:
        print(f"profile scan {name} x{frames} fleet frames of replays: wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f}"
              f" ms ({100 * prof['busy_share']:.1f}% of wall), "
              f"{prof['device_ops_per_frame']:.0f} device ops/fleet frame; "
              f"kernels {prof['kernel_counts']}; top: {prof['top']}",
              flush=True)
    else:
        print(f"profile scan {name}: no device time in the trace (not "
              f"measured)", flush=True)
    t0 = time.perf_counter()
    cpu = api.Session(scn, torch_device="cpu").run(cpu_frames, scan=True)
    compare_rows([r for r in rows if int(r["frame"]) < cpu_frames],
                 csv_rows(cpu.to_csv()), f"scan {name} card vs CPU")
    print(f"scan {name} x{cpu_frames} on the CPU: "
          f"{time.perf_counter() - t0:.2f} s; the card's first {cpu_frames} "
          f"frames of every stream match it", flush=True)
    return launches, dict(
        name=name, streams=s_n, frames=frames, cpu_frames=cpu_frames,
        wall_s=wall, frame_ms=frame_ms, stream_frame_ms=frame_ms / s_n,
        eager_body_frame_ms=eager_ms, tape_ms=timing["tape_s"] * 1e3,
        warmup_ms=timing["warmup_s"] * 1e3,
        capture_ms=timing["capture_s"] * 1e3, peak_gib=peak_gib,
        kinds=counts, captured_launches=SCAN_FRAME_LAUNCHES,
        replayed_launches={k: v * frames
                           for k, v in SCAN_FRAME_LAUNCHES.items()},
        profile=prof)


def scan_golden(torch, api):
    """``fleet-256-congested`` in scan mode on the card against
    ``tests/goldens/fleet-256-congested-scan.csv``: stream, frame, kind
    and device exact, the modelled latency_s and onboard_s at the golden
    tolerance; F1, precision and recall, which drift from today's JAX
    engine (ROADMAP R1), against the port's CPU scan instead."""
    scn = api.scenario("fleet-256-congested")
    card = csv_rows(api.Session(scn, torch_device="cuda").run(
        SCAN_GOLDEN_FRAMES, scan=True).to_csv())
    gold = csv_rows(SCAN_GOLDEN.read_text())
    if len(card) != len(gold):
        fail(f"scan golden: {len(card)} rows vs {len(gold)}")
    for g, w in zip(card, gold):
        bad = [k for k in ("stream", "frame", "kind", "device")
               if g[k] != w[k]]
        bad += [k for k in ("latency_s", "onboard_s")
                if abs(float(g[k]) - float(w[k]))
                > ATOL + RTOL * abs(float(w[k]))]
        if bad:
            fail(f"scan fleet-256-congested vs {SCAN_GOLDEN.name}: {bad} "
                 f"at stream {w['stream']} frame {w['frame']}")
    cpu = api.Session(scn, torch_device="cpu").run(SCAN_GOLDEN_FRAMES,
                                                   scan=True)
    compare_rows(card, csv_rows(cpu.to_csv()),
                 "scan fleet-256-congested card vs CPU")
    print(f"scan fleet-256-congested x{SCAN_GOLDEN_FRAMES} on the card: "
          f"stream, frame, kind, device, latency_s and onboard_s match "
          f"{SCAN_GOLDEN.name} ({len(gold)} rows); every column matches "
          f"the port's CPU scan", flush=True)


def serve_wide(torch, api, kernels):
    """kitti-urban at KITTI's size with max_obj = 80 (an association of
    n = 160 persons, the auction's wide instance) on the card after a
    warm-up, its launches checked as phase 4's (the wide instance once a
    frame, the row instances never), then held to its CPU run in this
    process. Returns the run's launch counts."""
    scn = api.scenario("kitti-urban", seed=0, max_obj=WIDE_MAX_OBJ, **KITTI)
    api.Session(scn, torch_device="cuda").run(2)
    session = api.Session(scn, torch_device="cuda")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = session.run(WIDE_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    kinds = report.kinds()
    n_transform = sum(k != "anchor" for k in kinds)
    expect = dict.fromkeys(launches, 0)
    expect.update(point_proj_labels=n_transform, iou2d=WIDE_FRAMES,
                  ransac_score=n_transform, auction_wide=WIDE_FRAMES)
    if launches != expect:
        fail(f"kitti-urban max_obj={WIDE_MAX_OBJ}: launch counts {launches} "
             f"!= {expect} implied by kinds {kinds}")
    walls = session.engine.frame_wall_s
    per_kind = {k: statistics.median(w for w, kk in zip(walls, kinds)
                                     if (kk == "anchor") == (k == "anchor"))
                * 1e3 for k in ("anchor", "transform")}
    rows = csv_rows(report.to_csv())
    if not all(math.isfinite(float(r[k])) for r in rows for k in FLOAT_COLS):
        fail(f"kitti-urban max_obj={WIDE_MAX_OBJ}: non-finite values")
    t1 = time.perf_counter()
    cpu = api.Session(scn, torch_device="cpu").run(WIDE_FRAMES)
    compare_rows(rows, csv_rows(cpu.to_csv()),
                 f"kitti-urban max_obj={WIDE_MAX_OBJ} card vs CPU")
    print(f"serve kitti-urban max_obj={WIDE_MAX_OBJ} (auctions of n = "
          f"{2 * WIDE_MAX_OBJ}) x{WIDE_FRAMES} on the card: {wall:.2f} s, "
          f"kinds {''.join(k[0] for k in kinds)}, launches {launches}, "
          f"median wall ms/frame: transform {per_kind['transform']:.2f}, "
          f"anchor {per_kind['anchor']:.2f}; the CPU run "
          f"({time.perf_counter() - t1:.2f} s) matches it", flush=True)
    return launches


def count_syncs(torch, run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the number of synchronising CUDA calls it made."""
    import warnings
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)


def within_tol(g, w) -> bool:
    return abs(g - w) <= ATOL + RTOL * abs(w)


def compare_observed(got, want, what: str) -> None:
    """Audit rows (kind exact, floats at the golden tolerance) and the
    modelled trace lanes (streams, uplink, cloud GPUs: names and lanes
    exact, times in us and float args at the golden tolerance, 1e-5 s =
    10 us) of two observed runs."""
    g_rows, w_rows = got.obs.audit.rows, want.obs.audit.rows
    if len(g_rows) != len(w_rows) or not g_rows:
        fail(f"{what}: {len(g_rows)} audit rows vs {len(w_rows)}")
    for g, w in zip(g_rows, w_rows):
        bad = [k for k in ("stream", "frame", "policy", "device", "kind",
                           "frames_since_anchor") if g[k] != w[k]]
        bad += [k for k in ("err_ewma", "bw_mbps", "edge_cost_s",
                            "offload_cost_s") if not within_tol(g[k], w[k])]
        if bad:
            fail(f"{what}: audit row differs in {bad}: {g} vs {w}")

    def events(rep):
        return [e for e in rep.to_trace()["traceEvents"]
                if e["ph"] == "X" and e["pid"] in (1, 2, 3)]
    g_ev, w_ev = events(got), events(want)
    if len(g_ev) != len(w_ev):
        fail(f"{what}: {len(g_ev)} modelled trace events vs {len(w_ev)}")
    for g, w in zip(g_ev, w_ev):
        args_ok = g.get("args", {}).keys() == w.get("args", {}).keys() and \
            all(g["args"][k] == v if isinstance(v, str) else
                within_tol(g["args"][k], v) for k, v in w.get("args", {}).items())
        if (g["name"], g["pid"], g["tid"]) != (w["name"], w["pid"], w["tid"])\
                or abs(g["ts"] - w["ts"]) > ATOL * 1e6 + RTOL * abs(w["ts"])\
                or abs(g["dur"] - w["dur"]) > ATOL * 1e6 + RTOL * abs(
                    w["dur"]) or not args_ok:
            fail(f"{what}: trace event differs: {g} vs {w}")


def span_ms(rep, name: str, frames=None):
    """Median ms of an observed run's host span ``name`` (over ``frames``
    when given)."""
    d = [r["dur"] for r in rep.obs.measured if r["name"] == name
         and (frames is None or r.get("frame") in frames)]
    return statistics.median(d) * 1e3 if d else None


def serve_observed(torch, api, kernels):
    """The observability hooks on the card. kitti-urban at KITTI's size
    (``OBS_FRAMES`` after phase 4's warm-up) unobserved, with metrics and
    the trace, and with every switch on, twice each in the order ABC CBA,
    each run counting its synchronising CUDA calls: the observed reports
    equal the unobserved one bit for bit, metrics and the trace add no
    synchronisation (fatal), the all-on run's audit rows and modelled
    trace lanes equal its CPU run's; prints the host spans' medians (the
    transform step's enqueue, the stats fetch) beside the frame's wall ms,
    each over both runs of its kind. Then
    fleet-16-congested orchestrated with every switch on (bit for bit
    with its unobserved run) and in scan mode with metrics and the trace
    (the first run's ``fleet/scan_dispatch`` marked compiled: the graph
    capture), and scan mode's refusal of the audit. Returns the launch
    counts of the first metrics-and-trace run."""
    from repro_torch import obs as obs_lib
    scn = api.scenario("kitti-urban", seed=0, **KITTI)

    def cfg(audit):
        return api.ObsConfig(metrics=True, trace=True, audit=audit,
                             registry=obs_lib.MetricsRegistry())

    def run(obs):
        s = api.Session(scn, torch_device="cuda", obs=obs)
        return s.run(OBS_FRAMES), s.engine

    # None: unobserved; False: metrics and the trace; True: every switch.
    runs, syncs, launches = {}, {}, None
    for audit in (None, False, True, True, False, None):
        if audit is False and launches is None:
            kernels.reset_launch_counts()
        out, n_sync = count_syncs(torch, lambda: run(
            None if audit is None else cfg(audit)))
        if audit is False and launches is None:
            launches = kernels.launch_counts()
        runs.setdefault(audit, []).append(out)
        syncs.setdefault(audit, []).append(n_sync)
    off_syncs, mt_syncs, full_syncs = (syncs[k] for k in (None, False, True))
    if not min(off_syncs):
        fail("observability: no synchronising call counted in the "
             "unobserved run, so the count cannot see one")
    if max(mt_syncs) > min(off_syncs):
        fail(f"observability: metrics and the trace made {mt_syncs} "
             f"synchronising calls, the unobserved runs {off_syncs}")
    off, mt, full = (runs[k][0][0] for k in (None, False, True))
    kinds = off.kinds()
    n_transform = sum(k != "anchor" for k in kinds)
    expect = dict.fromkeys(launches, 0)
    expect.update(point_proj_labels=n_transform, iou2d=OBS_FRAMES,
                  ransac_score=n_transform, auction=OBS_FRAMES)
    if launches != expect:
        fail(f"observability: launch counts {launches} != {expect}")
    for key, what in ((None, "no switch"), (False, "metrics and trace"),
                      (True, "every switch")):
        if any(r.to_csv() != off.to_csv() for r, _ in runs[key]):
            fail(f"observability: a run with {what} on differs from the "
                 f"first unobserved run")
    cpu = api.Session(scn, torch_device="cpu", obs=cfg(True)).run(OBS_FRAMES)
    compare_observed(full, cpu, "observed kitti-urban card vs CPU")
    if not full.to_prometheus() or not full.to_audit():
        fail("observability: empty exposition or audit")
    tf = {t for t, k in enumerate(kinds) if k != "anchor"}

    def wall_ms(key):
        return statistics.median(eng.frame_wall_s[t] for _, eng in runs[key]
                                 for t in tf) * 1e3

    def spans_ms(name, frames=None):
        return statistics.median(
            r["dur"] for rep, _ in runs[False] for r in rep.obs.measured
            if r["name"] == name
            and (frames is None or r["frame"] in frames)) * 1e3
    split = dict(
        frame_ms=wall_ms(False), unobserved_frame_ms=wall_ms(None),
        all_on_frame_ms=wall_ms(True),
        transform_step_ms=spans_ms("moby/transform_step", tf),
        frame_stats_fetch_ms=spans_ms("moby/frame_stats_fetch", tf),
        anchor_step_ms=spans_ms("moby/anchor_step"),
        syncs=dict(unobserved=off_syncs, metrics_trace=mt_syncs,
                   all_on=full_syncs))
    print(f"observed kitti-urban x{OBS_FRAMES} on the card, twice each "
          f"(transform frames, medians): wall {split['frame_ms']:.2f} ms a frame with "
          f"metrics and the trace (unobserved {split['unobserved_frame_ms']:.2f}"
          f", every switch {split['all_on_frame_ms']:.2f}); host spans: "
          f"moby/transform_step (enqueue) {split['transform_step_ms']:.3f} "
          f"ms, moby/frame_stats_fetch (the wait on the card) "
          f"{split['frame_stats_fetch_ms']:.3f} ms, the rest of the frame "
          f"{split['frame_ms'] - split['transform_step_ms'] - split['frame_stats_fetch_ms']:.3f}"
          f" ms; synchronising calls: unobserved {off_syncs}, metrics and "
          f"trace {mt_syncs}, every switch {full_syncs}; reports equal the "
          f"unobserved run's bit for bit; audit rows and modelled trace "
          f"lanes match the CPU run", flush=True)

    fleet = api.scenario("fleet-16-congested")
    f_off = api.Session(fleet, torch_device="cuda").run(OBS_FLEET_FRAMES)
    f_on = api.Session(fleet, torch_device="cuda",
                       obs=cfg(True)).run(OBS_FLEET_FRAMES)
    if f_on.to_csv() != f_off.to_csv():
        fail("observability: the observed fleet differs from the unobserved")
    if len(f_on.obs.audit) != fleet.n_streams * OBS_FLEET_FRAMES or \
            not f_on.obs.gpu_busy or not f_on.obs.uplink_spans:
        fail("observability: the fleet's audit, cloud or uplink records "
             "are missing")
    scan_session = api.Session(fleet, torch_device="cuda", obs=cfg(False))
    s_on = scan_session.run(OBS_FLEET_FRAMES, scan=True)
    first = s_on.obs.measured[0]
    if first["name"] != "fleet/scan_dispatch" or not first.get("compiled"):
        fail(f"observability: scan mode's first span {first} is not a "
             f"compiled fleet/scan_dispatch")
    try:
        api.Session(fleet, torch_device="cuda",
                    obs=api.ObsConfig(audit=True)).run(2, scan=True)
    except ValueError as e:
        if "scan" not in str(e):
            raise
    else:
        fail("observability: scan mode took the audit")
    split.update(
        fleet_dispatch_ms=span_ms(f_on, "fleet/dispatch"),
        fleet_fetch_ms=span_ms(f_on, "fleet/fetch"),
        scan_dispatch_ms=first["dur"] * 1e3,
        scan_fetch_ms=span_ms(s_on, "fleet/scan_fetch"))
    print(f"observed fleet-16-congested x{OBS_FLEET_FRAMES} on the card: "
          f"orchestrated, every switch on, equals the unobserved run "
          f"({len(f_on.obs.audit)} audit rows, {len(f_on.obs.gpu_busy)} "
          f"cloud batches): fleet/dispatch {split['fleet_dispatch_ms']:.3f} "
          f"ms, fleet/fetch {split['fleet_fetch_ms']:.3f} ms (medians); "
          f"scan mode: fleet/scan_dispatch {split['scan_dispatch_ms']:.2f} ms"
          f" (compiled: the capture), fleet/scan_fetch "
          f"{split['scan_fetch_ms']:.3f} ms; scan mode refuses the audit",
          flush=True)
    print(json.dumps({"observability": split}), flush=True)
    return launches


def csv_rows(text: str):
    return list(csv.DictReader(io.StringIO(text)))


def compare_rows(got, want, what: str) -> None:
    """Kinds exact, floats within the golden tolerance; the first diverging
    frame is reported."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} rows vs {len(want)}")
    for g, w in zip(got, want):
        bad = [k for k in ("stream", "frame", "kind") if g[k] != w[k]]
        bad += [k for k in FLOAT_COLS if abs(float(g[k]) - float(w[k]))
                > ATOL + RTOL * abs(float(w[k]))]
        if bad:
            fail(f"{what}: first divergence at frame {g['frame']} in "
                 f"{bad}: got {dict(g)} want {dict(w)}")


PILLAR_CASES = ("kitti", "dense", "invalid", "ties", "specials", "one-pillar",
                "sorted", "rows-c7", "rows-c40", "unaligned")


def report_timing(name: str, r) -> None:
    """Turn a measured record's bytes and operations into its bound, and
    print its times and the kernels its calls launched."""
    n_bytes = r.pop("bytes")
    r["bound_ms"], r["bound_by"] = bound(n_bytes, r.pop("ops"),
                                         r.pop("peak", PEAK_F32_PER_S))
    lib_ms = r.get("library_ms")
    print(f"kernel {name} [{r['shape']}]: device {r['kernel_ms']:.5f} ms"
          f" (plain {r['plain_ms']:.4f} ms, library "
          f"{'-' if lib_ms is None else f'{lib_ms:.5f}'} ms), eager call "
          f"{r['kernel_eager_ms']:.4f} ms (plain {r['plain_eager_ms']:.4f}"
          f" ms), bound {r['bound_ms']:.6f} ms ({r['bound_by']}; "
          f"{n_bytes / 1e6:.2f} MB)"
          + (f", f32 SIMT bound {r['f32_simt_ms']:.5f} ms"
             if "f32_simt_ms" in r else "")
          + (f", rounds {r['rounds_sum']} (the longest auction "
             f"{r['rounds_max']}, {r['us_per_round']:.4f} us a round)"
             if "rounds_sum" in r else "")
          + (f", skeleton {r['skeleton_ms']:.5f} ms (the rounds' warp "
             f"synchronisation and end test alone)"
             if "skeleton_ms" in r else ""), flush=True)
    print("  " + kernels_line(f"{name} kernel", r["kernels"]), flush=True)
    if "library_kernels" in r:
        print("  " + kernels_line(f"{name} library",
                                  r["library_kernels"][:4]), flush=True)


def timing(r) -> dict:
    """The measured numbers of a record, as the JSON line gives them."""
    lib = r.get("library_kernels")
    return {"shape": r["shape"], "max_abs_err": r["max_abs_err"],
            "exact": r["exact"], "worst_over_tol": r.get("worst"),
            "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "eager_ms": r["kernel_eager_ms"],
            "plain_eager_ms": r["plain_eager_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "f32_simt_bound_ms": r.get(
                "f32_simt_ms"), "library_ms": r.get("library_ms"),
            "library_kernel": lib[0][0] if lib else None,
            "passes": [[k, ms] for k, ms, _ in r["kernels"]],
            **{k: r[k] for k in ("rounds_max", "rounds_sum",
                                 "optimality_gap", "us_per_round",
                                 "skeleton_ms", "cases") if k in r}}


def kernel_entry(name: str, r, launches) -> dict:
    source, replaces = KERNELS[name]
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, **timing(r)}
    for key in ("kitti", "f32_prefill", "sorted", "fleet_kitti", "fleet_16",
                "fleet_64"):
        if key in r:
            entry[key] = timing(r[key])
    return entry


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(SRC))
    only = set()
    if sys.argv[1:2] == ["--kernels"] and len(sys.argv) == 3:
        only = set(sys.argv[2].split(","))
    elif sys.argv[1:]:
        fail(f"usage: {Path(__file__).name} [--kernels NAME[,NAME...]]")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    card = nvidia_smi()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    from repro_torch import api, kernels
    from repro_torch.data import scenes
    from repro_torch import configs as lm_configs, convert
    from repro_torch.kernels import _build
    from repro_torch.core import association
    from repro_torch.kernels.auction import ops as au_ops, ref as au_ref
    from repro_torch.kernels.decode_attention import ops as dec_ops, \
        ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops, \
        ref as fa_ref
    from repro_torch.kernels.iou2d import ops as iou_ops, ref as iou_ref
    from repro_torch.kernels.pillar_scatter import ops as ps_ops, \
        ref as ps_ref
    from repro_torch.kernels.point_proj import ops as pp_ops, ref as pp_ref
    from repro_torch.kernels.ransac_score import ops as rs_ops, ref as rs_ref
    from repro_torch.models import decode, detector3d, lm, params
    from repro_torch import testing
    from repro_torch.train import optimizer
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           or m == "repro" for m in sys.modules):
        fail("the port pulled in jax or the JAX package")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(ROOT)}", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line or \
                "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. kernels vs plain versions on the card --------------------------
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32

    def flash(*shape):
        return lambda s: check_flash(torch, dev, fa_ops, fa_ref, *shape, s)

    def dec(*shape):
        return lambda s: check_decode(torch, dev, dec_ops, dec_ref, *shape, s)

    t0 = time.perf_counter()
    kitti, kitti_calib = kitti_frames(np, api, scenes,
                                      1 if only else DET_FRAMES)
    print(f"kitti-urban: {len(kitti)} frames of {KITTI['n_points']} points "
          f"rendered in {time.perf_counter() - t0:.1f} s", flush=True)

    def k4(kind, backward):
        return lambda s: check_pillar_scatter(
            torch, ps_ops, ps_ref,
            pillar_inputs(torch, np, dev, detector3d, kitti, kind, s),
            backward)

    def k1(check, *shape, unaligned=False):
        return lambda s: check(torch, pp_ops, pp_ref, *proj_inputs(
            torch, np, dev, scenes, *shape, s, unaligned))

    def k1_fleet(*shape, what=""):
        return lambda s: check_labels_fleet(
            torch, pp_ops, pp_ref,
            *proj_fleet_inputs(torch, np, dev, scenes, *shape, s), what)

    def k2(n, m, streams=None):
        return lambda s: check_iou2d(torch, np, dev, iou_ops, iou_ref, n, m,
                                     s, streams)

    def k3(o, k, p, dead=None):
        return lambda s: check_ransac(torch, np, dev, rs_ops, rs_ref, o, k,
                                      p, s, dead)

    def auction_synthetic(n, batch, seed, zero_rows=False, equal_rows=False,
                          what="", max_iter=4000):
        def case(_):
            rec, kern, plain = check_auction(
                torch, np, au_ops, au_ref, association.hungarian_numpy,
                torch.from_numpy(auction_benefits(
                    np, n, batch, seed, zero_rows, equal_rows)).to(dev),
                what, max_iter=max_iter, skeleton=n <= 128)
            rec["time_plain"] = (n, batch) in AUCTION_PLAIN_TIMED and \
                not (zero_rows or equal_rows)
            return rec, kern, plain
        return case

    real_auctions = {}

    def auction_real(key):
        """The benefits of a kitti-urban transform frame (frame 2 of a run
        on the card; ``kitti_wide``: with max_obj = 80, n = 160) or of the
        full-width fleet's transform branch (frame 1), recorded from the
        serving path."""
        def case(_):
            if key not in real_auctions:
                name, overrides, frames = {
                    "kitti": ("kitti-urban", KITTI, 3),
                    "kitti_wide": ("kitti-urban",
                                   dict(KITTI, max_obj=WIDE_MAX_OBJ), 3),
                    "fleet": (FLEETS[2][0], FLEETS[2][1], 2)}[key]
                scn = api.scenario(name, seed=0, **overrides)
                real_auctions[key] = record_auctions(
                    torch, au_ops, lambda: api.Session(
                        scn, torch_device="cuda").run(frames))[-1]
            b = real_auctions[key]
            label = {"kitti": "kitti-urban frame 2",
                     "kitti_wide": f"kitti-urban max_obj={WIDE_MAX_OBJ} "
                                   f"frame 2",
                     "fleet": "full-width fleet frame 1, transform "
                              "branch"}[key]
            return check_auction(torch, np, au_ops, au_ref,
                                 association.hungarian_numpy, b,
                                 f" ({label})", skeleton=key != "kitti_wide")
        return case

    def k1_kitti(_):
        """Frame 0 of kitti-urban: its own points, instance-id image and
        calibration, the data of the serving path's launches."""
        pts, _, _, lab = kitti[0]
        return check_point_proj_labels(
            torch, pp_ops, pp_ref,
            on_card(torch, dev, np.ascontiguousarray(pts[:, :3]), False),
            *(torch.from_numpy(a).to(dev) for a in (*kitti_calib, lab)),
            " (kitti-urban frame 0)")
    checks = {
        # The serving shape, a million points (N % 4 = 3), an unaligned
        # base, a small image with N % 4 = 1.
        "point_proj": [
            k1(check_point_proj, 122880, 375, 1242),
            k1(check_point_proj, 1000003, 375, 1242),
            k1(check_point_proj, 5001, 375, 1242, unaligned=True),
            k1(check_point_proj, 77, 48, 160)],
        # The labels instance: the serving shape, kitti-urban frame 0 (also
        # timed), an unaligned base, N = 77; then with a stream axis: the
        # three fleets' shapes (all timed: the full-width fleet, 16 streams
        # at KITTI's size; fleet-16-congested; fleet-64-mixed, S = 64), S =
        # 1 and a ragged S = 3 (N % 128 != 0).
        "point_proj_labels": [
            k1(check_point_proj_labels, 122880, 375, 1242),
            k1_kitti,
            k1(check_point_proj_labels, 5001, 375, 1242, unaligned=True),
            k1(check_point_proj_labels, 77, 48, 160),
            k1_fleet(16, 122880, 375, 1242, what=" (full-width fleet)"),
            k1_fleet(16, 2048, 64, 208, what=" (fleet-16-congested)"),
            k1_fleet(64, 512, 32, 104, what=" (fleet-64-mixed)"),
            k1_fleet(1, 5001, 375, 1242),
            k1_fleet(3, 4099, 48, 160)],
        # The serving shape, a multi-CTA grid, one output, and the two
        # sides of the one-CTA limit (1024 outputs); then with a stream
        # axis: the three fleets' shapes (timed), S = 1, a ragged S = 3
        # across the one-CTA limit, S = 64 with multi-CTA matrices.
        "iou2d": [k2(24, 12), k2(130, 250), k2(1, 1), k2(32, 32),
                  k2(33, 33), k2(24, 12, 16), k2(16, 8, 16), k2(12, 6, 64),
                  k2(24, 12, 1), k2(33, 33, 3), k2(130, 250, 64)],
        # The serving shape and others; then the fleets' S x O objects
        # (timed): 16 x 12, 16 x 8 and 64 x 6.
        "ransac_score": [k3(12, 30, 256), k3(20, 30, 256), k3(3, 7, 1000),
                         k3(1, 1, 1), k3(5, 33, 33, dead=2), k3(2, 5, 4000),
                         k3(192, 30, 256), k3(128, 30, 256),
                         k3(384, 30, 256)],
        # The 3xTF32 route (f32; bf16 at hd 16, 32, 64): LM B's prefill
        # shape first (full width in f32), LM C's prefill shape in f32 (also
        # timed), then GQA, ragged MQA, keys longer than queries, the SMOKE
        # configs' head dim, bf16 at hd 64.
        "flash_attention": [
            flash(LM_B_BATCH, 16, 2, LM_B_S, LM_B_S, 128, f32, True),
            flash(PREFILL_B, 16, 2, PREFILL_S, PREFILL_S, 128, f32, True),
            flash(2, 8, 2, 512, 512, 128, f32, True),
            flash(1, 4, 1, 300, 300, 64, f32, True),
            flash(2, 2, 2, 128, 640, 64, f32, False),
            flash(2, 4, 2, 16, 16, 16, f32, True),
            flash(2, 8, 2, 512, 512, 64, bf16, True)],
        # The tensor-core route (bf16 at hd 128): the prefill shape of LM
        # phase C first, then a ragged causal tile, keys longer than
        # queries, GQA.
        "flash_attention_tc": [
            flash(PREFILL_B, 16, 2, PREFILL_S, PREFILL_S, 128, bf16, True),
            flash(1, 4, 1, 300, 300, 128, bf16, True),
            flash(2, 2, 2, 128, 640, 128, bf16, False),
            flash(2, 8, 2, 512, 512, 128, bf16, True)],
        # The decode shape of LM phase C first (ragged positions), then
        # f32 GQA, MQA with positions 1 and S, SMOKE's head dim with an
        # empty request, and bf16 at hd 16 (2-byte rows of V a lane).
        "decode_attention": [
            dec(DECODE_B, 16, 2, DECODE_MAX, 128, bf16,
                (DECODE_POS_LO, DECODE_MAX)),
            dec(4, 8, 2, 1024, 128, f32, (1, 1025)),
            dec(2, 8, 1, 700, 64, f32, [1, 700]),
            dec(2, 4, 2, 32, 16, f32, [0, 17]),
            dec(2, 4, 2, 100, 16, bf16, [0, 97])],
        # Det B's shape first (the real pillar ids of a kitti-urban frame),
        # then dense collisions, every point masked out, planted ties,
        # special values, one pillar, sorted points, 7- and 40-channel
        # rows, an unaligned base.
        "pillar_scatter": [k4(kind, False) for kind in PILLAR_CASES],
        "pillar_scatter_bwd": [k4(kind, True) for kind in PILLAR_CASES],
        # A kitti-urban transform frame's benefits (the serving shape) and
        # the full-width fleet's (both measured in full), then seeded tied
        # benefits at every n and batch, zero rows and columns, every row
        # equal, all zeros (each timed too).
        "auction": [auction_real("kitti"), auction_real("fleet")]
        + [auction_synthetic(n, batch, 100 * n + batch)
           for n in AUCTION_NS for batch in AUCTION_BATCHES]
        + [auction_synthetic(24, 16, 1, zero_rows=True, what=" zero rows"),
           auction_synthetic(40, 64, 2, zero_rows=True, what=" zero rows")]
        + [auction_synthetic(n, batch, 3 * n, equal_rows=True,
                             what=" all tied")
           for n, batch in ((24, 16), (33, 4), (40, 16), (128, 1))]
        + [lambda _: check_auction(torch, np, au_ops, au_ref,
                                   association.hungarian_numpy,
                                   torch.zeros((1, 24, 24), device=dev),
                                   " all zeros")],
        # The wide instance (n > 128): the benefits of a kitti-urban
        # transform frame at max_obj = 80 (n = 160, measured in full), then
        # seeded tied benefits at n = 129 to 1024, one auction and 16, zero
        # rows and columns, every row equal (each timed too).
        "auction_wide": [auction_real("kitti_wide")]
        + [auction_synthetic(n, batch, 100 * n + batch,
                             max_iter=WIDE_MAX_ITER)
           for n in AUCTION_WIDE_NS for batch in AUCTION_WIDE_BATCHES]
        + [auction_synthetic(256, 1, 5, zero_rows=True, what=" zero rows",
                             max_iter=WIDE_MAX_ITER),
           auction_synthetic(256, 1, 6, equal_rows=True, what=" all tied",
                             max_iter=WIDE_MAX_ITER)],
    }
    # Besides each kernel's first case (the serving path's shape), these
    # are timed too: (kernel, case) -> key of its record.
    also_timed = {("point_proj_labels", 1): "kitti",
                  ("point_proj_labels", 4): "fleet_kitti",
                  ("point_proj_labels", 5): "fleet_16",
                  ("point_proj_labels", 6): "fleet_64",
                  ("iou2d", 5): "fleet_kitti", ("iou2d", 6): "fleet_16",
                  ("iou2d", 7): "fleet_64",
                  ("ransac_score", 6): "fleet_kitti",
                  ("ransac_score", 7): "fleet_16",
                  ("ransac_score", 8): "fleet_64",
                  ("flash_attention", 1): "f32_prefill",
                  ("auction", 1): "fleet_kitti",
                  ("pillar_scatter", PILLAR_CASES.index("sorted")): "sorted"}
    # The launch floor: a one-element zero_() timed as the kernels are.
    floor_t = torch.zeros(1, device=dev)
    launch_floor = graph_ms(floor_t.zero_, torch)
    print(f"launch floor: {launch_floor:.5f} ms a call (a one-element "
          f"zero_(), CUDA-graph replays as for the kernels)", flush=True)
    records = {}
    for name, cases in checks.items():
        if only and name not in only:
            continue
        for i, case in enumerate(cases):
            rec, kern, plain = case(i)
            time_plain = rec.pop("time_plain", False)
            torch.cuda.synchronize()
            print(f"kernel {name} [{rec['shape']}]: matches the plain version"
                  f" (max abs err {rec['max_abs_err']}"
                  + (f", tolerance {rec['tol']}" if "tol" in rec else "")
                  + ")", flush=True)
            if i == 0 or (name, i) in also_timed:
                measure(torch, rec, kern, plain)
                report_timing(name, rec)
                if i == 0:
                    records[name] = rec
                else:
                    records[name][also_timed[name, i]] = rec
            elif name in ("auction", "auction_wide"):
                time_auction(torch, rec, kern, plain if time_plain else None)
                records[name].setdefault("cases", []).append(
                    [rec["shape"], rec["kernel_ms"], rec["us_per_round"],
                     rec["rounds_max"], rec["plain_ms"]])
            del rec, kern, plain
            torch.cuda.empty_cache()
    if only:
        print(json.dumps({"kernels": [kernel_entry(name, records[name], None)
                                      for name in records]}))
        return
    main_launches = {}

    # -- 4. KITTI-size serving on the card ---------------------------------
    scn = api.scenario("kitti-urban", seed=0, **KITTI)
    # Warm-up (CUDA context, cuSOLVER, allocator) outside the timed run.
    api.Session(scn, torch_device="cuda").run(2)
    session = api.Session(scn, torch_device="cuda")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = session.run(KITTI_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    kinds = report.kinds()
    n_transform = sum(k != "anchor" for k in kinds)
    # The serving path launches K1's labels instance, never the full one.
    expect = dict.fromkeys(launches, 0)
    expect.update(point_proj_labels=n_transform, iou2d=KITTI_FRAMES,
                  ransac_score=n_transform, auction=KITTI_FRAMES)
    if launches != expect:
        fail(f"launch counts {launches} != {expect} implied by kinds {kinds}")
    main_launches.update((k, launches[k]) for k in MOBY_KERNELS)
    walls = session.engine.frame_wall_s
    per_kind = {k: statistics.median(w for w, kk in zip(walls, kinds)
                                     if (kk == "anchor") == (k == "anchor"))
                * 1e3 for k in ("anchor", "transform")}
    print(f"serve kitti-urban x{KITTI_FRAMES} on the card: {wall:.2f} s, "
          f"kinds {''.join(k[0] for k in kinds)}, launches {launches}, "
          f"median wall ms/frame: transform {per_kind['transform']:.2f}, "
          f"anchor {per_kind['anchor']:.2f}, mean F1 {report.mean_f1:.4f}",
          flush=True)
    print(profile_window(
        torch, scn.name,
        lambda: api.Session(scn, torch_device="cuda").run(4), 4, "frame"),
        flush=True)
    gpu_rows = csv_rows(report.to_csv())
    if not all(math.isfinite(float(r[k])) for r in gpu_rows
               for k in FLOAT_COLS):
        fail("non-finite values in the card's report")

    # -- 5. the same run on the CPU -----------------------------------------
    t0 = time.perf_counter()
    cpu_report = api.Session(scn, torch_device="cpu").run(KITTI_FRAMES)
    compare_rows(gpu_rows, csv_rows(cpu_report.to_csv()),
                 "kitti-urban card vs CPU")
    print(f"serve kitti-urban x{KITTI_FRAMES} on the CPU: "
          f"{time.perf_counter() - t0:.2f} s; the card's report matches it",
          flush=True)
    by_path = {k: {"kitti-urban": main_launches[k]} for k in MOBY_KERNELS}

    # -- 5b. past 128 persons: kitti-urban with max_obj = 80 -----------------
    launches = serve_wide(torch, api, kernels)
    for k in by_path:
        by_path[k][f"kitti-urban max_obj={WIDE_MAX_OBJ}"] = launches[k]
        main_launches[k] += launches[k]

    # -- 5c. observability on the card ----------------------------------------
    launches = serve_observed(torch, api, kernels)
    for k in by_path:
        by_path[k]["kitti-urban observed"] = launches[k]
        main_launches[k] += launches[k]
    torch.cuda.empty_cache()

    # -- 6. the fleet, orchestrated mode ------------------------------------
    fleets = []
    for name, overrides, frames, cpu_frames, key in FLEETS:
        launches, run = serve_fleet(torch, api, kernels, name, overrides,
                                    frames, cpu_frames,
                                    profile=key == "fleet_kitti")
        path = f"{key} ({name})"
        for k in by_path:
            by_path[k][path] = launches[k]
            main_launches[k] += launches[k]
        fleets.append(run)
        torch.cuda.empty_cache()
    print(json.dumps({"fleets": fleets}), flush=True)

    # -- 6b. the fleet, scan mode: one CUDA graph of the frame, replayed --
    from repro_torch.fleet.engine import report_from_packed
    scans = []
    for name, overrides, frames, cpu_frames, key in FLEETS:
        launches, run = serve_scan(torch, api, kernels, report_from_packed,
                                   name, overrides, frames, cpu_frames)
        path = f"scan {key} ({name})"
        for k in by_path:
            by_path[k][path] = launches[k]
            main_launches[k] += launches[k]
        scans.append(run)
        torch.cuda.empty_cache()
    scan_golden(torch, api)
    print(json.dumps({"scans": scans}), flush=True)

    # -- 7. smoke on the card vs the JAX reference's golden -----------------
    smoke = api.Session(api.scenario("smoke", seed=0),
                        torch_device="cuda").run(16)
    compare_rows(csv_rows(smoke.to_csv()), csv_rows(GOLDEN.read_text()),
                 "smoke on the card vs tests/goldens/smoke.csv")
    print("smoke x16 on the card matches tests/goldens/smoke.csv", flush=True)

    # -- 8-9. LM A and B: the card against JAX's golden and the CPU ------
    main_launches.update(check_lm(torch, np, dev, kernels, lm_configs,
                                  convert, lm, decode, params))
    torch.cuda.empty_cache()

    # -- 10. LM C: serving qwen2.5-3B at full width on the card -------------
    main_launches.update(serve_lm(torch, dev, kernels, lm_configs, lm, decode,
                                  params))

    # -- 11-12. Det A and B: the PointPillars detector ----------------------
    torch.cuda.empty_cache()
    check_detector_golden(testing)
    main_launches.update(serve_detector(torch, dev, kernels, detector3d,
                                        params, optimizer, testing, kitti))

    # -- 13. result lines -----------------------------------------------------
    entries = [kernel_entry(name, records[name], main_launches[name])
               for name in KERNELS]
    for e in entries:
        if e["name"] in by_path:
            e["launches_by_path"] = by_path[e["name"]]
    print(json.dumps({"kernels": entries}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
