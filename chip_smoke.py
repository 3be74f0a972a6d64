#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) serves
Moby on an NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (the kernels build from ``src/repro_torch/csrc``
on first use) and ``nvidia-smi``; imports nothing of JAX or of the JAX
package ``repro``. It exits non-zero, before printing any result, when torch
sees no card or the port's sources are not beside the script. Phases, each
fatal on failure:

1. the card's name and power limit, torch and CUDA versions;
2. the kernel build (``nvcc`` for ``sm_90a``), timed;
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (and a few others), then timed with CUDA events
   after a warm-up: device time per call from replays of a CUDA graph of 50
   calls (median of 20), and the eager per-call time (median of 100);
4. the serving path at KITTI's own size (``kitti-urban`` at 122,880 points
   and a 375x1242 image, 24 frames) on the card, with every kernel's launch
   count checked against the run's frame kinds, after a 2-frame warm-up;
   then a torch.profiler window over 4 frames (device busy share, device
   ops per frame, the ops with the most device time);
5. the same run on the CPU in this process: frame kinds equal, floats within
   the golden tolerance;
6. the ``smoke`` preset on the card against ``tests/goldens/smoke.csv``;
7. one ``{"kernels": [...]}`` JSON line, the card line again, and last the
   ``{"ok": true, "device": ...}`` line.
"""
from __future__ import annotations

import csv
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

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth and
# the float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# The golden CSV tolerance (tests/test_goldens.py).
RTOL, ATOL = 1e-4, 1e-5
FLOAT_COLS = ("latency_s", "onboard_s", "f1", "precision", "recall")

KITTI = dict(n_points=122880, img_h=375, img_w=1242)
KITTI_FRAMES = 24

KERNELS = {
    "point_proj": ("src/repro_torch/csrc/point_proj.cu",
                   "src/repro/kernels/point_proj/point_proj.py:43"),
    "iou2d": ("src/repro_torch/csrc/iou2d.cu",
              "src/repro/kernels/iou2d/iou2d.py:36"),
    "ransac_score": ("src/repro_torch/csrc/ransac_score.cu",
                     "src/repro/kernels/ransac_score/ransac_score.py:34"),
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


def profile_frames(torch, api, scn, n_frames: int) -> str:
    """A torch.profiler window over the first frames of a fresh session:
    device busy share of the window, CUDA launches per frame, and the ops
    with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    session = api.Session(scn, torch_device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.run(n_frames)
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
    return (f"profile {scn.name} x{n_frames} frames: wall "
            f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
            f"({100 * busy_us / wall_us:.1f}% of wall), "
            f"{launches / n_frames:.0f} device ops/frame; top device time: "
            f"{top}")


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_point_proj(torch, np, dev, scenes, pp_ops, pp_ref, n, h, w, seed):
    """Kernel vs plain version on KITTI calibration; returns the record."""
    rng = np.random.default_rng(seed)
    tr, p = scenes.make_calibration(scenes.SceneConfig(img_h=h, img_w=w))
    pts = np.concatenate([rng.uniform(-5, 70, (n, 1)),
                          rng.uniform(-25, 25, (n, 1)),
                          rng.uniform(-2, 2, (n, 1))], 1).astype(np.float32)
    lab = rng.integers(0, 13, (h, w)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (pts, tr, p)]
    lab_t = torch.from_numpy(lab).to(dev)
    got = pp_ops.point_proj(*args, h, w, lab_t)
    want = pp_ref.point_proj_ref(*args, h, w, lab_t)
    names = ("uv", "depth", "visible", "flat", "labels")
    for name, g, r in zip(names, got, want):
        if name in ("visible", "flat", "labels") and not torch.equal(g, r):
            fail(f"point_proj N={n}: {name} differs from the plain version")
    err = max(float((g - r).abs().max()) for g, r in zip(got[:2], want[:2]))
    if not all(torch.allclose(g, r, rtol=1e-4, atol=1e-3)
               for g, r in zip(got[:2], want[:2])):
        fail(f"point_proj N={n}: uv/depth off by {err}")
    n_vis = int(got[2].sum())
    # Bytes: xyz + calibration in, the gathered labels of visible points,
    # uv + depth + visible + flat + labels out. Ops: two 3x4 affine maps,
    # the divide, bounds and index arithmetic (~60 f32 ops a point).
    rec = dict(shape=f"N={n} image={h}x{w}", exact=True, max_abs_err=err,
               bytes=n * 12 + 96 + n_vis * 4 + n * 21, ops=60 * n)
    return rec, (lambda: pp_ops.point_proj(*args, h, w, lab_t)), \
        (lambda: pp_ref.point_proj_ref(*args, h, w, lab_t))


def check_iou2d(torch, np, dev, iou_ops, iou_ref, n, m, seed):
    rng = np.random.default_rng(seed)

    def boxes(cnt):
        xy = rng.uniform(0, 1242, (cnt, 2))
        wh = rng.uniform(1, 200, (cnt, 2))
        return torch.from_numpy(np.concatenate([xy, xy + wh], 1)
                                .astype(np.float32)).to(dev)
    a, b = boxes(n), boxes(m)
    got, want = iou_ops.iou2d(a, b), iou_ref.iou2d_ref(a, b)
    err = float((got - want).abs().max()) if n * m else 0.0
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
        fail(f"iou2d {n}x{m}: off by {err}")
    rec = dict(shape=f"{n}x{m}", exact=bool(torch.equal(got, want)),
               max_abs_err=err, bytes=(n + m) * 16 + n * m * 4, ops=17 * n * m)
    return rec, (lambda: iou_ops.iou2d(a, b)), \
        (lambda: iou_ref.iou2d_ref(a, b))


def check_ransac(torch, np, dev, rs_ops, rs_ref, o, k, p, seed):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.normal(0, 5, (o, p, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(o, p)) < 0.8)
    nrm = rng.normal(size=(o, k, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = torch.from_numpy(nrm.astype(np.float32))
    off = torch.from_numpy(rng.normal(0, 3, (o, k)).astype(np.float32))
    args = [t.to(dev) for t in (pts, valid, nrm, off)]
    got = rs_ops.ransac_score(*args, 0.5)
    want = rs_ref.ransac_score_ref(*args, 0.5)
    if not torch.equal(got, want):
        fail(f"ransac_score (O,K,P)=({o},{k},{p}): counts differ")
    rec = dict(shape=f"O={o} K={k} P={p}", exact=True, max_abs_err=0.0,
               bytes=o * p * 13 + o * k * 16 + o * k * 4, ops=8 * o * k * p)
    return rec, (lambda: rs_ops.ransac_score(*args, 0.5)), \
        (lambda: rs_ref.ransac_score_ref(*args, 0.5))


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


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(SRC))
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
    from repro_torch.kernels import _build
    from repro_torch.kernels.iou2d import ops as iou_ops, ref as iou_ref
    from repro_torch.kernels.point_proj import ops as pp_ops, ref as pp_ref
    from repro_torch.kernels.ransac_score import ops as rs_ops, ref as rs_ref
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
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. kernels vs plain versions on the card --------------------------
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = {
        "point_proj": [
            lambda s: check_point_proj(torch, np, dev, scenes, pp_ops, pp_ref,
                                       122880, 375, 1242, s),
            lambda s: check_point_proj(torch, np, dev, scenes, pp_ops, pp_ref,
                                       1000003, 375, 1242, s),
            lambda s: check_point_proj(torch, np, dev, scenes, pp_ops, pp_ref,
                                       77, 48, 160, s)],
        "iou2d": [
            lambda s: check_iou2d(torch, np, dev, iou_ops, iou_ref, 24, 12, s),
            lambda s: check_iou2d(torch, np, dev, iou_ops, iou_ref, 130, 250,
                                  s),
            lambda s: check_iou2d(torch, np, dev, iou_ops, iou_ref, 1, 1, s)],
        "ransac_score": [
            lambda s: check_ransac(torch, np, dev, rs_ops, rs_ref, 12, 30, 256,
                                   s),
            lambda s: check_ransac(torch, np, dev, rs_ops, rs_ref, 20, 30, 256,
                                   s),
            lambda s: check_ransac(torch, np, dev, rs_ops, rs_ref, 3, 7, 1000,
                                   s)],
    }
    records = {}
    for name, cases in checks.items():
        for i, case in enumerate(cases):
            rec, kern, plain = case(i)
            torch.cuda.synchronize()
            if i == 0:   # the serving path's shape: measure it
                rec["kernel_ms"] = graph_ms(kern, torch)
                rec["plain_ms"] = graph_ms(plain, torch)
                rec["kernel_eager_ms"] = eager_ms(kern, torch)
                rec["plain_eager_ms"] = eager_ms(plain, torch)
                records[name] = rec
            print(f"kernel {name} [{rec['shape']}]: matches the plain version"
                  f" (max abs err {rec['max_abs_err']})", flush=True)
        r = records[name]
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("ops"))
        print(f"kernel {name} [{r['shape']}]: device {r['kernel_ms']:.4f} ms"
              f" (plain {r['plain_ms']:.4f} ms), eager call "
              f"{r['kernel_eager_ms']:.4f} ms (plain {r['plain_eager_ms']:.4f}"
              f" ms), bound {r['bound_ms']:.6f} ms ({r['bound_by']})",
              flush=True)

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
    expect = {"point_proj": n_transform, "iou2d": KITTI_FRAMES,
              "ransac_score": n_transform}
    if launches != expect:
        fail(f"launch counts {launches} != {expect} implied by kinds {kinds}")
    walls = session.engine.frame_wall_s
    per_kind = {k: statistics.median(w for w, kk in zip(walls, kinds)
                                     if (kk == "anchor") == (k == "anchor"))
                * 1e3 for k in ("anchor", "transform")}
    print(f"serve kitti-urban x{KITTI_FRAMES} on the card: {wall:.2f} s, "
          f"kinds {''.join(k[0] for k in kinds)}, launches {launches}, "
          f"median wall ms/frame: transform {per_kind['transform']:.2f}, "
          f"anchor {per_kind['anchor']:.2f}, mean F1 {report.mean_f1:.4f}",
          flush=True)
    print(profile_frames(torch, api, scn, 4), flush=True)
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

    # -- 6. smoke on the card vs the JAX reference's golden -----------------
    smoke = api.Session(api.scenario("smoke", seed=0),
                        torch_device="cuda").run(16)
    compare_rows(csv_rows(smoke.to_csv()), csv_rows(GOLDEN.read_text()),
                 "smoke on the card vs tests/goldens/smoke.csv")
    print("smoke x16 on the card matches tests/goldens/smoke.csv", flush=True)

    # -- 7. result lines ------------------------------------------------------
    out = []
    for name, (source, replaces) in KERNELS.items():
        r = records[name]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": r["shape"],
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "exact": r["exact"], "ms": r["kernel_ms"],
            "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "eager_ms": r["kernel_eager_ms"],
            "plain_eager_ms": r["plain_eager_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": out}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
