#!/usr/bin/env python3
"""Where the auction's wide instance (``csrc/auction.cu``, n > 128) gains
over its first version, design step by design step, and how far its round
is from its synchronisation alone.

    python3 tools/auction_wide_probe.py [--parent REV|FILE.cu]
                                        [--variant FILE.cu ...]

Needs one CUDA card and ``nvcc``. ``--parent`` is the first version's
source: a file, or a git revision whose ``src/repro_torch/csrc/auction.cu``
``git show`` writes into ``build/auction_wide_probe/`` (default ``HEAD``;
on a copy without the repository's history, write the file beforehand).
It is called through its own interface (a (B, 3, n) workspace, no tier).

Builds into ``build/auction_wide_probe/`` (none of it is part of the port),
in parallel, the port's source with design steps undone by the text edits
in ``EDITS`` (the probe stops if one no longer applies), which splice in
``tools/auction_wide_steps.cuh`` where a build needs its code; a build
with step 1 (the resident rows) undone is called on the streamed tier:

* ``off``: steps 1-3 undone (the first version's round over n,
  ``dense_phase``, rebuilt on the port's warp merge, at the port's 32
  warps); ``s1`` .. ``s3``: each step alone; ``c2``: steps 1-2 (``s1`` is
  step 1 alone and cumulative); the port is steps 1-3;
* ``w4``, ``w8``, ``w16``: the port at 4, 8 and 16 warps a CTA (step 4:
  the port runs 32); ``f4``: the port with up to four bidders left to one
  warp (``few_bidder_rounds<4>``; the port leaves one);
* ``stamps`` (run once a case, not timed in turns): the port with thread
  0's cycles stamped by segment of the round;
* each ``--variant``: another version of the source, called as the port.

The latency build (``tools/auction_latency.cu``) times one warp's
dependent chains of the kernel's building blocks.

Cases: kitti-urban ``max_obj=80`` frame 2 (n = 160, recorded from the
serving path on the card, as ``chip_smoke.py`` records it) and seeded tied
benefits at n = 256 and 1024 (``chip_smoke.auction_benefits``, one auction,
20,000 rounds a phase). The port is held to its plain version on the first,
every build to the port bit for bit on each. Each build is timed in turns
(port, builds, builds reversed, port; device ms a call from CUDA-graph
replays), then the shares of the gain over the first version: the
cumulative chain first version -> ``off`` -> ``s1`` -> ``c2`` -> port, and
each step alone against ``off``. Beside them, the wide skeleton
(``ops.auction_skeleton_wide``: every round a CTA round) and the one-warp
skeleton over the port's rounds, the one-bidder rounds counted by a replay
of the plain rounds, and the floor they give: CTA rounds x the wide
skeleton's round + one-bidder rounds x the one-warp skeleton's. One JSON
line.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "auction_wide_probe"
SOURCE = "src/repro_torch/csrc/auction.cu"

# Text edits of the port's source: (old, end, new) replaces the one
# occurrence of ``old`` (with ``end``: the text from it to the end of the
# first ``end`` after it) by ``new``.
KERNEL = ("template <bool kResident>\n__global__ void __launch_bounds__("
          "kWideThreads)\n    auction_wide_kernel(")
SPLICE = (KERNEL, None, '#include "auction_wide_steps.cuh"\n\n' + KERNEL)
# A phase's bidder-list rounds and its one-warp rounds.
PHASE = ("    for (int k = tid; k < n; k += kWideThreads) {\n"
         "      s.holder[k] = -1;")
ONE_WARP_CALL = ("one_bidder_rounds(s, n, eps, s.lists[cur * n], it,\n"
                 "                                      max_iter, lane)")
PHASE_END = ONE_WARP_CALL + " - it;\n"
CTA_LOOP = "while (it < max_iter && c > 1) {"


def dense(one_warp: bool):
    """Steps 2 and (unless ``one_warp``) 3 undone: the first version's
    round over n."""
    return (SPLICE, (PHASE, PHASE_END, (
        f"    cta_rounds += dense_phase<{str(one_warp).lower()}>(s, n, "
        f"eps, max_iter, &own_rounds);\n")))


NO_ONE_WARP = ((CTA_LOOP, None, CTA_LOOP.replace("c > 1", "c > 0")),)
FEW4 = (SPLICE, (CTA_LOOP, None, CTA_LOOP.replace("c > 1", "c > 4")),
        (ONE_WARP_CALL, None, "few_bidder_rounds<4>(s, n, eps, s.lists + "
         "cur * n, c, it, max_iter, lane)"))


def warps(w: int):
    return (("constexpr int kWideWarps = 32;", None,
             f"constexpr int kWideWarps = {w};"),)


def stamp(after: str, seg: int, indent: str = "      "):
    return (after, None, f"{after}{indent}stamps.mark({seg});\n")


STAMPS = (
    SPLICE,
    ("  int cta_rounds = 0, own_rounds = 0;\n", None,
     "  int cta_rounds = 0, own_rounds = 0;\n  Stamps stamps;\n"
     "  const long long start_cycles = clock64();\n"
     "  const unsigned long long start_ns = global_ns();\n"),
    stamp("      if (tid == 0) *next_count = 0;\n", 5),
    ("        const Best b = merge_lanes(sc);\n", None,
     "        stamps.mark(6);\n        const Best b = merge_lanes(sc);\n"
     "        stamps.mark(7);\n"),
    ("      __syncthreads();\n      // 2. A lane a bidder", None,
     "      stamps.mark(0);\n      __syncthreads();\n      stamps.mark(1);"
     "\n      // 2. A lane a bidder"),
    ("      __syncthreads();\n      c = *next_count;\n", None,
     "      stamps.mark(2);\n      __syncthreads();\n"
     "      c = *next_count;\n"),
    stamp("      cur ^= 1;\n      ++it;\n", 3),
    stamp(PHASE_END, 4, "    "),
    ("  if (tid == 0) rounds_out[a] = *total;\n", None,
     "  if (tid == 0) {\n    rounds_out[a] = *total;\n"
     "    add_stamps(stamps, cta_rounds, *total, global_ns() - start_ns,\n"
     "               clock64() - start_cycles);\n  }\n"),
    ("// The device's opt-in shared memory", None,
     "// out: the sums of g_stamps since the last call, which zeroes them.\n"
     "MOBY_API int moby_auction_stamps(unsigned long long* out) {\n"
     "  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamps, "
     "sizeof(g_stamps));\n"
     "  const unsigned long long zero[kStampSums] = {};\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));\n"
     "  return static_cast<int>(err);\n}\n\n"
     "// The device's opt-in shared memory"))
# name -> (edits, tier, warps): the design steps undone or kept.
BUILDS = {
    "off": (dense(False), "streamed", 32),
    "s1": (dense(False), "resident", 32),
    "s2": (NO_ONE_WARP, "streamed", 32),
    "s3": (dense(True), "streamed", 32),
    "c2": (NO_ONE_WARP, "resident", 32),
    "w4": (warps(4), "resident", 4),
    "w8": (warps(8), "resident", 8),
    "w16": (warps(16), "resident", 16),
    "f4": (FEW4, "resident", 32),
}
# Not timed in turns: the port with thread 0's cycles stamped by segment of
# the round, run once a case.
STAMPED = ("stamps", STAMPS, "resident")
# tools/auction_latency.cu's cases: one step's cycles on one warp, in a
# dependent chain (the barrier: a CTA of the port's warps).
LATENCY = ("lds", "redux", "shfl", "row scan", "lane merge", "bid",
           "four-row scan", "barrier")
LATENCY_ITERS = 2000
SEGMENTS = ("bids past the merge", "barrier 1", "update", "barrier 2",
            "one-warp rounds", "rest", "row scans", "lane merges")
# The segments counted a one-warp round (the rest: a CTA round).
ONE_WARP = (4,)
CHAIN = ("parent", "off", "s1", "c2", "port")
ALONE = ("s1", "s2", "s3")
SEEDED_NS = (256, 1024)


def parent_source(arg: str) -> Path:
    """The first version's source: the file ``arg``, or ``git show`` of it
    at revision ``arg``."""
    path = Path(arg)
    if path.is_file():
        return path.resolve()
    OUT.mkdir(parents=True, exist_ok=True)
    dest = OUT / "parent.cu"
    got = subprocess.run(["git", "show", f"{arg}:{SOURCE}"], cwd=ROOT,
                         capture_output=True, text=True)
    if got.returncode:
        sys.exit(f"auction_wide_probe: no file {arg} and git show failed: "
                 f"{got.stderr.strip()} (write the parent's {SOURCE} to a "
                 f"file and pass it)")
    dest.write_text(got.stdout)
    return dest


def edited(source: Path, name: str, edits) -> Path:
    """``source`` with ``edits`` applied, written as ``OUT/name.cu``."""
    text = source.read_text()
    for old, end, new in edits:
        if text.count(old) != 1:
            sys.exit(f"auction_wide_probe: {name}'s edit no longer applies "
                     f"({text.count(old)} occurrences of {old[:60]!r})")
        at = text.index(old)
        stop = at + len(old)
        if end is not None:
            stop = text.find(end, stop)
            if stop < 0:
                sys.exit(f"auction_wide_probe: {name}'s edit no longer "
                         f"applies (no {end[:60]!r} after {old[:60]!r})")
            stop += len(end)
        text = text[:at] + new + text[stop:]
    OUT.mkdir(parents=True, exist_ok=True)
    dest = OUT / f"{name}.cu"
    dest.write_text(text)
    return dest


def start_build(name: str, source: Path):
    """Start nvcc on the source and ``errors.cu`` as a library of their
    own; ``finish_build`` waits for it."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    proc = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-I",
         str(ROOT / "tools"), "-shared", str(source),
         str(_build.CSRC / "errors.cu"), "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, lib, proc


def finish_build(name: str, lib: Path, proc):
    """The library loaded with the port's signatures of the functions it
    exports (the parent's wide entry point keeps its own), and ptxas's
    register and spill lines for the wide kernel."""
    from repro_torch.kernels import _build
    log = proc.communicate()[0]
    if proc.returncode:
        sys.exit(f"auction_wide_probe: nvcc failed for {name}:\n{log}")
    dll = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in _build.SIGNATURES.items():
        if hasattr(dll, fn):
            getattr(dll, fn).argtypes = list(argtypes)
            getattr(dll, fn).restype = restype
    if name == "parent":
        dll.moby_auction_wide.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            *[ctypes.c_void_p] * 5]
    lines = log.splitlines()
    regs = [line.strip() for i, line in enumerate(lines)
            if i and "auction_wide_kernel" in lines[i - 1]
            and ("registers" in line or "spill" in line)]
    return dll, regs


def parent_call(torch, np, dll, benefit, max_iter):
    """The first version's wrapper: a (B, 3, n) workspace, 32 warps."""
    from repro_torch.kernels.auction.ref import phase_epsilons
    n, dev = benefit.shape[-1], benefit.device
    batch = benefit.numel() // (n * n)
    eps = phase_epsilons(1e-4)
    eps32 = (ctypes.c_float * len(eps))(*(float(np.float32(e))
                                           for e in eps))
    p2o = torch.empty((batch, n), dtype=torch.int64, device=dev)
    prices = torch.empty((batch, n), dtype=torch.float32, device=dev)
    rounds = torch.empty((batch,), dtype=torch.int32, device=dev)
    work = torch.empty((batch, 3, n), dtype=torch.int32, device=dev)
    code = dll.moby_auction_wide(
        benefit.data_ptr(), batch, n, eps32, len(eps), max_iter,
        work.data_ptr(), p2o.data_ptr(), prices.data_ptr(),
        rounds.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if code:
        sys.exit(f"auction_wide_probe: the parent's call failed ({code})")
    lead = tuple(benefit.shape[:-2])
    return p2o.view(*lead, n), prices.view(*lead, n), rounds.view(lead)


def main() -> None:
    args, parent, variants = sys.argv[1:], "HEAD", []
    while args:
        if args[0] == "--parent" and len(args) > 1:
            parent, args = args[1], args[2:]
        elif args[0] == "--variant" and len(args) > 1:
            variants.append(Path(args[1]).resolve())
            args = args[2:]
        else:
            sys.exit(f"usage: {Path(__file__).name} [--parent REV|FILE.cu] "
                     f"[--variant FILE.cu ...]")
    parent_cu = parent_source(parent)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels.auction import ops as au_ops
    from repro_torch.kernels.auction import ref as au_ref
    if not torch.cuda.is_available():
        sys.exit("auction_wide_probe: torch sees no CUDA device")
    card = cs.nvidia_smi()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    port_load, port_plan = _build.load, au_ops.plan
    libs = {"port": port_load()}
    tiers = {"port": "resident", "parent": None}
    source = _build.CSRC / "auction.cu"
    todo = [("parent", parent_cu)]
    todo += [(name, edited(source, name, edits))
             for name, (edits, _, _) in BUILDS.items()]
    todo += [(f"variant{i}", path) for i, path in enumerate(variants)]
    todo_all = todo + [(STAMPED[0], edited(source, *STAMPED[:2])),
                       ("latency", ROOT / "tools" / "auction_latency.cu")]
    tiers.update((name, tier) for name, (_, tier, _) in BUILDS.items())
    tiers[STAMPED[0]] = STAMPED[2]
    tiers.update((f"variant{i}", "resident") for i in range(len(variants)))
    for name, lib, proc in [start_build(*x) for x in todo_all]:
        libs[name], regs = finish_build(name, lib, proc)
        warps = BUILDS[name][2] if name in BUILDS else au_ops.WIDE_WARPS
        print(f"build {name}: {warps} warps; " + "; ".join(regs),
              flush=True)

    dev = torch.device("cuda", 0)
    scn = api.scenario("kitti-urban", seed=0, max_obj=cs.WIDE_MAX_OBJ,
                       **cs.KITTI)
    cases = {"kitti_wide": (cs.record_auctions(
        torch, au_ops, lambda: api.Session(scn, torch_device="cuda").run(3))
        [-1], 4000)}
    for n in SEEDED_NS:
        cases[f"seeded_{n}"] = (torch.from_numpy(cs.auction_benefits(
            np, n, 1, 100 * n + 1)).to(dev), cs.WIDE_MAX_ITER)

    def call(name, benefit, max_iter):
        if name == "parent":
            return parent_call(torch, np, libs[name], benefit, max_iter)
        _build.load = lambda: libs[name]
        if tiers[name] == "streamed":
            au_ops.plan = lambda *a, **k: port_plan(*a, **k)._replace(
                tier="streamed")
        try:
            return au_ops.auction(benefit, max_iter_per_phase=max_iter)
        finally:
            _build.load, au_ops.plan = port_load, port_plan

    def stamped(benefit, max_iter):
        """Thread 0's cycles a round by segment (a CTA round's four, the
        rest a CTA round, the one-warp rounds a one-warp round), the SM
        clock in GHz, from one call of the stamped build."""
        dll = libs[STAMPED[0]]
        dll.moby_auction_stamps.argtypes = [ctypes.c_void_p]
        buf = (ctypes.c_ulonglong * (len(SEGMENTS) + 4))()
        call(STAMPED[0], benefit, max_iter)
        torch.cuda.synchronize()
        dll.moby_auction_stamps(buf)
        call(STAMPED[0], benefit, max_iter)
        torch.cuda.synchronize()
        dll.moby_auction_stamps(buf)
        got, k = list(buf), len(SEGMENTS)
        cta, one = max(got[k], 1), max(got[k + 1], 1)
        out = {f"{seg} cycles a round": got[i] / (one if i in ONE_WARP
                                                  else cta)
               for i, seg in enumerate(SEGMENTS)}
        out.update({"CTA rounds": got[k], "one-warp rounds": got[k + 1],
                    "clock GHz": got[k + 3] / max(got[k + 2], 1),
                    "launch us": got[k + 2] / 1e3})
        return out

    def latencies(benefit):
        """Cycles a step of each tools/auction_latency.cu case on this
        (n, n) matrix."""
        n = benefit.shape[-1]
        out = torch.zeros(len(LATENCY), dtype=torch.int64, device=dev)
        fn = libs["latency"].moby_auction_latency
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        code = fn(benefit.data_ptr(), n, LATENCY_ITERS,
                  au_ops.WIDE_WARPS, out.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
        if code:
            sys.exit(f"auction_wide_probe: the latency kernel failed "
                     f"({code})")
        return {k: v / LATENCY_ITERS for k, v in zip(LATENCY, out.tolist())}

    names = [n for n, _ in todo]
    result = {}
    for case, (benefit, max_iter) in cases.items():
        want = call("port", benefit, max_iter)
        if case == "kitti_wide":
            plain = au_ref.auction_ref(benefit, max_iter_per_phase=max_iter)
            if not all(torch.equal(g, w) for g, w in zip(want, plain)):
                sys.exit(f"auction_wide_probe: the port differs from its "
                         f"plain version on {case}")
        for name in names:
            got = call(name, benefit, max_iter)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                sys.exit(f"auction_wide_probe: {name} differs from the "
                         f"port on {case}")
        rounds = int(want[2].max())
        print(f"{case}: n = {benefit.shape[-1]}, {rounds} rounds; every "
              f"build equals the port bit for bit", flush=True)
        ms = {name: [] for name in ["port"] + names}
        for name in ["port"] + names + names[::-1] + ["port"]:
            def fn(name=name):
                return call(name, benefit, max_iter)
            est = cs.eager_ms(fn, torch, runs=2, warmup=1)
            ms[name].append(cs.graph_ms(fn, torch, reps=max(
                1, min(20, int(40 / est))), replays=5))
            print(f"  {name}: {ms[name][-1]:.5f} ms", flush=True)
        mean = {name: statistics.mean(v) for name, v in ms.items()}
        gain = mean["parent"] - mean["port"]
        chain = {f"{a}->{b}": (mean[a] - mean[b]) / gain
                 for a, b in zip(CHAIN, CHAIN[1:])}
        alone = {s: (mean["off"] - mean[s]) / (mean["off"] - mean["port"])
                 for s in ALONE}
        rec = dict(n=benefit.shape[-1], rounds=rounds, ms=mean, runs=ms,
                   us_a_round={k: v * 1e3 / rounds for k, v in mean.items()},
                   chain_share=chain, alone_share_of_off=alone)
        rec["wide_skeleton_ms"] = cs.graph_ms(
            lambda: au_ops.auction_skeleton_wide(want[2]), torch, reps=5)
        rec["warp_skeleton_ms"] = cs.graph_ms(
            lambda: au_ops.auction_skeleton(want[2]), torch, reps=5)
        if case == "kitti_wide":
            left = cs.bidders_a_round(torch, benefit, max_iter)[:, 0] \
                .tolist()
            if len(left) != rounds:
                sys.exit(f"auction_wide_probe: the replay ran {len(left)} "
                         f"rounds, the kernel {rounds}")
            one = sum(c == 1 for c in left)
            rec.update(one_bidder_rounds=one, bidders_mean=statistics.mean(
                left), bidders_median=statistics.median(left))
            rec["floor_ms"] = ((rounds - one) * rec["wide_skeleton_ms"]
                               + one * rec["warp_skeleton_ms"]) / rounds
        print(f"{case}: " + ", ".join(f"{k} {v:.5f}" for k, v in
                                       mean.items()), flush=True)
        print(f"  shares of the gain {gain:.5f} ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in chain.items()) + "; alone (of off -> "
              "port): " + ", ".join(f"{k} {v:.3f}" for k, v in alone.items()),
              flush=True)
        rec["stamps"] = stamped(benefit, max_iter)
        if benefit.shape[-1] ** 2 * 4 < 200000:
            rec["latency_cycles"] = latencies(benefit)
            print("  latencies (cycles a step): " + ", ".join(
                f"{k} {v:.1f}" for k, v in rec["latency_cycles"].items()),
                flush=True)
        print("  stamps: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                       rec["stamps"].items()), flush=True)
        print(f"  skeletons: wide {rec['wide_skeleton_ms']:.5f} ms, one-warp "
              f"{rec['warp_skeleton_ms']:.5f} ms"
              + (f"; one-bidder rounds {rec['one_bidder_rounds']} of "
                 f"{rounds} (bidders mean {rec['bidders_mean']:.2f}, median "
                 f"{rec['bidders_median']}); floor {rec['floor_ms']:.5f} ms"
                 if "floor_ms" in rec else ""), flush=True)
        result[case] = rec
    print(json.dumps({"auction_wide_probe": {"card": card, **result}}))


if __name__ == "__main__":
    main()
