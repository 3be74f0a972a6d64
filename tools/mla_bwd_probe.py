#!/usr/bin/env python3
"""How K5's gradient at MLA's (qk 192, value 128) spends its time, on both
routes, beside the source it replaced and each design step undone.

    python3 tools/mla_bwd_probe.py --parent-tc FILE.cu --parent-tf FILE.cu \\
        [--variant-tc FILE.cu ...] [--variant-tf FILE.cu ...] [--others-only]

Needs one CUDA card and ``nvcc``. The card's copy has no git history, so
write the parents first (``git show REV:src/repro_torch/csrc/
flash_attention_bwd_tc.cu > build/parent_bwd_tc.cu``, likewise
``flash_attention_bwd.cu``). Builds into ``build/bwd_tc_probe/``, all at
once (``tools/bwd_tc_probe.py``'s builder; none of it is part of the
port); each ``--variant-*`` is another version of that route's source.

Route ``tc`` (bf16, ``csrc/flash_attention_bwd_tc.cu``) at MLA T's shape
(B=1, H=KV=128, S=4096, causal): the parent (a CTA an item), the port
(both kernels walking: a CTA an SM), and ``tc_vote``, the port with dQ~
rescaled only where a warp's vote finds a row's max moved (a text edit
of ``TC_VARIANTS``; it stops if one no longer applies). Route ``tf32x3``
(f32, ``csrc/flash_attention_bwd.cu``) at MLA B's shape (B=2, H=KV=128,
S=256, causal): the parent, ``tf_step1`` the 8-warp dq blocks, ``port``
with each dq warp skipping the key tiles past its last row.

First it holds every build's gradient at those shapes to the plain
gradient computed in float64, within ``chip_smoke.py``'s tolerance for
the route, the port's two calls bit for bit, and the port's outputs at
the other instances' shapes to the parent library's bit for bit (LM T's
hd 128 and hd 64, zamba2's hd 64, MoE T's G = 1, MLA A's (24, 16) in f32
and bf16, LM T's f32 hd 128, hd 16 / 32 / 64 in f32 and bf16). It compares
cuobjdump's SASS of the hd 64 and 128 instances of both kernels in the
parent and in the port's source built alone (the walk is compiled out
there). Then it times the builds in ``TURNS`` turns (forward, reverse,
...), each turn a parent/port pair (it prints the port's ratio to the
parent in each turn): device ms a call from CUDA-graph replays
(``chip_smoke.graph_ms``, with as many calls a graph as
``chip_smoke.measure`` takes) and each launch's device
time from a profile of eager calls (``chip_smoke.device_kernels``), each
step's share of the gain over the parent (the means of its turns), and
SDPA's autograd backward on the same inputs. The other instances'
shapes are timed too, in ``OTHER_TURNS`` turns of the parent, the port
and a second build of the parent (a control for the turns' order and
noise); ``--others-only`` stops after them.

The ``tc`` call's time against its kernels' sum (what a call takes
beyond its two launches) is read three ways for the parent and the port:
the graph replays of ``chip_smoke.measure`` (with the SM clock and power
sampled by ``nvidia-smi`` every 50 ms meanwhile), short replays (5 calls,
5 replays), and one graph replay under the profiler, whose kernels'
start and end stamps give the kernels' own time and the gaps between
them inside the replay. Prints one JSON line last.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import difflib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import bwd_tc_probe as btp  # noqa: E402

TC_SHAPE = (1, 128, 128, 4096, 192, 128)    # MLA T: B, H, KV, S, hd, vd
TF_SHAPE = (2, 128, 128, 256, 192, 128)     # MLA B
# The tc builds beside the port, as (text, replacement, count) edits of
# its source: dQ~ rescaled only where a warp's vote finds a row's max moved
# (a factor of exactly 1 skipped: bit for bit).
VOTE = (("        if (!kProbeFixedMax) {\n#pragma unroll\n"
         "          for (int x = 0; x < kAcc; ++x)\n",
         "        if (!kProbeFixedMax &&\n            __any_sync(0xffffffffu, "
         "corr_lo != 1.f || corr_hi != 1.f)) {\n#pragma unroll\n"
         "          for (int x = 0; x < kAcc; ++x)\n", 1),)
TC_LAST = "both kernels walking, a CTA an SM"
TC_VARIANTS = (("tc_vote", VOTE, "dQ~ rescaled only where a row's max "
                "moved"),)
# The tf32x3 step undone: dq's warps walk the dead key tiles too.
TF_STEPS = (("tf_step1",
             (("  static constexpr bool kSkipDead = true;\n",
               "  static constexpr bool kSkipDead = false;\n", 1),),
             "8-warp dq blocks"),)
TF_LAST = "dq's warps skip the key tiles past their rows"
# The other instances, held to the parent library bit for bit: (label, B,
# H, KV, S, hd, vd, dtype, causal).
OTHERS = (("LM T hd 128", 1, 16, 2, 4096, 128, 128, "bfloat16", True),
          ("LM T hd 64", 1, 16, 2, 4096, 64, 64, "bfloat16", True),
          ("zamba2 hd 64", 1, 32, 32, 4096, 64, 64, "bfloat16", True),
          ("MoE T G = 1", 1, 16, 16, 4096, 128, 128, "bfloat16", True),
          ("hd 128 ragged", 2, 8, 2, 77, 128, 128, "bfloat16", False),
          ("MLA A f32", 2, 4, 4, 16, 24, 16, "float32", True),
          ("MLA A bf16", 2, 4, 4, 16, 24, 16, "bfloat16", True),
          ("(24, 16) ragged", 2, 6, 2, 300, 24, 16, "float32", True),
          ("LM T f32", 1, 16, 2, 4096, 128, 128, "float32", True),
          ("f32 hd 16", 1, 4, 4, 77, 16, 16, "float32", True),
          ("f32 hd 32", 2, 8, 2, 77, 32, 32, "float32", False),
          ("f32 hd 64", 1, 8, 1, 256, 64, 64, "float32", True),
          ("bf16 hd 32", 1, 16, 1, 200, 32, 32, "bfloat16", True))
# Those also timed, parent and port in turns (their chip_smoke.py shapes).
OTHERS_TIMED = ("LM T hd 128", "LM T hd 64", "zamba2 hd 64", "MoE T G = 1",
                "LM T f32")
TURNS = 10   # forward, reverse, forward, ...: parent/port pairs
# The other instances' turns: 4, the parent, the port and a second build of
# the parent (a control: what the same code measures as in these turns).
OTHER_TURNS = 4


def parse():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-tc", required=True, type=Path)
    ap.add_argument("--parent-tf", required=True, type=Path)
    ap.add_argument("--variant-tc", nargs="*", default=[], type=Path)
    ap.add_argument("--variant-tf", nargs="*", default=[], type=Path)
    ap.add_argument("--others-only", action="store_true",
                    help="only the other instances' checks and times")
    return ap.parse_args()


class Clocks:
    """``nvidia-smi`` sampling the SM clock, power draw and temperature
    every 50 ms while the block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=30)[0]
        rows = [[float(x) for x in line.split(",")]
                for line in out.splitlines() if line.count(",") == 2]
        self.samples = len(rows)
        cols = list(zip(*rows)) or [(), (), ()]
        self.sm = cols[0]
        self.text = ("SM clock " + (
            f"median {statistics.median(cols[0]):.0f} MHz (min "
            f"{min(cols[0]):.0f}, max {max(cols[0]):.0f}), power median "
            f"{statistics.median(cols[1]):.1f} W (max {max(cols[1]):.1f}), "
            f"{max(cols[2]):.0f} C at most, {len(rows)} samples"
            if rows else "not sampled"))
        return False


def replay_stamps(torch, fn, calls: int):
    """One CUDA-graph replay of ``calls`` calls under the profiler: the
    kernels' device time summed, the replay's span from its first kernel's
    start to its last kernel's end, and that time by kernel name (ms a
    call); None where the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type.name == "CUDA" and "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower()]
    if not kern:
        return None
    start = min(e.time_range.start for e in kern)
    end = max(e.time_range.end for e in kern)
    busy = sum(e.time_range.elapsed_us() for e in kern)
    by = {}
    for e in kern:
        name = (re.findall(r"(\w+_kernel)", e.name) or [e.name[:40]])[0]
        by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return {"kernels_ms": busy / 1e3 / calls,
            "span_ms": (end - start) / 1e3 / calls,
            "gaps_ms": ((end - start) - busy) / 1e3 / calls,
            "launches": len(kern) / calls, "by_kernel": by}


def sass_of(lib: Path) -> dict:
    """cuobjdump's SASS of each hd instance of ``dq_tc_kernel`` and
    ``dkv_tc_kernel`` in ``lib``, keyed (kernel, qk, vd): the instructions
    alone, without addresses and encodings."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            k = re.search(r"(dkv_tc_kernel|dq_tc_kernel)ILi(\d+)ELi(\d+)E",
                          head.group(1))
            cur = (k.group(1), int(k.group(2)), int(k.group(3))) if k \
                else None
            if cur:
                funcs[cur] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if cur and ins:
            funcs[cur].append(ins.group(1))
    return funcs


def main() -> None:
    args = parse()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    if not torch.cuda.is_available():
        sys.exit("mla_bwd_probe: torch sees no CUDA device")
    card = cs.nvidia_smi()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    btp.OUT.mkdir(parents=True, exist_ok=True)
    tc_src = _build.CSRC / "flash_attention_bwd_tc.cu"
    tf_src = _build.CSRC / "flash_attention_bwd.cu"
    tc_entry, tf_entry = btp.ROUTES["tc"][1], btp.ROUTES["tf32x3"][1]
    builds = [(f"{name}{again}", path.resolve(), entry)
              for name, path, entry in (
                  ("parent_tc", args.parent_tc, tc_entry),
                  ("parent_tf", args.parent_tf, tf_entry))
              for again in ("", "_again")]
    builds += [(name, btp.edited(tc_src, name, edits), tc_entry)
               for name, edits, _ in TC_VARIANTS]
    builds.append(("port_tc_alone", tc_src, tc_entry))
    builds += [(name, btp.edited(tf_src, name, edits), tf_entry)
               for name, edits, _ in TF_STEPS]
    builds += [(f"variant_tc{i}", p.resolve(), tc_entry)
               for i, p in enumerate(args.variant_tc)]
    builds += [(f"variant_tf{i}", p.resolve(), tf_entry)
               for i, p in enumerate(args.variant_tf)]
    regs = {}
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        port_lib = pool.submit(_build.load)
        done = {name: pool.submit(btp.build, name, path, (), entry)
                for name, path, entry in builds}
        libs = {"port": port_lib.result()}
        for name, path, _ in builds:
            libs[name], regs[name] = done[name].result()
            print(f"build {name} ({path.name}): "
                  + "; ".join(r for r in regs[name] if "spill" not in r),
                  flush=True)
            for r in regs[name]:
                if "spill" in r and not r.startswith("0 bytes stack"):
                    print(f"  {name}: {r}", flush=True)
    port_load = _build.load
    libs["port_tc"] = libs["port_tf"] = libs["port"]
    sass = {"parent": sass_of(btp.OUT / "libparent_tc.so"),
            "port": sass_of(btp.OUT / "libport_tc_alone.so")}
    sass_diff = {}
    for key in sorted(sass["parent"]):
        if key[1] == 192:
            continue
        a, b = sass["parent"][key], sass["port"].get(key, [])
        # Instructions outside the longest matching runs, with register
        # numbers and branch targets masked (an added instruction shifts
        # every later address).
        norm = [[re.sub(r"0x[0-9a-f]+", "X", re.sub(r"\bU?[RPB]\d+\b", "r",
                                                    x)) for x in side]
                for side in (a, b)]
        kept = sum(m.size for m in difflib.SequenceMatcher(
            None, *norm, autojunk=False).get_matching_blocks())
        diff = len(a) + len(b) - 2 * kept
        sass_diff[f"{key[0]}<{key[1]}, {key[2]}>"] = diff
        print(f"SASS {key[0]}<{key[1]}, {key[2]}>: parent {len(a)}, port "
              f"{len(b)} instructions, " + ("identical" if a == b else
                                            f"{diff} outside the matching "
                                            "runs (registers masked)"),
              flush=True)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def inputs(b, h, kv, s, hd, vd, dtype, causal, seed=0):
        g = torch.Generator(device=dev).manual_seed(seed)

        def act(heads, dim):
            return torch.randn(b, s, heads, dim, generator=g, device=dev,
                               dtype=getattr(torch, dtype)).transpose(1, 2)
        q, k, v = act(h, hd), act(kv, hd), act(kv, vd)
        o = fa_ops.flash_attention(q, k, v, causal)
        return q, k, v, o, act(h, vd)

    def call(name, x, causal):
        _build.load = lambda: libs[name]
        try:
            return fa_ops.flash_attention_bwd(*x, causal)
        finally:
            _build.load = port_load

    def order(names, turns=TURNS):
        return [n for turn in range(turns)
                for n in (names if turn % 2 == 0 else names[::-1])]

    def reps_of(fn):   # as chip_smoke.measure: ~100 ms a graph, <= 50
        return max(1, min(50, int(100 / max(
            cs.eager_ms(fn, torch, runs=3, warmup=1), 1e-3))))

    # -- the other instances: the port equals the parent bit for bit, and
    # their times beside the parent's ---------------------------------------
    same, others_ms = {}, {}
    for label, b, h, kv, s, hd, vd, dtype, causal in OTHERS:
        x = inputs(b, h, kv, s, hd, vd, dtype, causal, seed=1)
        parent = "parent_tc" if fa_ops.route(
            getattr(torch, dtype), hd, vd) == "tc" else "parent_tf"
        got, want = call("port", x, causal), call(parent, x, causal)
        same[label] = all(torch.equal(a, w) for a, w in zip(got, want))
        print(f"{label} ({b},{h},{kv},{s},{hd}/{vd}) {dtype}: port "
              f"{'equals' if same[label] else 'DIFFERS FROM'} {parent} bit "
              f"for bit", flush=True)
        del got, want
        if label in OTHERS_TIMED:
            reps = reps_of(lambda: call("port", x, causal))
            names = [parent, "port", f"{parent}_again"]
            times = {n: [] for n in names}
            kern = {n: {} for n in names}
            for name in order(names, OTHER_TURNS):
                fn = lambda name=name: call(name, x, causal)  # noqa: E731
                times[name].append(cs.graph_ms(fn, torch, reps=reps))
                for k, ms, _ in cs.device_kernels(torch, fn, calls=10):
                    k = (re.findall(r"(\w+_kernel)", k) or [k[:40]])[0]
                    kern[name].setdefault(k, []).append(ms)
            others_ms[label] = {n: statistics.mean(v)
                                for n, v in times.items()}
            print(f"{label}: port {others_ms[label]['port']:.5f} ms, "
                  f"{parent} {others_ms[label][parent]:.5f} ms, its second "
                  f"build {others_ms[label][names[2]]:.5f} ms (means of "
                  f"{OTHER_TURNS} turns: " + "; ".join(
                      f"{n} " + ", ".join(f"{v:.5f}" for v in vs)
                      for n, vs in times.items()) + "); by kernel, means: "
                  + "; ".join(f"{n} " + ", ".join(
                      f"{k} {statistics.mean(v):.5f}" for k, v in ks.items())
                      for n, ks in kern.items()), flush=True)
        del x
    if not all(same.values()):
        sys.exit("mla_bwd_probe: an instance outside (192, 128) changed")
    if args.others_only:
        print(json.dumps({"mla_bwd_probe": {"card": card, "regs": regs,
                                            "same_as_parent": same,
                                            "others_ms": others_ms}}))
        return

    # -- the (192, 128) builds against the float64 gradient --------------
    routes = {
        "tc": (TC_SHAPE, "bfloat16", ["parent_tc"]
               + ["port_tc"] + [n for n, _, _ in TC_VARIANTS]
               + [f"variant_tc{i}" for i in range(len(args.variant_tc))],
               [TC_LAST]),
        "tf32x3": (TF_SHAPE, "float32", ["parent_tf"]
                   + [n for n, _, _ in TF_STEPS] + ["port_tf"]
                   + [f"variant_tf{i}" for i in range(len(args.variant_tf))],
                   [w for _, _, w in TF_STEPS] + [TF_LAST]),
    }
    report = {"card": card, "same_as_parent": same, "regs": regs,
              "others_ms": others_ms, "sass_differs": sass_diff}
    for route, (shape, dtype, names, whats) in routes.items():
        b, h, kv, s, hd, vd = shape
        x = inputs(b, h, kv, s, hd, vd, dtype, True)
        wide = [t.double() for t in x]
        plain = cs.bwd_heads_at_a_time(torch, fa_ref.flash_attention_bwd_ref,
                                       8)
        want = plain(*wide, True)
        terms = cs.bwd_rounding_terms(torch, *wide, True) \
            if route == "tc" else None
        del wide
        for name in names:
            _, tol, worst = cs.grads_close(torch, call(name, x, True), want,
                                           f"{route} {name}", terms)
            print(f"{route} {name}: within {tol}", flush=True)
        port = f"port_{'tc' if route == 'tc' else 'tf'}"
        first, again = call(port, x, True), call(port, x, True)
        if not all(torch.equal(p, q) for p, q in zip(first, again)):
            sys.exit(f"mla_bwd_probe: two {route} calls differ")
        del want, terms, first, again
        torch.cuda.empty_cache()

        # -- times, in turns ----------------------------------------------
        def fn_of(name):
            return lambda: call(name, x, True)
        reps = reps_of(fn_of(names[-1]))
        ms = {n: [] for n in names}
        passes = {n: [] for n in names}
        for name in order(names):
            ms[name].append(cs.graph_ms(fn_of(name), torch, reps=reps))
            kerns = cs.device_kernels(torch, fn_of(name), calls=10)
            passes[name].append({(re.findall(r"(\w+_kernel)", k)
                                  or [k[:40]])[0]: t for k, t, _ in kerns})
            print(f"{route} {name}: device {ms[name][-1]:.5f} ms a call; "
                  + ", ".join(f"{k} {t:.5f} ms" for k, t in
                              passes[name][-1].items()), flush=True)
        mean = {n: statistics.mean(ms[n]) for n in names}
        ratios = [p / q for p, q in zip(ms[port], ms[names[0]])]
        print(f"{route}: port / parent by turn " + ", ".join(
            f"{r:.4f}" for r in ratios) + f"; the port faster in "
            f"{sum(r < 1 for r in ratios)} of {len(ratios)}, median "
            f"{statistics.median(ratios):.4f}", flush=True)
        qr, kr, vr = (t.detach().requires_grad_() for t in x[:3])
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qr, kr, vr, is_causal=True, enable_gqa=True)
        sdpa = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (qr, kr, vr), x[4], retain_graph=True)
        sdpa_ms = cs.eager_ms(sdpa, torch, runs=20, warmup=3)
        sdpa_kernels = cs.device_kernels(torch, sdpa, calls=3)
        print(f"{route} SDPA's autograd backward: {sdpa_ms:.5f} ms a call; "
              + cs.kernels_line("library", sdpa_kernels[:4]), flush=True)
        parent = names[0]
        steps = names[:names.index(port) + 1]
        gain = mean[parent] - mean[port]
        shares = {}
        for before, after, what in zip(steps, steps[1:], whats):
            shares[after] = (mean[before] - mean[after]) / gain \
                if gain else 0.0
            print(f"{route} {after} ({what}): {mean[before]:.5f} -> "
                  f"{mean[after]:.5f} ms, {100 * shares[after]:.1f}% of the "
                  f"gain", flush=True)
        print(f"{route}: port {mean[port]:.5f} ms, parent "
              f"{mean[parent]:.5f} ms ({mean[port] / mean[parent]:.4f}), "
              f"SDPA {sdpa_ms:.5f} ms (port / SDPA "
              f"{mean[port] / sdpa_ms:.4f})", flush=True)
        for name in names[len(steps):]:
            print(f"{route} {name}: {mean[name]:.5f} ms against the port's "
                  f"{mean[port]:.5f}", flush=True)
        rec = {"shape": list(shape), "reps": reps, "ms": ms,
               "port_over_parent_by_turn": ratios,
               "mean_ms": mean, "passes": passes, "sdpa_ms": sdpa_ms,
               "sdpa_kernels": sdpa_kernels[:4], "share_of_gain": shares}

        # -- the tc call beyond its kernels ------------------------------
        if route == "tc":
            gap = {}
            for name in (parent, port):
                with Clocks() as clk:
                    long_ms = cs.graph_ms(fn_of(name), torch, reps=reps)
                with Clocks() as clk_eager:
                    kerns = cs.device_kernels(torch, fn_of(name), calls=10)
                short_ms = cs.graph_ms(fn_of(name), torch, reps=5,
                                       replays=5)
                stamps = replay_stamps(torch, fn_of(name), reps)
                eager_sum = sum(t for _, t, _ in kerns)
                gap[name] = {"graph_ms": long_ms, "graph_short_ms": short_ms,
                             "eager_kernels_ms": eager_sum,
                             "replay": stamps, "clock_graph": clk.text,
                             "clock_eager_profile": clk_eager.text}
                print(f"tc {name}: graph {long_ms:.5f} ms a call ({reps} "
                      f"calls a graph, 20 replays; {clk.text}); short "
                      f"graph {short_ms:.5f} ms (5 x 5); eager profile's "
                      f"kernels {eager_sum:.5f} ms ({clk_eager.text}); "
                      + ("one replay under the profiler: kernels "
                         f"{stamps['kernels_ms']:.5f} ms a call, span "
                         f"{stamps['span_ms']:.5f}, gaps "
                         f"{stamps['gaps_ms']:.5f}, {stamps['launches']:g}"
                         f" launches a call, by kernel "
                         + ", ".join(f"{k} {v:.5f}" for k, v in
                                     stamps["by_kernel"].items())
                         if stamps else "the replay's trace holds no "
                         "kernel (not measured)"), flush=True)
            rec["beyond_kernels"] = gap
        report[route] = rec
        del x, qr, kr, vr, lib_out
        torch.cuda.empty_cache()
    print(json.dumps({"mla_bwd_probe": report}))


if __name__ == "__main__":
    main()
