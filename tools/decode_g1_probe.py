#!/usr/bin/env python3
"""K6's bf16 G = 1 layout (``decode_g1_kernel`` of
``csrc/decode_attention.cu``) at whisper-small's decode shapes and at
MoE C's, beside the source it replaced and with its design steps undone.

    python3 tools/decode_g1_probe.py --parent FILE.cu [--variant FILE.cu ...]

Needs one CUDA card and ``nvcc``. ``--parent`` is the source before the
G = 1 layout (the card's copy has no git history: write it first, e.g.
``git show 8c53bf9:src/repro_torch/csrc/decode_attention.cu >
build/parent_decode.cu``); every ``--variant`` another version of the
port's source with the same C entry points. Builds into
``build/decode_g1_probe/``, all at once (none of it is part of the port):

* ``parent`` and ``parent_again``: the parent's source, built twice (the
  second a control for the turns' order and noise), called through the
  grouped layout (the parent has no other);
* ``barrier``: the port's source with a block barrier in every tile step
  (each warp runs as many steps as the block's longest), by text edits
  (``EDITS``; the probe stops if one no longer applies);
* ``stages2``: the port's source with a ring of 2 tiles a warp (1 in
  flight), timed with the port's plan and with the plan of 2-stage
  blocks (``stages2_plan``: more blocks an SM, so more units a row);
* ``loads_only``: the port's source with the arithmetic left out (the
  copies, waits and the merge; timed, not checked);
* ``port``: the port's library.

The design's steps, each the one before it plus one change: ``step1`` the
G = 1 layout, no empty head slot, with a block barrier a tile and the
parent's 512-position split (``barrier`` called with a plan of 512
positions a unit); ``step2`` the barrier gone (the port's library, that
plan); ``port`` S split by the grid (``ops.g1_plan``). At whisper's cross
caches (B=16, H=KV=12, S=1500, all live), its self cache (S=448,
``chip_smoke.py``'s ragged positions with one empty request) and MoE C's
(B=16, H=KV=16, S=32768, hd 128, positions drawn in [8192, 32768) as
``chip_smoke.py``'s case draws them; the G = 1 layout forced at hd 128,
beside the port as it ships), every build's output is held to the plain
version within ``chip_smoke.py``'s bf16 tolerance. Then the builds are
timed in ``TURNS`` turns (forward, reverse, ...): device ms a call from
CUDA-graph replays (``chip_smoke.graph_ms``), SDPA on the same inputs in
every turn; it prints the port's ratio to the parent in each turn, each
step's share of the gain, the launches' device times from a profile and
the bytes bound.

Every instance the G = 1 layout does not take (f32 at every G, bf16 at
G > 1, and bf16 hd 128 at G = 1 unless ``G1_HEAD_DIMS`` takes it) is held
to the parent library bit for bit; LM C's G = 8 and VLM C's G = 6 shapes
are timed in ``OTHER_TURNS`` turns of the parent, the port and the
parent's second build. Prints one JSON line last.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "decode_g1_probe"
SOURCE = "decode_attention.cu"
ENTRIES = ("moby_error_string", "moby_decode_attention",
           "moby_decode_attention_chunk", "moby_decode_attention_g1")
# The design's steps undone, as (text, replacement, count) edits of the
# port's source.
BARRIER = (
    ("  for (int i = 0; i < my_n; ++i) {\n",
     "  for (int i = 0; i < (n_tiles + kG1Warps - 1) / kG1Warps; ++i) {\n",
     1),
    ("    __syncwarp();   // every lane's; the stage of tile i - 1 is free\n",
     "    __syncthreads();\n    if (i >= my_n) continue;\n", 1),
)
STAGES2 = (("constexpr int kG1Stages = 3;", "constexpr int kG1Stages = 2;",
            1),)
# The arithmetic left out: the copies, waits and the merge alone (its
# output is wrong: timed, not checked).
LOADS_ONLY = (
    ("    // Scores: lane j takes position t0 + j, its K row by 16-byte "
     "reads,\n",
     "    if (a.n_heads < 0) {\n    // Scores: lane j takes position t0 + "
     "j, its K row by 16-byte reads,\n", 1),
    ("      for (int e = 0; e < 8; ++e) acc[e] = __fmaf_rn(pj, vx[e], "
     "acc[e]);\n    }\n  }\n",
     "      for (int e = 0; e < 8; ++e) acc[e] = __fmaf_rn(pj, vx[e], "
     "acc[e]);\n    }\n    }\n  }\n", 1),
)
EDITS = (("barrier", BARRIER), ("stages2", STAGES2),
         ("loads_only", LOADS_ONLY))
# Timed, not checked.
SKELETONS = ("loads_only",)
# The parent's split: 512 positions a unit (kChunk).
PARENT_SPAN = 512
TURNS = 10
OTHER_TURNS = 4
# chip_smoke.py's Audio C self-cache positions (its phase-3 case).
SELF_POS = [0, 448, 1, 77, 200, 300, 447, 64, 128, 256, 333, 400, 5, 17,
            100, 250]
# (label, B, H, KV, S, hd, dtype, positions: a list or (lo, hi), seed).
SHAPES = (("whisper_cross", 16, 12, 12, 1500, 64, "bfloat16", [1500] * 16,
           13),
          ("whisper_self", 16, 12, 12, 448, 64, "bfloat16", SELF_POS, 12),
          ("moe_c", 16, 16, 16, 32768, 128, "bfloat16", (8192, 32768), 5))
# The instances outside the G = 1 layout, held to the parent bit for bit
# (chip_smoke.py's phase-3 shapes): (label, B, H, KV, S, hd, dtype, pos).
OTHERS = (("LM C G = 8", 16, 16, 2, 32768, 128, "bfloat16", (8192, 32768)),
          ("VLM C G = 6", 16, 12, 2, 32768, 128, "bfloat16", (8192, 32768)),
          ("f32 G = 4", 4, 8, 2, 1024, 128, "float32", (1, 1025)),
          ("f32 G = 8 hd 64", 2, 8, 1, 700, 64, "float32", [1, 700]),
          ("f32 G = 2 hd 16", 2, 4, 2, 32, 16, "float32", [0, 17]),
          ("f32 G = 6", 2, 12, 2, 1000, 128, "float32", [1, 1000]),
          ("f32 G = 1 hd 64", 3, 4, 4, 300, 64, "float32", [0, 77, 300]),
          ("f32 G = 1 hd 128", 2, 8, 8, 1500, 128, "float32", [1500, 3]),
          ("bf16 G = 2 hd 16", 2, 4, 2, 100, 16, "bfloat16", [0, 97]),
          ("G = 3", 3, 6, 2, 700, 128, "bfloat16", [0, 77, 700]),
          ("G = 16", 2, 32, 2, 600, 128, "bfloat16", [600, 333]),
          ("G = 48", 2, 48, 1, 500, 128, "bfloat16", [0, 500]),
          ("bf16 G = 1 hd 128", 3, 4, 4, 300, 128, "bfloat16", [0, 77, 300]))
OTHERS_TIMED = ("LM C G = 8", "VLM C G = 6")


def edited(source: Path, name: str, edits) -> Path:
    """``source`` with ``edits`` applied, written as ``OUT/name.cu``."""
    text = source.read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            sys.exit(f"decode_g1_probe: {name}'s edit no longer applies to "
                     f"{source.name} ({text.count(old)} of {count}):\n{old}")
        text = text.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def build(name: str, source: Path):
    """The source and ``errors.cu`` as a library of their own, loaded with
    the port's signatures (the entry points it has); returns it and
    ptxas's register lines."""
    from repro_torch.kernels import _build
    lib = OUT / f"lib{name}.so"
    done = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", str(source), str(_build.CSRC / "errors.cu"), "-o",
         str(lib)], capture_output=True, text=True)
    log = done.stdout + done.stderr
    if done.returncode:
        sys.exit(f"decode_g1_probe: nvcc failed for {name}:\n{log}")
    dll = ctypes.CDLL(str(lib))
    for fn in ENTRIES:
        if hasattr(dll, fn):
            argtypes, restype = _build.SIGNATURES[fn]
            getattr(dll, fn).argtypes = list(argtypes)
            getattr(dll, fn).restype = restype
    return dll, kernel_regs(log)


def kernel_regs(log: str) -> list:
    """ptxas's registers and spill stores of each decode kernel instance
    in a build log, one line each."""
    out, name, spills = [], None, "?"
    for line in log.splitlines():
        entry = re.search(r"(decode_(?:g1|partial|combine)_kernel)ILi(\d+)E"
                          r"(f|13__nv_bfloat16)?", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if "Compiling entry" in line:
            name = entry and (f"{entry.group(1)}<{entry.group(2)}"
                              + {"f": ", f32", None: ""}.get(
                                  entry.group(3), ", bf16") + ">")
            spills = spill.group(1) if spill else "?"
        elif name and spill:
            spills = spill.group(1)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name} {regs} registers, {spills} bytes spill "
                       f"stores")
            name = None
    return out


def parse(args):
    usage = (f"usage: {Path(__file__).name} --parent FILE.cu "
             f"[--variant FILE.cu ...]")
    if len(args) < 2 or args[0] != "--parent":
        sys.exit(usage)
    parent, rest = Path(args[1]).resolve(), args[2:]
    if rest and (rest[0] != "--variant" or len(rest) < 2):
        sys.exit(usage)
    return parent, [Path(a).resolve() for a in rest[1:]]


def main() -> None:
    parent, variants = parse(sys.argv[1:])
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    if not torch.cuda.is_available():
        sys.exit("decode_g1_probe: torch sees no CUDA device")
    card = cs.nvidia_smi()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    OUT.mkdir(parents=True, exist_ok=True)
    source = _build.CSRC / SOURCE
    builds = [("parent", parent), ("parent_again", parent)]
    builds += [(name, edited(source, name, edits)) for name, edits in EDITS]
    builds += [(f"variant{i}", path) for i, path in enumerate(variants)]
    regs = {}
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        port_lib = pool.submit(_build.load)
        done = {name: pool.submit(build, name, path)
                for name, path in builds}
        libs = {"port": port_lib.result()}
        for name, path in builds:
            libs[name], regs[name] = done[name].result()
            print(f"build {name} ({path.name}): " + "; ".join(
                r for r in regs[name] if "g1" in r or "bf16" in r),
                flush=True)
    port_log = _build.library_path().with_suffix(".log").read_text()
    regs["port"] = kernel_regs(port_log.split(f"--- {SOURCE}")[1]
                               .split("--- ")[0])
    print("build port: " + "; ".join(regs["port"]), flush=True)

    dev = torch.device("cuda", 0)
    port_load, port_layout, port_plan = (_build.load, dec_ops.layout,
                                         dec_ops.g1_plan)

    def g1_always(dtype, hd, group):
        return "g1" if dtype == torch.bfloat16 and group == 1 \
            else "grouped"

    def parent_plan(s, rows, hd, sms):
        return PARENT_SPAN, max(1, -(-s // PARENT_SPAN))

    def stages2_plan(s, rows, hd, sms):   # the plan of 2-stage rings
        stages = dec_ops.G1_STAGES
        dec_ops.G1_STAGES = 2
        try:
            return port_plan(s, rows, hd, sms)
        finally:
            dec_ops.G1_STAGES = stages

    # (library, layout, plan) of each name timed at the G = 1 shapes.
    calls = {"parent": ("parent", None, None),
             "parent_again": ("parent_again", None, None),
             "step1": ("barrier", g1_always, parent_plan),
             "step2": ("port", g1_always, parent_plan),
             "port": ("port", g1_always, port_plan),
             "stages2": ("stages2", g1_always, port_plan),
             "stages2_plan": ("stages2", g1_always, stages2_plan),
             "loads_only": ("loads_only", g1_always, port_plan),
             **{f"variant{i}": (f"variant{i}", g1_always, port_plan)
                for i in range(len(variants))}}
    steps = ["parent", "step1", "step2", "port"]
    whats = ["the G = 1 layout (no empty head slot; a block barrier a "
             "tile, 512 positions a unit)", "no barrier in the tile loop",
             "S split by the grid"]
    names = list(calls)

    def grouped(dtype, hd, group):
        return "grouped"

    def call(name, x):
        lib, kind, plan = calls[name]
        _build.load = lambda: libs[lib]
        dec_ops.layout = kind or grouped
        dec_ops.g1_plan = plan or port_plan
        try:
            return dec_ops.decode_attention(*x)
        finally:
            _build.load, dec_ops.layout, dec_ops.g1_plan = (
                port_load, port_layout, port_plan)

    def shipped(x):   # the port as it ships (its own layout choice)
        return dec_ops.decode_attention(*x)

    def inputs(b, h, kv, s, hd, dtype, pos, seed):
        """chip_smoke.check_decode's inputs for its case of ``seed``."""
        g = torch.Generator(device=dev).manual_seed(seed)
        dt = getattr(torch, dtype)
        q = torch.randn(b, 1, h, hd, generator=g, device=dev, dtype=dt)[:, 0]
        ck, cv = (torch.randn(b, s, kv, hd, generator=g, device=dev,
                              dtype=dt).transpose(1, 2) for _ in range(2))
        if isinstance(pos, tuple):
            pos = torch.randint(*pos, (b,), generator=g, device=dev,
                                dtype=torch.int32)
        else:
            pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        return q, ck, cv, pos

    def order(ns, turns):
        return [n for turn in range(turns)
                for n in (ns if turn % 2 == 0 else ns[::-1])]

    def reps_of(fn):   # as chip_smoke.measure: ~100 ms a graph, <= 50
        return max(1, min(50, int(100 / max(
            cs.eager_ms(fn, torch, runs=3, warmup=1), 1e-3))))

    # -- the other instances: bit for bit with the parent, and times --
    same, others_ms = {}, {}
    for label, b, h, kv, s, hd, dtype, pos in OTHERS:
        x = inputs(b, h, kv, s, hd, dtype, pos, 1)
        if dec_ops.layout(x[0].dtype, hd, h // kv) == "g1":
            continue   # taken by the G = 1 layout: held to the plain below
        same[label] = bool(torch.equal(shipped(x), call("parent", x)))
        print(f"{label} ({b},{h},{kv},{s},{hd}) {dtype}: port "
              f"{'equals' if same[label] else 'DIFFERS FROM'} the parent bit "
              f"for bit", flush=True)
        if label in OTHERS_TIMED:
            ns = ["parent", "port", "parent_again"]
            fns = {"parent": lambda: call("parent", x),
                   "parent_again": lambda: call("parent_again", x),
                   "port": lambda: shipped(x)}
            reps = reps_of(fns["port"])
            times = {n: [] for n in ns}
            for n in order(ns, OTHER_TURNS):
                times[n].append(cs.graph_ms(fns[n], torch, reps=reps))
            others_ms[label] = {n: statistics.mean(v)
                                for n, v in times.items()}
            print(f"{label}: port {others_ms[label]['port']:.5f} ms, parent "
                  f"{others_ms[label]['parent']:.5f}, its second build "
                  f"{others_ms[label]['parent_again']:.5f} (port / parent "
                  f"{others_ms[label]['port'] / others_ms[label]['parent']:.4f}"
                  f"; means of {OTHER_TURNS} turns: " + "; ".join(
                      f"{n} " + ", ".join(f"{v:.5f}" for v in vs)
                      for n, vs in times.items()) + ")", flush=True)
        del x
        torch.cuda.empty_cache()

    # -- the G = 1 shapes ------------------------------------------------
    report = {"card": card, "regs": regs, "same_as_parent": same,
              "others_ms": others_ms}
    for label, b, h, kv, s, hd, dtype, pos, seed in SHAPES:
        x = inputs(b, h, kv, s, hd, dtype, pos, seed)
        q, ck, cv, cpos = x
        f32 = (q.float(), ck.float(), cv.float(), cpos)
        for name in (n for n in names if n not in SKELETONS):
            err, tol, _, worst = cs.attention_close(
                torch, call(name, x), dec_ref.decode_attention_ref, f32, x,
                f"{label} {name}")
            print(f"{label} {name}: max abs err {err:.3g}, {tol}",
                  flush=True)
        first, again = call("port", x), call("port", x)
        if not torch.equal(first, again):
            sys.exit(f"decode_g1_probe: {label}: two calls differ")
        layout_shipped = dec_ops.layout(q.dtype, hd, h // kv)
        span, units = port_plan(s, b * h, hd, dec_ops._sm_count(0))
        print(f"{label}: the port ships the {layout_shipped} layout here; "
              f"the G = 1 plan: {span} positions a unit, {units} a row",
              flush=True)
        fns = {n: (lambda n=n: call(n, x)) for n in names}
        live = int(cpos.clamp(max=s).sum())
        n_bytes = (2 * b * h * hd + 2 * kv * hd * live) * 2 + 4 * b
        bound_ms = n_bytes / cs.PEAK_BYTES_PER_S * 1e3
        mask = (torch.arange(s, device=dev)[None, :]
                < cpos[:, None])[:, None, None]
        fns["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], ck, cv, attn_mask=mask, enable_gqa=True)
        timed = names + ["sdpa"]
        reps = reps_of(fns["port"])
        ms = {n: [] for n in timed}
        for n in order(timed, TURNS):
            ms[n].append(cs.graph_ms(fns[n], torch, reps=reps))
        mean = {n: statistics.mean(v) for n, v in ms.items()}
        ratios = [p / r for p, r in zip(ms["port"], ms["parent"])]
        kerns = {n: cs.device_kernels(torch, fns[n], calls=10)
                 for n in ("parent", "port", "sdpa")}
        gain = mean["parent"] - mean["port"]
        shares = {after: (mean[before] - mean[after]) / gain if gain else 0.0
                  for before, after in zip(steps, steps[1:])}
        print(f"{label}: bound {bound_ms:.6f} ms (bytes, "
              f"{n_bytes / 1e6:.2f} MB); {reps} calls a graph, means of "
              f"{TURNS} turns: " + ", ".join(
                  f"{n} {mean[n]:.5f}" for n in timed), flush=True)
        print(f"{label}: port / parent by turn " + ", ".join(
            f"{r:.4f}" for r in ratios) + f"; the port faster in "
            f"{sum(r < 1 for r in ratios)} of {len(ratios)}; port "
            f"{mean['port']:.5f} ms = {mean['port'] / bound_ms:.3f}x the "
            f"bound, {mean['port'] / mean['sdpa']:.4f}x SDPA "
            f"({mean['sdpa']:.5f}); parent {mean['parent']:.5f} ms "
            f"({mean['parent'] / mean['sdpa']:.4f}x SDPA); the parent's "
            f"second build {mean['parent_again']:.5f}", flush=True)
        for (before, after), what in zip(zip(steps, steps[1:]), whats):
            print(f"{label} {after} ({what}): {mean[before]:.5f} -> "
                  f"{mean[after]:.5f} ms, {100 * shares[after]:.1f}% of the "
                  f"gain", flush=True)
        for n in names[len(steps) + 1:]:
            print(f"{label} {n}: {mean[n]:.5f} ms against the port's "
                  f"{mean['port']:.5f}", flush=True)
        for n, ks in kerns.items():
            print(cs.kernels_line(f"{label} {n}", ks[:4]), flush=True)
        report[label] = {
            "shape": [b, h, kv, s, hd, dtype], "live_positions": live,
            "bytes": n_bytes, "bound_ms": bound_ms, "reps": reps,
            "plan": [span, units], "shipped_layout": layout_shipped,
            "ms": ms, "mean_ms": mean, "port_over_parent_by_turn": ratios,
            "share_of_gain": shares,
            "kernels": {n: ks[:4] for n, ks in kerns.items()}}
        del x, q, ck, cv, cpos, f32, fns, mask
        torch.cuda.empty_cache()
    if not all(same.values()):
        print(json.dumps({"decode_g1_probe": report}))
        sys.exit("decode_g1_probe: an instance outside the G = 1 layout "
                 "changed")
    print(json.dumps({"decode_g1_probe": report}))


if __name__ == "__main__":
    main()
