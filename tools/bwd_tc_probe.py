#!/usr/bin/env python3
"""How K5's gradient kernels spend their time at LM T's shape, route by
route (``kernels/flash_attention/ops.py::route``).

    python3 tools/bwd_tc_probe.py [--variant FILE.cu ...]
    python3 tools/bwd_tc_probe.py --route tf32x3 --parent FILE.cu \\
        [--variant FILE.cu ...]

Needs one CUDA card and ``nvcc``. Builds into ``build/bwd_tc_probe/``, all
at once (none of it is part of the port). Every ``--variant`` is another
version of the route's source (the same C entry point; it may include
``hopper.cuh`` and ``moby_kernels.cuh``), timed beside the port.

Route ``tc`` (the default: ``csrc/flash_attention_bwd_tc.cu``, bf16) also
builds ``fixed_max``: the port's source with
``-DMOBY_BWD_TC_PROBE_FIXED_MAX=1``, whose dq kernel keeps the running max
at 0: no row max, no quad shuffles, no rescaling of the accumulator (what
a forward saving its rows' log-sum-exp would leave; exact in exact
arithmetic, and within f32's range on these normal inputs). It prints
what the online statistics cost: the port's dq kernel less ``fixed_max``'s
(the means of the two turns each), as a share of the dq kernel and of the
call.

Route ``tf32x3`` (``csrc/flash_attention_bwd.cu``, f32) takes the source
the redesign replaced as ``--parent`` (e.g. ``git show
HEAD~:src/repro_torch/csrc/flash_attention_bwd.cu > build/parent_bwd.cu``
on the commit that made it) and rebuilds the design's steps from the
port's source with the edits in ``STEP_EDITS`` (written beside the
libraries; the probe stops if an edit no longer applies):

* ``step1``: the products on the tensor cores, the dq kernel walking the
  keys twice (m and l first; the second walk's max is final, so it never
  rescales), each tile copied when it is needed;
* ``step2``: the one online walk of dq, tiles still copied when needed;
* ``port``: the port's library (step 3: the next tile in flight while one
  is consumed).

It prints each step's share of the gain over the parent (the means of
its two turns) and SDPA's f32 autograd backward on the same inputs.

Every build's gradient is first held to the plain gradient computed in
float64 within ``chip_smoke.py``'s tolerance for the route. At LM T's
shape (B=1, H=16, KV=2, S=4096, hd=128, causal; q, k, v, o, do as (B, S,
heads, hd) views, o from the port's forward) it times the builds in turns
(each once, then in reverse order): device ms a call from CUDA-graph
replays (``chip_smoke.graph_ms``) and each launch's device time from a
profile (``chip_smoke.device_kernels``), and prints one JSON line.
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
OUT = ROOT / "build" / "bwd_tc_probe"
SHAPE = (1, 16, 2, 4096, 4096, 128)   # LM T: B, H, KV, SQ = SK, hd
ROUTES = {   # source, C entry point, dtype
    "tc": ("flash_attention_bwd_tc.cu", "moby_flash_attention_bwd_tc",
           "bfloat16"),
    "tf32x3": ("flash_attention_bwd.cu", "moby_flash_attention_bwd",
               "float32"),
}

# The tf32x3 design's steps undone, as (text, replacement, count) edits of
# the port's source. Each tile copied when it is needed (no ring):
NO_RING = (
    ("  if (n_tiles > 0) {\n"
     "    load_rows<kBk, HD>(kbuf, kb, a.sk_.s, 0, a.sk);\n"
     "    load_rows<kBk, HD>(vbuf, vb, a.sv_.s, 0, a.sk);\n"
     "  }\n", "", 1),
    ("    T* kt = kbuf + it % 2 * kTile;\n",
     "    T* kt = kbuf + it % 2 * kTile;\n"
     "    load_rows<kBk, HD>(kt, kb, a.sk_.s, k0, a.sk);\n"
     "    load_rows<kBk, HD>(vbuf, vb, a.sv_.s, k0, a.sk);\n"
     "    cp_async_commit();\n", 1),
    ("    if (it + 1 < n_tiles)\n", "    if (false)\n", 2),
    ("  if (n > 0) load_stage(ring, qt0 * kBq);\n", "", 1),
    ("    char* stage = ring + it % 2 * S::kStage;\n",
     "    char* stage = ring + it % 2 * S::kStage;\n"
     "    load_stage(stage, q0);\n"
     "    cp_async_commit();\n", 1),
    ("    if (it + 1 < n)\n", "    if (false)\n", 1),
)
# dq's rows' m and l from a first walk over the keys; the second walk sums
# into a throwaway l.
TWO_PASS = (
    ("  float dq[kD][4];\n",
     "  for (int it = 0; it < n_tiles; ++it) {\n"
     "    __syncthreads();\n"
     "    load_rows<kBk, HD>(kbuf, kb, a.sk_.s, it * kBk, a.sk);\n"
     "    cp_async_commit();\n"
     "    cp_async_wait_all();\n"
     "    __syncthreads();\n"
     "    float sc[kN][4];\n"
     "    product_nt<HD, kN>(kbuf, qf, gq, tq, sc);\n"
     "    if (masked(it * kBk))\n"
     "      softmax_tile<true>(sc, m, mc, l, corr, rq, it * kBk, tq, a.sk,\n"
     "                         a.causal, c);\n"
     "    else\n"
     "      softmax_tile<false>(sc, m, mc, l, corr, rq, it * kBk, tq, a.sk,\n"
     "                          a.causal, c);\n"
     "  }\n"
     "  __syncthreads();\n"
     "  float l_again[2] = {0.0f, 0.0f};\n"
     "  float dq[kD][4];\n", 1),
    ("softmax_tile<true>(sc, m, mc, l, corr, rq, k0,",
     "softmax_tile<true>(sc, m, mc, l_again, corr, rq, k0,", 1),
    ("softmax_tile<false>(sc, m, mc, l, corr, rq, k0,",
     "softmax_tile<false>(sc, m, mc, l_again, corr, rq, k0,", 1),
)
STEP_EDITS = (("step1", NO_RING + TWO_PASS, "tensor cores, two-pass dq, "
               "no ring"),
              ("step2", NO_RING, "one online walk of dq"))


def build(name: str, source: Path, defines, entry: str):
    """The source and ``errors.cu`` as a library of their own, its C entry
    point ``entry`` loaded with the port's signature; returns it and
    ptxas's register lines."""
    from repro_torch.kernels import _build
    lib = OUT / f"lib{name}.so"
    done = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC),
         "-shared", str(source), str(_build.CSRC / "errors.cu"), "-o",
         str(lib)], capture_output=True, text=True)
    log = done.stdout + done.stderr
    if done.returncode:
        sys.exit(f"bwd_tc_probe: nvcc failed for {name}:\n{log}")
    dll = ctypes.CDLL(str(lib))
    for fn in ("moby_error_string", entry):
        argtypes, restype = _build.SIGNATURES[fn]
        getattr(dll, fn).argtypes = list(argtypes)
        getattr(dll, fn).restype = restype
    regs = [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line
            or "Performance Loss" in line]
    return dll, regs


def edited(source: Path, name: str, edits) -> Path:
    """``source`` with ``edits`` applied, written as ``OUT/name.cu``."""
    text = source.read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            sys.exit(f"bwd_tc_probe: {name}'s edit no longer applies to "
                     f"{source.name} ({text.count(old)} of {count}):\n{old}")
        text = text.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def parse(args):
    """(route, parent or None, variants) from the command line."""
    usage = (f"usage: {Path(__file__).name} [--route tc|tf32x3] "
             f"[--parent FILE.cu] [--variant FILE.cu ...]")
    route, parent = "tc", None
    while args and args[0] in ("--route", "--parent"):
        if len(args) < 2:
            sys.exit(usage)
        if args[0] == "--route":
            route = args[1]
        else:
            parent = Path(args[1]).resolve()
        args = args[2:]
    if args and (args[0] != "--variant" or len(args) < 2):
        sys.exit(usage)
    if route not in ROUTES or (route == "tf32x3") != (parent is not None):
        sys.exit(usage + " (--parent with --route tf32x3 only, and there "
                 "always)")
    return route, parent, [Path(a).resolve() for a in args[1:]]


def main() -> None:
    route, parent, variants = parse(sys.argv[1:])
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    if not torch.cuda.is_available():
        sys.exit("bwd_tc_probe: torch sees no CUDA device")
    print(f"card: {cs.nvidia_smi()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | route {route}", flush=True)

    OUT.mkdir(parents=True, exist_ok=True)
    file, entry, dtype = ROUTES[route]
    source = _build.CSRC / file
    if route == "tc":
        builds = [("fixed_max", source, ("-DMOBY_BWD_TC_PROBE_FIXED_MAX=1",))]
    else:
        builds = [("parent", parent, ())]
        builds += [(name, edited(source, name, edits), ())
                   for name, edits, _ in STEP_EDITS]
    builds += [(f"variant{i}", path, ()) for i, path in enumerate(variants)]
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        port_lib = pool.submit(_build.load)
        done = {name: pool.submit(build, name, path, defines, entry)
                for name, path, defines in builds}
        libs = {"port": port_lib.result()}
        for name, path, defines in builds:
            libs[name], regs = done[name].result()
            print(f"build {name} ({path.name}"
                  f"{' ' + ' '.join(defines) if defines else ''}): "
                  + "; ".join(r for r in regs if "spill" not in r),
                  flush=True)
    port_load = _build.load

    b, h, kv, sq, sk, hd = SHAPE
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)

    def act(heads, s):
        return torch.randn(b, s, heads, hd, generator=g, device=dev,
                           dtype=getattr(torch, dtype)).transpose(1, 2)
    q, k, v = act(h, sq), act(kv, sk), act(kv, sk)
    o = fa_ops.flash_attention(q, k, v, True)
    do = act(h, sq)

    def call(name):
        _build.load = lambda: libs[name]
        try:
            return fa_ops.flash_attention_bwd(q, k, v, o, do, True)
        finally:
            _build.load = port_load

    # The builds' results first.
    wide = [x.double() for x in (q, k, v, o, do)]
    want = fa_ref.flash_attention_bwd_ref(*wide, True)
    terms = cs.bwd_rounding_terms(torch, *wide, True) if route == "tc" \
        else None
    extra = [f"variant{i}" for i in range(len(variants))]
    if route == "tc":
        steps = ["port", "fixed_max"]
    else:
        steps = ["parent"] + [n for n, _, _ in STEP_EDITS] + ["port"]
    names = steps + extra
    for name in names:
        _, tol, _ = cs.grads_close(torch, call(name), want, name, terms)
        print(f"{name}: within {tol}", flush=True)
    del want, terms, wide
    torch.cuda.empty_cache()

    ms = {n: [] for n in names}
    passes = {n: [] for n in names}
    for name in names + names[::-1]:
        def fn(name=name):
            return call(name)
        ms[name].append(cs.graph_ms(fn, torch, reps=20 if route == "tc"
                                    else 5))
        kerns = cs.device_kernels(torch, fn, calls=10 if route == "tc"
                                  else 3)
        passes[name].append({(re.findall(r"::(\w+)[<(]", k)
                              or [k[:40]])[0]: t for k, t, _ in kerns})
        print(f"{name}: device {ms[name][-1]:.5f} ms a call; "
              + ", ".join(f"{k} {t:.5f} ms" for k, t in
                          passes[name][-1].items()), flush=True)
    mean = {n: statistics.mean(ms[n]) for n in names}
    report = {"route": route, "shape": list(SHAPE), "card": cs.nvidia_smi(),
              "ms": ms, "mean_ms": mean, "passes": passes}

    if route == "tc":
        def mean_pass(name, kernel):
            return statistics.mean(p.get(kernel, 0.0) for p in passes[name])
        dq_port = mean_pass("port", "dq_tc_kernel")
        dq_fixed = mean_pass("fixed_max", "dq_tc_kernel")
        saved = dq_port - dq_fixed
        print(f"online statistics of the dq kernel: {saved:.5f} ms of its "
              f"{dq_port:.5f} ms ({100 * saved / dq_port:.1f}%), "
              f"{100 * saved / mean['port']:.1f}% of the call "
              f"({mean['port']:.5f} ms)", flush=True)
        report.update(dq_ms=dq_port, dq_fixed_max_ms=dq_fixed,
                      online_stats_share_of_dq=saved / dq_port,
                      online_stats_share_of_call=saved / mean["port"])
    else:
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qr, kr, vr, is_causal=True, enable_gqa=True)
        sdpa_ms = cs.eager_ms(lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), do, retain_graph=True), torch, runs=20,
            warmup=3)
        print(f"SDPA's f32 autograd backward: {sdpa_ms:.5f} ms a call",
              flush=True)
        gain = mean["parent"] - mean["port"]
        shares = {}
        whats = [what for _, _, what in STEP_EDITS] + ["tiles in flight "
                                                       "(the ring)"]
        for before, after, what in zip(steps, steps[1:], whats):
            shares[after] = (mean[before] - mean[after]) / gain
            print(f"{after} ({what}): {mean[before]:.5f} -> "
                  f"{mean[after]:.5f} ms, {100 * shares[after]:.1f}% of "
                  f"the gain", flush=True)
        print(f"port / parent: {mean['port'] / mean['parent']:.4f}; port / "
              f"SDPA: {mean['port'] / sdpa_ms:.4f}", flush=True)
        report.update(sdpa_ms=sdpa_ms, share_of_gain=shares)
    for name, path in zip(extra, variants):
        print(f"{name} ({path.name}): {mean[name]:.5f} ms against the "
              f"port's {mean['port']:.5f}", flush=True)
    print(json.dumps({"bwd_tc_probe": report}))


if __name__ == "__main__":
    main()
