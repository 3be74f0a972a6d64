#!/usr/bin/env python3
"""How K5's tensor-core gradient (``csrc/flash_attention_bwd_tc.cu``)
spends its time at LM T's shape, and what its dq kernel's online row
statistics (the running max and the rescaling, which a forward that saved
its rows' log-sum-exp would make unnecessary) cost.

    python3 tools/bwd_tc_probe.py [--variant FILE.cu ...]

Needs one CUDA card and ``nvcc``. Builds into ``build/bwd_tc_probe/`` (none
of it is part of the port):

* ``fixed_max``: the port's source with ``-DMOBY_BWD_TC_PROBE_FIXED_MAX=1``,
  whose dq kernel keeps the running max at 0: no row max, no quad
  shuffles, no rescaling of the accumulator (what a saved log-sum-exp
  would leave; exact in exact arithmetic, and within f32's range on these
  normal inputs);
* each ``--variant``: another version of the source (the same C entry
  point; it may include ``hopper.cuh`` and ``moby_kernels.cuh``).

Every build's gradient is first held to the plain gradient computed in
float64 within ``chip_smoke.py``'s allowance for the tensor-core route.

At LM T's shape (B=1, H=16, KV=2, S=4096, hd=128, bf16, causal; q, k, v,
o, do as (B, S, heads, hd) views, o from the port's forward) it times the
port's library and each build in turns (port, builds, builds reversed,
port): device ms a call from CUDA-graph replays (``chip_smoke.graph_ms``)
and each launch's device time from a profile (``chip_smoke.device_kernels``),
then prints what the online statistics cost: the port's dq kernel less
the ``fixed_max`` build's (the means of the two turns each), as a share of
the dq kernel and of the call, and one JSON line.
"""
from __future__ import annotations

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


def build(name: str, source: Path, defines=()):
    """The source and ``errors.cu`` as a library of their own, loaded with
    the port's signatures; returns it and ptxas's register lines."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    done = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC),
         "-shared", str(source), str(_build.CSRC / "errors.cu"), "-o",
         str(lib)], capture_output=True, text=True)
    log = done.stdout + done.stderr
    if done.returncode:
        sys.exit(f"bwd_tc_probe: nvcc failed for {name}:\n{log}")
    dll = ctypes.CDLL(str(lib))
    for fn in ("moby_error_string", "moby_flash_attention_bwd_tc"):
        argtypes, restype = _build.SIGNATURES[fn]
        getattr(dll, fn).argtypes = list(argtypes)
        getattr(dll, fn).restype = restype
    regs = [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line
            or "Performance Loss" in line]
    return dll, regs


def main() -> None:
    args = sys.argv[1:]
    if args and (args[0] != "--variant" or len(args) < 2):
        sys.exit(f"usage: {Path(__file__).name} [--variant FILE.cu ...]")
    variants = [Path(a).resolve() for a in args[1:]]
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
          f"{torch.version.cuda}", flush=True)

    libs = {"port": _build.load()}
    port_load = _build.load
    source = _build.CSRC / "flash_attention_bwd_tc.cu"
    builds = [("fixed_max", source, ("-DMOBY_BWD_TC_PROBE_FIXED_MAX=1",))]
    builds += [(f"variant{i}", path, ()) for i, path in enumerate(variants)]
    for name, path, defines in builds:
        libs[name], regs = build(name, path, defines)
        print(f"build {name} ({path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}"
              f"{' ' + ' '.join(defines) if defines else ''}): "
              + "; ".join(r for r in regs if "spill" not in r), flush=True)

    b, h, kv, sq, sk, hd = SHAPE
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def act(heads, s):
        return torch.randn(b, s, heads, hd, generator=g, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)
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
    terms = cs.bwd_rounding_terms(torch, *wide, True)
    for name in ["port"] + [n for n, _, _ in builds]:
        _, tol, _ = cs.grads_close(torch, call(name), want, name, terms)
        print(f"{name}: within {tol}", flush=True)
    del want, terms, wide
    torch.cuda.empty_cache()

    names = [n for n, _, _ in builds]
    order = ["port"] + names + names[::-1] + ["port"]
    ms = {n: [] for n in libs}
    passes = {n: [] for n in libs}
    for name in order:
        def fn(name=name):
            return call(name)
        ms[name].append(cs.graph_ms(fn, torch, reps=20))
        kerns = cs.device_kernels(torch, fn)
        passes[name].append({(re.findall(r"::(\w+)\(", k) or [k[:40]])[0]: t
                             for k, t, _ in kerns})
        print(f"{name}: device {ms[name][-1]:.5f} ms a call; "
              + ", ".join(f"{k} {t:.5f} ms" for k, t in
                          passes[name][-1].items()), flush=True)

    def mean_pass(name, kernel):
        return statistics.mean(p.get(kernel, 0.0) for p in passes[name])
    dq_port = mean_pass("port", "dq_tc_kernel")
    dq_fixed = mean_pass("fixed_max", "dq_tc_kernel")
    call_port = statistics.mean(ms["port"])
    saved = dq_port - dq_fixed
    print(f"online statistics of the dq kernel: {saved:.5f} ms of its "
          f"{dq_port:.5f} ms ({100 * saved / dq_port:.1f}%), "
          f"{100 * saved / call_port:.1f}% of the call ({call_port:.5f} ms)",
          flush=True)
    print(json.dumps({"bwd_tc_probe": {
        "shape": list(SHAPE), "card": cs.nvidia_smi(),
        "ms": {n: ms[n] for n in libs},
        "passes": {n: passes[n] for n in libs},
        "dq_ms": dq_port, "dq_fixed_max_ms": dq_fixed, "call_ms": call_port,
        "online_stats_share_of_dq": saved / dq_port,
        "online_stats_share_of_call": saved / call_port}}))


if __name__ == "__main__":
    main()
