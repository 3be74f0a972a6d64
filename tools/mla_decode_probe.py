#!/usr/bin/env python3
"""Where the MLA decode kernel's tensor-core instance
(``csrc/mla_decode_attention.cu``) spends its time at MLA C's decode
shape, phase by phase.

    python3 tools/mla_decode_probe.py [--variant FILE.cu ...]

Needs one CUDA card and ``nvcc``. Builds into ``build/mla_decode_probe/``
(none of it is part of the port) the port's source with
``-DMOBY_MLA_PROBE_SKIP=N``, which leaves phases of each tile out (bit 1
the scores Q.K^T, 2 the online softmax, 4 the P.V product, 8 the copies
of the cache; their outputs are then wrong and not checked), and each
``--variant``, another version of the source (the same C entry point),
whose result is first held to the plain version as ``chip_smoke.py``
holds the kernel.

At chip_smoke's timed case (B=16, 128 heads, a 32,768-position cache,
(R, P) = (512, 64), bf16, ragged lengths drawn with its seed) it times the
port's library and each build in turns (port, builds, builds reversed,
port): device ms a call from CUDA-graph replays (``chip_smoke.graph_ms``)
and the split pass's device time from a profile, then one JSON line.
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
OUT = ROOT / "build" / "mla_decode_probe"
SKIPS = {"no_scores": 1, "no_softmax": 2, "no_pv": 4, "no_loads": 8,
         "loads_only": 7}


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
        sys.exit(f"mla_decode_probe: nvcc failed for {name}:\n{log}")
    dll = ctypes.CDLL(str(lib))
    for fn in ("moby_error_string", "moby_mla_decode_attention"):
        argtypes, restype = _build.SIGNATURES[fn]
        getattr(dll, fn).argtypes = list(argtypes)
        getattr(dll, fn).restype = restype
    lines = log.splitlines()
    at = next((i for i, line in enumerate(lines)
               if "mla_decode_tc_kernel" in line), None)
    regs = [] if at is None else [line.strip() for line in lines[at + 1:at + 3]]
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
    from repro_torch.kernels.mla_decode_attention import ops as mla_ops
    from repro_torch.kernels.mla_decode_attention import ref as mla_ref
    if not torch.cuda.is_available():
        sys.exit("mla_decode_probe: torch sees no CUDA device")
    print(f"card: {cs.nvidia_smi()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    libs = {"port": _build.load()}
    port_load = _build.load
    source = _build.CSRC / "mla_decode_attention.cu"
    builds = [(name, source, (f"-DMOBY_MLA_PROBE_SKIP={bits}",))
              for name, bits in SKIPS.items()]
    builds += [(f"variant{i}", path, ()) for i, path in enumerate(variants)]
    for name, path, defines in builds:
        libs[name], regs = build(name, path, defines)
        print(f"build {name}: " + "; ".join(regs), flush=True)

    dev = torch.device("cuda", 0)
    shape = (cs.DECODE_B, 128, cs.DECODE_MAX, 512, 64, torch.bfloat16,
             (cs.DECODE_POS_LO, cs.DECODE_MAX))
    # chip_smoke's own case 0 of the kernel (its seed 0): its inputs.
    rec, kern, _ = cs.check_mla_decode(torch, dev, mla_ops, mla_ref, *shape,
                                       0)
    print(f"port: {rec['shape']} within {rec['tol']}", flush=True)

    def call(name):
        _build.load = lambda: libs[name]
        try:
            return kern()
        finally:
            _build.load = port_load

    for name in [n for n, _, _ in builds if n.startswith("variant")]:
        got = call(name)
        want = kern()
        err = float((got.float() - want.float()).abs().max())
        print(f"{name}: max abs difference from the port {err:.4g}",
              flush=True)

    names = [n for n, _, _ in builds]
    order = ["port"] + names + names[::-1] + ["port"]
    ms = {n: [] for n in libs}
    split = {n: [] for n in libs}
    for name in order:
        def fn(name=name):
            return call(name)
        ms[name].append(cs.graph_ms(fn, torch, reps=20))
        kerns = cs.device_kernels(torch, fn)
        split[name].append(sum(t for k, t, _ in kerns
                               if re.search(r"mla_decode_(tc|simt)", k)))
        print(f"{name}: device {ms[name][-1]:.5f} ms a call, the split pass "
              f"{split[name][-1]:.5f} ms", flush=True)
    print(json.dumps({"mla_decode_probe": {
        "shape": rec["shape"], "card": cs.nvidia_smi(),
        "ms": {n: statistics.mean(v) for n, v in ms.items()},
        "split_pass_ms": {n: statistics.mean(v) for n, v in split.items()},
        "runs": ms}}))


if __name__ == "__main__":
    main()
