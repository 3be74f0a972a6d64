#!/usr/bin/env python3
"""Where the MLA decode kernel's tensor-core instance
(``csrc/mla_decode_attention.cu``) spends its time at MLA C's decode
shape, phase by phase and step by step of its design.

    python3 tools/mla_decode_probe.py [--variant FILE.cu ...]

Needs one CUDA card and ``nvcc``. Builds into ``build/mla_decode_probe/``
(none of it is part of the port) the port's source with
``-DMOBY_MLA_PROBE_SKIP=N``, whose bits leave phases of each tile out
(1 the scores Q.K^T, 2 the online softmax, 4 the P.V products, 8 the TMA
copies of the cache; their outputs are then wrong and not checked) or undo
a step of the design (16: each CTA of a cluster copies the whole tile
itself, no multicast; 32: each request's tiles cut into C / B equal runs,
not balanced by live tiles). The builds: ``no_scores``, ``no_softmax``,
``no_pv``, ``no_loads``, ``loads_only`` (7), ``products_only`` (10: no
loads, no softmax), ``step1`` (48: wgmma fed by TMA alone), ``step2``
(32: with the cluster's multicast); the port is step 3 (balanced runs).

Each ``--variant`` is another version of the source, e.g. a parent
commit's (``git show HEAD~:src/repro_torch/csrc/mla_decode_attention.cu >
build/parent.cu``). A source without ``moby_mla_decode_clusters`` (the
first version, before the clusters) is called with its own interface:
16-byte copies, ``n_split`` equal splits a request (four blocks an SM)
and scratch (n_split, B*H, R). Each variant's result is first held to the
port's.

At chip_smoke's timed case (B=16, 128 heads, a 32,768-position cache,
(R, P) = (512, 64), bf16, ragged lengths drawn with its seed) it times the
port's library and each build in turns (port, builds, builds reversed,
port): device ms a call from CUDA-graph replays (``chip_smoke.graph_ms``)
and the main pass's and the merge's device time from a profile; then SDPA
(chip_smoke's library yardstick) and the byte bound of the same case, and
one JSON line.
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
         "loads_only": 7, "products_only": 10, "step1": 48, "step2": 32}
MAIN_PASS = r"mla_decode_(tc|simt)_kernel"
MERGE = r"mla_decode_(merge|(tc_)?combine)_kernel"


def start_build(name: str, source: Path, defines=()):
    """Start nvcc on the source and ``errors.cu`` as a library of their
    own; ``finish_build`` waits for it."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    proc = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC),
         "-shared", str(source), str(_build.CSRC / "errors.cu"), "-o",
         str(lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return name, lib, proc


def finish_build(name: str, lib: Path, proc):
    """The library loaded with the port's signatures (those it exports),
    and ptxas's register, spill and performance lines for its kernels."""
    from repro_torch.kernels import _build
    log = proc.communicate()[0]
    if proc.returncode:
        sys.exit(f"mla_decode_probe: nvcc failed for {name}:\n{log}")
    dll = ctypes.CDLL(str(lib))
    for fn in ("moby_error_string", "moby_mla_decode_attention",
               "moby_mla_decode_clusters"):
        if hasattr(dll, fn):
            argtypes, restype = _build.SIGNATURES[fn]
            getattr(dll, fn).argtypes = list(argtypes)
            getattr(dll, fn).restype = restype
    lines = log.splitlines()
    regs = [line.strip() for i, line in enumerate(lines)
            if i and "mla_decode_tc_kernel" in lines[i - 1]
            and ("registers" in line or "spill" in line)]
    regs += [line.strip() for line in lines if "Performance Loss" in line]
    return dll, regs


def first_version_call(torch, dll, q_lat, q_rope, ckv, krope, lengths,
                       scale):
    """A call of the first version's interface (its wrapper as it was):
    n_split splits a request, four 64-head blocks an SM."""
    b, h, r = q_lat.shape
    s, p = ckv.shape[1], krope.shape[-1]
    dev = q_lat.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = max(1, min(4 * sms // (b * -(-h // 64)), -(-s // 32)))
    out = torch.empty((b, h, r), dtype=q_lat.dtype, device=dev)
    part_m = torch.empty((n_split, b * h), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((n_split, b * h, r), dtype=torch.float32,
                           device=dev)
    strides = (ctypes.c_longlong * 8)(*q_lat.stride()[:2],
                                      *q_rope.stride()[:2],
                                      *ckv.stride()[:2], *krope.stride()[:2])
    code = dll.moby_mla_decode_attention(
        q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
        krope.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), strides,
        b, h, s, r, p, n_split, 1, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    if code:
        sys.exit(f"mla_decode_probe: the first version's call failed "
                 f"({code})")
    return out


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
    for name, lib, proc in [start_build(*x) for x in builds]:
        libs[name], regs = finish_build(name, lib, proc)
        print(f"build {name}: " + "; ".join(regs), flush=True)

    dev = torch.device("cuda", 0)
    shape = (cs.DECODE_B, 128, cs.DECODE_MAX, 512, 64, torch.bfloat16,
             (cs.DECODE_POS_LO, cs.DECODE_MAX))
    # chip_smoke's own case 0 of the kernel (its seed 0): its inputs.
    rec, kern, _ = cs.check_mla_decode(torch, dev, mla_ops, mla_ref, *shape,
                                       0)
    print(f"port: {rec['shape']} within {rec['tol']}", flush=True)
    # check_mla_decode's inputs, from the kernel call it returned.
    args_of = dict(zip(kern.__code__.co_freevars,
                       (c.cell_contents for c in kern.__closure__)))["args"]

    def call(name):
        dll = libs[name]
        if not hasattr(dll, "moby_mla_decode_clusters"):
            return first_version_call(torch, dll, *args_of)
        _build.load = lambda: dll
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
    passes = {n: [] for n in libs}
    for name in order:
        def fn(name=name):
            return call(name)
        ms[name].append(cs.graph_ms(fn, torch, reps=20))
        kerns = cs.device_kernels(torch, fn)
        passes[name].append([sum(t for k, t, _ in kerns if re.search(pat, k))
                             for pat in (MAIN_PASS, MERGE)])
        print(f"{name}: device {ms[name][-1]:.5f} ms a call, main pass "
              f"{passes[name][-1][0]:.5f} ms, merge {passes[name][-1][1]:.5f}"
              f" ms", flush=True)
    library_ms = cs.graph_ms(rec["library"], torch, reps=5)
    bound_ms, bound_by = cs.bound(rec["bytes"], rec["ops"], rec["peak"])
    print(f"SDPA {library_ms:.5f} ms a call; bound {bound_ms:.6f} ms "
          f"({bound_by}, {rec['bytes'] / 1e6:.2f} MB)", flush=True)
    print(json.dumps({"mla_decode_probe": {
        "shape": rec["shape"], "card": cs.nvidia_smi(),
        "ms": {n: statistics.mean(v) for n, v in ms.items()},
        "main_pass_ms": {n: statistics.mean(v[0] for v in x)
                         for n, x in passes.items()},
        "merge_ms": {n: statistics.mean(v[1] for v in x)
                     for n, x in passes.items()},
        "library_ms": library_ms, "bound_ms": bound_ms, "runs": ms}}))


if __name__ == "__main__":
    main()
