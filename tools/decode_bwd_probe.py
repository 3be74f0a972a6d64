#!/usr/bin/env python3
"""K6's gradient (``csrc/decode_attention_bwd.cu``) at the decode shape,
beside another version of its source and with design steps undone.

    python3 tools/decode_bwd_probe.py --parent FILE.cu [--variant FILE.cu ...]

Needs one CUDA card and ``nvcc``. ``--parent`` is the source the redesign
replaced (the card's copy has no git history: write it first, e.g. ``git
show 2f1d935:src/repro_torch/csrc/decode_attention_bwd.cu >
build/parent_dec_bwd.cu``); every ``--variant`` another version of the
source with the same C entry points. The design's steps are undone by
text edits of the port's source (``STEPS``, ``SKELETONS``; written
beside the libraries; the probe stops if an edit no longer applies).
Builds into
``build/decode_bwd_probe/``, all at once (none of it is part of the port):

* ``parent``: the parent's source;
* ``narrow``: dK, dV and their zeros stored one element at a time (the
  zeros by consecutive threads on consecutive elements, as the parent
  stores them; the 16-byte stores undone);
* ``no_ring``: no tile in flight, each tile waited for as it is issued
  (the ring undone);
* ``simt``: S and dP on the SIMT cores, as the f32 instances take them
  (the tensor cores undone);
* ``skeleton``: the arithmetic left out (the copies, barriers and stores
  alone; its gradients are wrong: timed, not checked);
* ``port``: the port's library.

At the decode shape (B=16, H=16, KV=2, S=32768, hd=128, bf16, positions
drawn in [8192, 32768) from ``chip_smoke.py``'s generator and seed for
its first case, request 3 empty), each build's gradient is first held to
the plain gradient computed in float64 within ``chip_smoke.py``'s bf16
tolerance, the empty request all zeros and two calls equal bit for bit.
Then the builds are timed in turns (each once, then in reverse order):
device ms a call from CUDA-graph replays (``chip_smoke.graph_ms``) and each
launch's device time from a profile (``chip_smoke.device_kernels``). It
prints the means, each step's share of the gain over the parent (a step
undone, less the port, over the parent less the port), each pass's share
of the call, SDPA's autograd backward on the same inputs and the bytes
bound, and one JSON line.
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
OUT = ROOT / "build" / "decode_bwd_probe"
SOURCE = "decode_attention_bwd.cu"
ENTRIES = ("moby_error_string", "moby_decode_attention_bwd",
           "moby_decode_attention_bwd_chunk",
           "moby_decode_attention_bwd_smem")
# The design's steps undone, as (text, replacement, count) edits of the
# port's source.
NARROW = (
    ("  for (int i = threadIdx.x; i < (r1 - r0) * L::kPieces; "
     "i += kThreads) {\n"
     "    const long long r = r0 + i / L::kPieces;\n"
     "    const int col = i % L::kPieces * L::kPer;\n"
     "    *reinterpret_cast<uint4*>(dk + r * dks + col) = z;\n"
     "    *reinterpret_cast<uint4*>(dv + r * dvs + col) = z;\n"
     "  }\n",
     "  (void)z;\n"
     "  for (int i = threadIdx.x; i < (r1 - r0) * HD; i += kThreads) {\n"
     "    const long long r = r0 + i / HD;\n"
     "    narrow(dk + r * dks + i % HD, 0.f);\n"
     "    narrow(dv + r * dvs + i % HD, 0.f);\n"
     "  }\n", 1),
    ("      store_rows<HD, T>(dkp, a.dk_s, dk, t0 + j0, col, end);\n"
     "      store_rows<HD, T>(dvp, a.dv_s, dv, t0 + j0, col, end);\n",
     "#pragma unroll\n"
     "      for (int i = 0; i < kIt; ++i)\n"
     "        if (t0 + j0 + i < end)\n"
     "#pragma unroll\n"
     "          for (int c = 0; c < 4; ++c) {\n"
     "            narrow(dkp + (t0 + j0 + i) * a.dk_s + col + c, dk[i][c]);\n"
     "            narrow(dvp + (t0 + j0 + i) * a.dv_s + col + c, dv[i][c]);\n"
     "          }\n", 1),
)
NO_RING = (
    ("    for (int t = 0; t < kStages - 1; ++t) {\n",
     "    for (int t = 0; t < 0; ++t) {\n", 1),
    ("    cp_async_wait<kStages - 2>();\n"
     "    __syncthreads();   // ... and tile t - 1 consumed: its stage reused\n"
     "    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);\n"
     "    cp_async_commit();\n",
     "    issue(t);\n"
     "    cp_async_commit();\n"
     "    cp_async_wait<0>();\n"
     "    __syncthreads();\n", 1),
)
SIMT = (("  static constexpr bool kMma = sizeof(T) == 2;\n",
         "  static constexpr bool kMma = false;\n", 1),)
SKELETON = (
    ("        mma_dots<HD, false>(stage, fq + hg / kHeads * (HD / 16) * 32,\n"
     "                            nullptr, red);\n", "", 1),
    ("        mma_dots<HD, true>(stage, fq + f0, fd + f0, red);\n",
     "        (void)f0;\n", 1),
    ("        if (warp < hn && t0 + lane < end) {\n",
     "        if (false) {\n", 1),
    ("      if (active) {\n        // The thread's K values for dq",
     "      if (false) {\n        // The thread's K values for dq", 1),
)
# (name, edits, what); checked, and each one's share of the gain reported.
STEPS = (("narrow", NARROW, "16-byte stores"),
         ("no_ring", NO_RING, "tiles in flight (the ring)"),
         ("simt", SIMT, "S and dP on the tensor cores"))
# Timed, not checked (their gradients are wrong by design).
SKELETONS = (("skeleton", SKELETON, "the copies, barriers and stores alone"),)


def edited(source: Path, name: str, edits) -> Path:
    """``source`` with ``edits`` applied, written as ``OUT/name.cu``."""
    text = source.read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            sys.exit(f"decode_bwd_probe: {name}'s edit no longer applies to "
                     f"{source.name} ({text.count(old)} of {count}):\n{old}")
        text = text.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def build(name: str, source: Path):
    """The source and ``errors.cu`` as a library of their own, loaded with
    the port's signatures; returns it and ptxas's register lines."""
    from repro_torch.kernels import _build
    lib = OUT / f"lib{name}.so"
    done = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", str(source), str(_build.CSRC / "errors.cu"), "-o",
         str(lib)], capture_output=True, text=True)
    log = done.stdout + done.stderr
    if done.returncode:
        sys.exit(f"decode_bwd_probe: nvcc failed for {name}:\n{log}")
    dll = ctypes.CDLL(str(lib))
    for fn in ENTRIES:
        argtypes, restype = _build.SIGNATURES[fn]
        getattr(dll, fn).argtypes = list(argtypes)
        getattr(dll, fn).restype = restype
    regs = [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]
    return dll, regs


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
        sys.exit("decode_bwd_probe: torch sees no CUDA device")
    print(f"card: {cs.nvidia_smi()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    OUT.mkdir(parents=True, exist_ok=True)
    source = _build.CSRC / SOURCE
    builds = [("parent", parent)]
    builds += [(name, edited(source, name, edits))
               for name, edits, _ in STEPS + SKELETONS]
    builds += [(f"variant{i}", path) for i, path in enumerate(variants)]
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        port_lib = pool.submit(_build.load)
        done = {name: pool.submit(build, name, path)
                for name, path in builds}
        libs = {"port": port_lib.result()}
        for name, path in builds:
            libs[name], regs = done[name].result()
            print(f"build {name} ({path.name}): " + "; ".join(regs),
                  flush=True)
    port_log = _build.library_path().with_suffix(".log").read_text()
    print("build port: " + "; ".join(
        line.strip() for line in port_log.split(f"--- {SOURCE}")[1]
        .split("--- ")[0].splitlines()
        if "registers" in line or "spill" in line), flush=True)
    port_load = _build.load

    # chip_smoke.py's first decode_attention_bwd case (seed 0).
    b, h, kv, s, hd = (cs.DECODE_B, 16, 2, cs.DECODE_MAX, 128)
    dev = torch.device("cuda", 0)
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev, dtype=dt)[:, 0]
    ck, cv = (torch.randn(b, s, kv, hd, generator=gen, device=dev,
                          dtype=dt).transpose(1, 2) for _ in range(2))
    do = torch.randn(b, h, hd, generator=gen, device=dev, dtype=dt)
    pos = torch.randint(cs.DECODE_POS_LO, cs.DECODE_MAX, (b,), generator=gen,
                        device=dev, dtype=torch.int32)
    pos[3] = 0
    o = dec_ops.decode_attention(q, ck, cv, pos)

    def call(name):
        _build.load = lambda: libs[name]
        try:
            return dec_ops.decode_attention_bwd(q, ck, cv, pos, o, do)
        finally:
            _build.load = port_load

    checked = ["parent"] + [n for n, _, _ in STEPS] + ["port"] + \
        [f"variant{i}" for i in range(len(variants))]
    names = checked + [n for n, _, _ in SKELETONS]
    want = dec_ref.decode_attention_bwd_ref(
        *(t.double() for t in (q, ck, cv)), pos, o.double(), do.double())
    for name in checked:
        got, again = call(name), call(name)
        _, tol, _ = cs.grads_close(torch, got, want, name)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            sys.exit(f"decode_bwd_probe: {name}: two calls differ")
        if any(bool(t[3].any()) for t in got):
            sys.exit(f"decode_bwd_probe: {name}: the empty request has a "
                     f"gradient")
        print(f"{name}: within {tol}; two calls equal", flush=True)
    del want, got, again
    torch.cuda.empty_cache()

    ms = {n: [] for n in names}
    passes = {n: [] for n in names}
    for name in names + names[::-1]:
        def fn(name=name):
            return call(name)
        ms[name].append(cs.graph_ms(fn, torch, reps=20))
        kerns = cs.device_kernels(torch, fn, calls=5)
        passes[name].append({(re.findall(r"::(\w+)[<(]", k)
                              or [k[:40]])[0]: t for k, t, _ in kerns})
        print(f"{name}: device {ms[name][-1]:.5f} ms a call; "
              + ", ".join(f"{k} {t:.5f} ms" for k, t in
                          passes[name][-1].items()), flush=True)
    mean = {n: statistics.mean(ms[n]) for n in names}

    def mean_passes(name):   # over the turns whose profile has the pass
        keys = dict.fromkeys(k for p in passes[name] for k in p)
        return {k: statistics.mean(p[k] for p in passes[name] if k in p)
                for k in keys}
    by_pass = {n: mean_passes(n) for n in names}

    live = int(pos.clamp(max=s).sum())
    n_bytes = (4 * b * h * hd + 2 * kv * hd * live
               + 2 * b * kv * s * hd) * 2 + 4 * b
    bound_ms = n_bytes / cs.PEAK_BYTES_PER_S * 1e3
    mask = (torch.arange(s, device=dev)[None, :] < pos[:, None])[:, None,
                                                                  None]
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, ck, cv))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qr[:, :, None], kr, vr, attn_mask=mask, enable_gqa=True)
    sdpa_ms = cs.eager_ms(lambda: torch.autograd.grad(
        lib_out, (qr, kr, vr), do[:, :, None], retain_graph=True), torch,
        runs=20, warmup=3)
    gain = mean["parent"] - mean["port"]
    shares = {}
    print(f"bound {bound_ms:.6f} ms (bytes, {n_bytes / 1e6:.2f} MB); SDPA's "
          f"autograd backward {sdpa_ms:.5f} ms", flush=True)
    print(f"port {mean['port']:.5f} ms against the parent's "
          f"{mean['parent']:.5f} ({mean['port'] / mean['parent']:.4f}x; "
          f"{mean['port'] / bound_ms:.3f}x the bound, "
          f"{mean['port'] / sdpa_ms:.4f}x SDPA)", flush=True)
    for name, _, what in STEPS:
        shares[name] = (mean[name] - mean["port"]) / gain
        print(f"{what} (undone: {name} {mean[name]:.5f} ms): "
              f"{100 * shares[name]:.1f}% of the gain", flush=True)
    for name, _, what in SKELETONS:
        print(f"{what} ({name}): {mean[name]:.5f} ms, "
              f"{100 * mean[name] / mean['port']:.1f}% of the port's call; "
              + ", ".join(f"{k} {t:.5f} ms" for k, t in
                          by_pass[name].items()), flush=True)
    for name in ("parent", "port"):
        total = sum(by_pass[name].values())
        print(f"{name} by pass: " + ", ".join(
            f"{k} {t:.5f} ms ({100 * t / total:.1f}%)"
            for k, t in by_pass[name].items()), flush=True)
    for i, path in enumerate(variants):
        print(f"variant{i} ({path.name}): {mean[f'variant{i}']:.5f} ms "
              f"against the port's {mean['port']:.5f}", flush=True)
    print(json.dumps({"decode_bwd_probe": {
        "shape": [b, h, kv, s, hd, "bfloat16"], "card": cs.nvidia_smi(),
        "live_positions": live, "bytes": n_bytes, "bound_ms": bound_ms,
        "sdpa_ms": sdpa_ms, "ms": ms, "mean_ms": mean, "passes": by_pass,
        "share_of_gain": shares}}))


if __name__ == "__main__":
    main()
