#!/usr/bin/env python3
"""How K5's tensor-core instances at head dim 64 (bf16) spend their time,
design step by design step, beside the 3xTF32 instances they replaced and
beside SDPA.

    python3 tools/tc_hd64_probe.py [--parent-fwd FILE.cu]
        [--parent-bwd FILE.cu] [--fwd-variant FILE.cu ...]
        [--bwd-variant FILE.cu ...]

Needs one CUDA card and ``nvcc``. Builds into ``build/tc_hd64_probe/``,
all at once (none of it is part of the port).

* Forward, at zamba2-1.2b's prefill (B=1, H=KV=32, S=8192, hd 64, causal):
  ``parent_fwd`` (``--parent-fwd``: a ``csrc/flash_attention.cu`` that
  still has the bf16 hd-64 instance, e.g. ``git show
  HEAD~:src/repro_torch/csrc/flash_attention.cu``, called through the
  ``tf32x3`` route), ``fwd_step1`` (the port's
  ``csrc/flash_attention_tc.cu`` with the hd-64 instance cut back to two
  consumer warpgroups, 128-row query tiles, and ``exp2f``: the hd-128
  design templated at 64), ``fwd_step2`` (three consumer warpgroups,
  192-row query tiles), ``port`` (``ex2.approx.ftz`` for ``exp2f``).
* Gradient, at zamba2's shape (B=1, H=KV=32, S=4096, hd 64, causal) and
  at LM T's shape at hd 64 (B=1, H=16, KV=2, S=4096, causal):
  ``parent_bwd`` (``--parent-bwd``: a ``csrc/flash_attention_bwd.cu``
  with the bf16 hd-64 instance), ``bwd_step1`` (the port's
  ``csrc/flash_attention_bwd_tc.cu`` writing f32 partials and summing
  them at G = 1 too, with ``exp2f`` and a 2-stage ring: the hd-128 design
  templated at 64), ``bwd_step2`` (the direct write of dK and dV at
  G = 1), ``bwd_step3`` (``ex2.approx.ftz`` for ``exp2f``), ``port`` (a
  3-stage ring at hd 64).
* The hd-128 instances share these templates: the same builds also run
  LM C's prefill (B=1, H=16, KV=2, S=8192, hd 128) and LM T's gradient
  (the same at S=4096), where the first design step is the parent's
  design and the 3xTF32 parents (no bf16 hd 128) are left out.
* ``--fwd-variant`` / ``--bwd-variant``: other versions of those sources
  (the same C entry points), timed beside the port.

The design steps are rebuilt from the port's sources by the edits in
``FWD_STEPS`` and ``BWD_STEPS`` (the probe stops if an edit no longer
applies). Every build is first held to the plain version on the same
inputs with ``chip_smoke.py``'s bf16 tolerance and the tensor-core
route's allowance for P (and dS) rounded to bf16, the 3xTF32 parents too
(at zamba2's prefill the parent forward misses its own f32-accurate
check); every gradient build is also called twice, equal bit for bit. Then the builds are timed
in turns (each once, then in reverse order): device ms a call from
CUDA-graph replays (``chip_smoke.graph_ms``) and each launch's device time
from a profile (``chip_smoke.device_kernels``). It prints each step's share
of the gain over the parent (the means of the two turns), SDPA's forward
and autograd backward on the same inputs, the bound and the exp2 floor,
and one JSON line.
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
OUT = ROOT / "build" / "tc_hd64_probe"
# (B, H, KV, SQ, SK, hd), causal: zamba2's prefill and gradient, LM T's
# gradient at hd 64; and the hd-128 instances that share the templates (LM
# C's prefill, LM T's gradient), where the first design step stands for the
# parent.
FWD_SHAPES = {"zamba2": (1, 32, 32, 8192, 8192, 64),
              "prefill_hd128": (1, 16, 2, 8192, 8192, 128)}
BWD_SHAPES = {"zamba2": (1, 32, 32, 4096, 4096, 64),
              "lm_t_hd64": (1, 16, 2, 4096, 4096, 64),
              "lm_t_hd128": (1, 16, 2, 4096, 4096, 128)}

# The design steps undone, as (text, replacement, count) edits of the
# port's sources.
EXP2F = (("ex2_ftz(", "exp2f(", 3),)    # exp2f's denormal results kept
FWD_STEPS = (
    ("fwd_step1", EXP2F + (("    case 64: return launch<64, 64, 3>(",
                            "    case 64: return launch<64, 64, 2>(", 1),),
     "the hd-128 design at hd 64 (2 consumer warpgroups, 128-row tiles)"),
    ("fwd_step2", EXP2F, "3 consumer warpgroups, 192-row tiles"))
WHAT_FWD_PORT = "ex2.approx.ftz for exp2f"
PARTIALS = (("    if (a.group == 1) {\n", "    if (false) {\n", 1),
            ("  if (e != cudaSuccess || n_heads == n_kv_heads) return "
             "static_cast<int>(e);\n",
             "  if (e != cudaSuccess) return static_cast<int>(e);\n", 1))
BWD_EXP2F = (("ex2_ftz(", "exp2f(", 4),)
TWO_STAGES = (("  static constexpr int kStages = HD == 64 ? 3 : 2;\n",
               "  static constexpr int kStages = 2;\n", 1),)
BWD_STEPS = (
    ("bwd_step1", BWD_EXP2F + PARTIALS + TWO_STAGES,
     "the hd-128 design at hd 64 (partials and the group sum at G = 1)"),
    ("bwd_step2", BWD_EXP2F + TWO_STAGES, "the direct write at G = 1"),
    ("bwd_step3", TWO_STAGES, "ex2.approx.ftz for exp2f"))
WHAT_BWD_PORT = "a 3-stage ring at hd 64"


def build(name: str, source: Path, entry: str):
    """The source and ``errors.cu`` as a library of their own, its C entry
    point ``entry`` loaded with the port's signature; returns it and
    ptxas's register lines."""
    from repro_torch.kernels import _build
    lib = OUT / f"lib{name}.so"
    done = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", str(source), str(_build.CSRC / "errors.cu"), "-o",
         str(lib)], capture_output=True, text=True)
    log = done.stdout + done.stderr
    if done.returncode:
        sys.exit(f"tc_hd64_probe: nvcc failed for {name}:\n{log}")
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
            sys.exit(f"tc_hd64_probe: {name}'s edit no longer applies to "
                     f"{source.name} ({text.count(old)} of {count}):\n{old}")
        text = text.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def parse(args):
    """{option: [paths]} from the command line."""
    opts = {"--parent-fwd": [], "--parent-bwd": [], "--fwd-variant": [],
            "--bwd-variant": []}
    key = None
    for a in args:
        if a in opts:
            key = a
        elif key is None:
            sys.exit(f"usage: {Path(__file__).name} [--parent-fwd FILE.cu] "
                     f"[--parent-bwd FILE.cu] [--fwd-variant FILE.cu ...] "
                     f"[--bwd-variant FILE.cu ...]")
        else:
            opts[key].append(Path(a).resolve())
    if len(opts["--parent-fwd"]) > 1 or len(opts["--parent-bwd"]) > 1:
        sys.exit("tc_hd64_probe: one --parent-fwd and one --parent-bwd")
    return opts


def tc_bwd(torch, lib, q, k, v, o, do):
    """The tensor-core gradient through ``lib``'s C entry point, with the
    port's wrapper's outputs and scratch (f32 partials always allocated,
    so a build that writes them at G = 1 can run)."""
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    dev, dt = q.device, q.dtype
    dq = torch.empty((b, sq, h, hd), dtype=dt, device=dev).transpose(1, 2)
    dk = torch.empty((b, sk, kv, hd), dtype=dt, device=dev).transpose(1, 2)
    dv = torch.empty((b, sk, kv, hd), dtype=dt, device=dev).transpose(1, 2)
    part = torch.empty((2, b * h, sk, hd), dtype=torch.float32, device=dev)
    rows = -(-sq // fa_ops.TC_BWD_ROWS) * fa_ops.TC_BWD_ROWS
    stats = torch.empty((2, b * h, rows), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    code = lib.moby_flash_attention_bwd_tc(
        *(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv)),
        stats.data_ptr(), part.data_ptr(), strides, b, h, kv, sq, sk, hd,
        rows, 1, hd ** -0.5, _launch.stream_handle(dev))
    _build.check(code, "flash_attention_bwd (probe)")
    return dq, dk, dv


def main() -> None:
    opts = parse(sys.argv[1:])
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    if not torch.cuda.is_available():
        sys.exit("tc_hd64_probe: torch sees no CUDA device")
    card = cs.nvidia_smi()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    OUT.mkdir(parents=True, exist_ok=True)
    fwd_src = _build.CSRC / "flash_attention_tc.cu"
    bwd_src = _build.CSRC / "flash_attention_bwd_tc.cu"
    # name -> (source, C entry point, route, direction)
    builds = {}
    for p in opts["--parent-fwd"]:
        builds["parent_fwd"] = (p, "moby_flash_attention", "tf32x3", "fwd")
    for p in opts["--parent-bwd"]:
        builds["parent_bwd"] = (p, "moby_flash_attention_bwd", "tf32x3",
                                "bwd")
    for name, edits, _ in FWD_STEPS:
        builds[name] = (edited(fwd_src, name, edits),
                        "moby_flash_attention_tc", "tc", "fwd")
    for name, edits, _ in BWD_STEPS:
        builds[name] = (edited(bwd_src, name, edits),
                        "moby_flash_attention_bwd_tc", "tc", "bwd")
    for i, p in enumerate(opts["--fwd-variant"]):
        builds[f"fwd_variant{i}"] = (p, "moby_flash_attention_tc", "tc",
                                     "fwd")
    for i, p in enumerate(opts["--bwd-variant"]):
        builds[f"bwd_variant{i}"] = (p, "moby_flash_attention_bwd_tc", "tc",
                                     "bwd")
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        port_lib = pool.submit(_build.load)
        done = {n: pool.submit(build, n, src, entry)
                for n, (src, entry, _, _) in builds.items()}
        libs = {"port": port_lib.result()}
        for n, (src, _, _, _) in builds.items():
            libs[n], regs = done[n].result()
            print(f"build {n} ({src.name}): " + "; ".join(regs), flush=True)
    port_load, port_route = _build.load, fa_ops.route

    def with_lib(name, route, fn):
        _build.load = lambda: libs[name]
        if route == "tf32x3":
            fa_ops.route = lambda *a, **kw: "tf32x3"
        try:
            return fn()
        finally:
            _build.load, fa_ops.route = port_load, port_route

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = torch.bfloat16
    report = {"card": card}

    def turns(names, call, reps):
        """Each build timed once, then in reverse order."""
        ms = {n: [] for n in names}
        passes = {n: [] for n in names}
        for name in names + names[::-1]:
            def fn(name=name):
                return call(name)
            ms[name].append(cs.graph_ms(fn, torch, reps=reps))
            kerns = cs.device_kernels(torch, fn, calls=5)
            passes[name].append({(re.findall(r"::(\w+)[<(]", k)
                                  or [k[:40]])[0]: t for k, t, _ in kerns})
            print(f"  {name}: device {ms[name][-1]:.5f} ms a call; "
                  + ", ".join(f"{k} {t:.5f} ms" for k, t in
                              passes[name][-1].items()), flush=True)
        return ms, passes

    def shares(steps, mean, whats):
        gain = mean[steps[0]] - mean[steps[-1]]
        out = {}
        for before, after, what in zip(steps, steps[1:], whats):
            out[after] = (mean[before] - mean[after]) / gain if gain else 0.0
            print(f"  {after} ({what}): {mean[before]:.5f} -> "
                  f"{mean[after]:.5f} ms, {100 * out[after]:.1f}% of the "
                  f"gain", flush=True)
        return out

    def names(direction, parent, steps, hd):
        """The builds timed at head dim ``hd``: the 3xTF32 parent (bf16 hd
        64 only), the design steps, the port, the variants."""
        out = [parent] if parent in builds and hd == 64 else []
        return out + [n for n, _, _ in steps] + ["port"] + \
            [n for n in builds if n.startswith(f"{direction}_variant")]

    def step_shares(order, steps, what_port, parent):
        """Each kept step's share of the gain over the first build."""
        whats = [w for _, _, w in steps] + [what_port]
        if order[0] != parent:
            whats = whats[1:]
        return [n for n in order if "_variant" not in n], whats

    # ---- forward ----
    report["fwd"] = {}
    for key, shape in FWD_SHAPES.items():
        b, h, kv, sq, sk, hd = shape
        g = torch.Generator(device=dev).manual_seed(0)

        def act(heads, s):
            return torch.randn(b, s, heads, hd, generator=g, device=dev,
                               dtype=bf16).transpose(1, 2)
        q, k, v = act(h, sq), act(kv, sk), act(kv, sk)
        fwd = names("fwd", "parent_fwd", FWD_STEPS, hd)

        def fcall(name):
            route = builds[name][2] if name in builds else "tc"
            return with_lib(name, route,
                            lambda: fa_ops.flash_attention(q, k, v, True))
        plain = fa_ref.flash_attention_ref
        if kv == h:   # one (SQ, SK) score matrix per 8 heads at a time
            plain = cs.heads_at_a_time(torch, plain, 8)
        term = cs.p_rounding_term(torch, q, k, v, True)
        for name in fwd:
            _, tol, _, _ = cs.attention_close(
                torch, fcall(name), plain,
                (q.float(), k.float(), v.float(), True), (q, k, v, True),
                f"forward {name} {key}", term)
            print(f"forward {name} {key}: within {tol}", flush=True)
        del term
        torch.cuda.empty_cache()
        pairs = sum(min(i + 1, sk) for i in range(sq))
        bound_ms = max(2 * (2 * hd) * b * h * pairs / cs.PEAK_BF16_PER_S,
                       2 * (b * h * sq + b * kv * sk) * hd * 2
                       / cs.PEAK_BYTES_PER_S) * 1e3
        exp2_ms = b * h * pairs / cs.EXP2_PER_S * 1e3
        sdpa_ms = cs.graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), torch, reps=20)
        print(f"forward {key} {shape}: bound {bound_ms:.6f} ms, exp2 floor "
              f"{exp2_ms:.6f} ms, SDPA {sdpa_ms:.5f} ms", flush=True)
        ms, passes = turns(fwd, fcall, 20)
        mean = {n: statistics.mean(ms[n]) for n in fwd}
        steps, whats = step_shares(fwd, FWD_STEPS, WHAT_FWD_PORT,
                                   "parent_fwd")
        report["fwd"][key] = {
            "shape": list(shape), "ms": ms, "mean_ms": mean,
            "passes": passes, "bound_ms": bound_ms, "exp2_floor_ms": exp2_ms,
            "sdpa_ms": sdpa_ms, "share_of_gain": shares(steps, mean, whats)}
        print(f"  port / SDPA: {mean['port'] / sdpa_ms:.4f}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()

    # ---- gradient ----
    report["bwd"] = {}
    for key, shape in BWD_SHAPES.items():
        b, h, kv, sq, sk, hd = shape
        g = torch.Generator(device=dev).manual_seed(1)
        q, k, v = act(h, sq), act(kv, sk), act(kv, sk)
        o = fa_ops.flash_attention(q, k, v, True)
        do = act(h, sq)
        bwd = names("bwd", "parent_bwd", BWD_STEPS, hd)

        def bcall(name):
            if name in builds and builds[name][2] == "tf32x3":
                return with_lib(name, "tf32x3", lambda: fa_ops.
                                flash_attention_bwd(q, k, v, o, do, True))
            return tc_bwd(torch, libs[name], q, k, v, o, do)
        wide = [x.double() for x in (q, k, v, o, do)]
        want = fa_ref.flash_attention_bwd_ref(*wide, True)
        terms = cs.bwd_rounding_terms(torch, *wide, True)
        for name in bwd:
            got = bcall(name)
            again = bcall(name)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                sys.exit(f"tc_hd64_probe: {name} at {key}: two calls differ")
            _, tol, _ = cs.grads_close(torch, got, want, f"{name} {key}",
                                       terms)
            print(f"gradient {name} {key}: within {tol}, two calls equal",
                  flush=True)
        del want, terms, wide, got, again
        torch.cuda.empty_cache()
        pairs = sum(min(i + 1, sk) for i in range(sq))
        bound_ms = max(10 * hd * b * h * pairs / cs.PEAK_BF16_PER_S,
                       (4 * b * h * sq + 4 * b * kv * sk) * hd * 2
                       / cs.PEAK_BYTES_PER_S) * 1e3
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qr, kr, vr, is_causal=True, enable_gqa=True)
        sdpa_ms = cs.eager_ms(lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), do, retain_graph=True), torch, runs=20,
            warmup=3)
        print(f"gradient {key} {shape}: bound {bound_ms:.6f} ms, SDPA's "
              f"autograd backward {sdpa_ms:.5f} ms (eager)", flush=True)
        ms, passes = turns(bwd, bcall, 20)
        mean = {n: statistics.mean(ms[n]) for n in bwd}
        steps, whats = step_shares(bwd, BWD_STEPS, WHAT_BWD_PORT,
                                   "parent_bwd")
        report["bwd"][key] = {
            "shape": list(shape), "ms": ms, "mean_ms": mean,
            "passes": passes, "bound_ms": bound_ms, "sdpa_ms": sdpa_ms,
            "share_of_gain": shares(steps, mean, whats)}
        print(f"  port / SDPA: {mean['port'] / sdpa_ms:.4f}", flush=True)
        del q, k, v, o, do, qr, kr, vr, lib_out
        torch.cuda.empty_cache()
    print(json.dumps({"tc_hd64_probe": report}))


if __name__ == "__main__":
    main()
