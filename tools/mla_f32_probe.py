#!/usr/bin/env python3
"""Where the gains of deepseek-v2's f32 path come from: K5's ``tf32x3``
instance at (qk, value) head dims (192, 128) (``csrc/flash_attention.cu``)
and the MLA decode kernel's ``tf32x3`` instance at (R, P) = (512, 64)
(``csrc/mla_decode_attention.cu``), each beside the kernel it replaced.

    python3 tools/mla_f32_probe.py --parent-fwd FILE.cu --parent-dec FILE.cu \\
        [--fwd-variant FILE.cu ...] [--dec-variant FILE.cu ...]

Needs one CUDA card and ``nvcc``. The parents are the sources the redesign
replaced (``git show REV:src/repro_torch/csrc/flash_attention.cu >
build/parent_fa.cu``, the same for ``mla_decode_attention.cu``: the chip's
copy has no git history). The parent decode source is called through its
own interface: its SIMT instance's ``n_split`` equal splits a request
(``ops.n_splits``) and scratch (n_split, B*H, R).

The design steps are rebuilt from the port's sources by the text edits of
``FWD_STEPS`` and ``DEC_STEPS`` (written beside the libraries under
``build/mla_f32_probe/``; the probe stops if an edit no longer applies),
so the port keeps one path:

* K5 at (192, 128): ``fwd_step1`` 8 warps over 32-key tiles in a 2-stage
  ring, a block an item (the port's one-item kernel); ``fwd_step2``
  persistent blocks, a run of items a block with the ring and the Q
  copies running across items; the port: a warp skips the tiles past its
  last row. ``fwd_stages3`` (not a step): the port with a 3-stage ring.
  At LM B's hd-128 shape the parent and the port alone (that kernel's
  design is the parent's).
* MLA decode f32: ``dec_step1`` 3xTF32 mma.sync, 16 heads a CTA, one CTA
  an SM, runs balanced by live tiles, Q and each tile by cp.async, each
  tile waited for with its successor, the merge a thread's columns one
  after another; ``dec_step2`` the merge's columns of a thread in
  accumulators of their own (a slot's loads issue together); the port:
  the next tile in flight while one is consumed. Builds with a phase of the main pass left out
  (``dec_plan_only``, ``dec_no_mma``, ``dec_no_tile``, ``dec_no_q``;
  outputs not checked) show where its time goes; the merge's is the
  profile's.

Every build is first held to the plain version within chip_smoke.py's
f32 tolerance (2e-5). At MLA B's shapes (prefill B=2, H=KV=128, S=256,
causal; decode B=2, H=128, S=512, lengths 260) and at a larger one each
(prefill B=1, S=2048; decode chip_smoke's seeded B=4, S=2048, lengths
drawn in [1, 2049)) it times the builds in turns (each once, then in
reverse order): device ms a call from CUDA-graph replays
(``chip_smoke.graph_ms``) and each launch's device time from a profile
(``chip_smoke.device_kernels``); then each step's share of the gain over
the parent (the means of its two turns), SDPA on the same inputs and the
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
OUT = ROOT / "build" / "mla_f32_probe"

TILING = ("template <>\nstruct Tiling<192, 128, float> {\n"
          "  static constexpr int kBk = 32;\n"
          "  static constexpr int kStages = 2;\n"
          "  static constexpr bool kPersistent = true;\n};\n")


def tiling(bk: int, stages: int, persistent: bool):
    """An edit of the (192, 128) instance's tiling."""
    return ((TILING, TILING.replace("kBk = 32", f"kBk = {bk}")
             .replace("kStages = 2", f"kStages = {stages}")
             .replace("= true", "= true" if persistent else "= false"), 1),)


NO_SKIP = (("    if (!causal || k0 <= row0 + 15) {\n", "    if (true) {\n", 1),)
# (name, edits of the port's source, what the step adds): the design's
# steps, each held to the plain version and timed; the port is the last.
FWD_STEPS = (
    ("fwd_step1", tiling(32, 2, False),
     "8 warps over 32-key tiles (a block an item)"),
    ("fwd_step2", NO_SKIP, "persistent runs (the ring and the Q copies "
     "across a block's items)"))
WHAT_FWD_PORT = "a warp skips the tiles past its last row"
# Other versions, checked and timed, not steps.
FWD_EXTRA = (("fwd_stages3", tiling(32, 3, True), "a 3-stage ring"),)
# The decode's design steps undone, as edits of the port's source: each
# tile waited for with its successor (no copy in flight while one is
# consumed).
NO_RING = (("      cp_async_wait<1>();   // tile j (and the segment's Q) has "
            "landed\n", "      cp_async_wait<0>();\n", 1),)
# The merge's column loop as the tensor-core instance's first merge had
# it: a thread's columns one after another, each over the slots.
MERGE_BY_COLUMN = ((
    """  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.0f;
  for (int c = c_lo; c <= c_hi; ++c) {
    const float w = w_s[c - c_lo];
    if (w == 0.0f) continue;
    const float* src = part_acc +
                       (static_cast<long long>(c + b) * a.n_heads + h) * R +
                       threadIdx.x;
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      acc[i] = fmaf(src[i * kMergeThreads], w, acc[i]);
  }
  T* dst = out + static_cast<long long>(row) * R + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    narrow(dst + i * kMergeThreads, acc[i] / denom);
""",
    """  for (int d = threadIdx.x; d < R; d += kMergeThreads) {
    float acc = 0.0f;
    for (int c = c_lo; c <= c_hi; ++c)
      if (w_s[c - c_lo] != 0.0f)
        acc = fmaf(part_acc[(static_cast<long long>(c + b) * a.n_heads + h) *
                                R + d],
                   w_s[c - c_lo], acc);
    narrow(out + static_cast<long long>(row) * R + d, acc / denom);
  }
""", 1),)
DEC_STEPS = (
    ("dec_step1", NO_RING + MERGE_BY_COLUMN,
     "3xTF32 mma.sync, 16 heads a CTA, one CTA an SM, runs balanced by "
     "live tiles, Q and the tile by cp.async"),
    ("dec_step2", NO_RING, "the merge's columns of a thread in "
     "accumulators of their own"))
WHAT_DEC_PORT = "the next tile in flight while one is consumed"
# Phases of the decode's main pass left out (outputs wrong, not checked):
# where its time goes.
DEC_DIAG = (
    ("dec_plan_only", (("  // The softmax of rows (heads) 2 warp",
                        "  if (true) return;\n  // The softmax of rows (heads)"
                        " 2 warp", 1),), "the schedule alone"),
    ("dec_no_mma", (("            mma(sc[nn], al, bh);\n"
                     "            mma(sc[nn], ah, bl);\n"
                     "            mma(sc[nn], ah, bh);\n", "", 1),
                    ("            mma(acc[d], pl, bh);\n"
                     "            mma(acc[d], ph, bl);\n"
                     "            mma(acc[d], ph, bh);\n", "", 1)),
     "no products"),
    ("dec_no_tile", (("    copy_rows<kTile>(ring, cb",
                      "    if (false) copy_rows<kTile>(ring, cb", 1),
                     ("        copy_rows<kTile>(ring + (j + 1 - j0)",
                      "        if (false) copy_rows<kTile>(ring + (j + 1 - j0)",
                      1)), "no copy of the cache"),
    ("dec_no_q", (("    copy_rows<kHeads>(qs,",
                   "    if (false) copy_rows<kHeads>(qs,", 1),),
     "no copy of Q"))


def build(name: str, source: Path, entries):
    """The source and ``errors.cu`` as a library of their own, its C entry
    points loaded with the port's signatures (those it exports); returns
    it and ptxas's register lines."""
    from repro_torch.kernels import _build
    lib = OUT / f"lib{name}.so"
    done = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", str(source), str(_build.CSRC / "errors.cu"), "-o",
         str(lib)], capture_output=True, text=True)
    log = done.stdout + done.stderr
    if done.returncode:
        sys.exit(f"mla_f32_probe: nvcc failed for {name}:\n{log}")
    dll = ctypes.CDLL(str(lib))
    for fn in ("moby_error_string",) + entries:
        if hasattr(dll, fn):
            argtypes, restype = _build.SIGNATURES[fn]
            getattr(dll, fn).argtypes = list(argtypes)
            getattr(dll, fn).restype = restype
    lines = log.splitlines()
    regs = [line.strip() for i, line in enumerate(lines)
            if i and re.search(r"flash_tf32x3_(persistent_)?kernelILi192|"
                               r"mla_decode_(tf32x3|simt)_kernel",
                               lines[i - 1])
            and ("registers" in line or "spill" in line)]
    return dll, regs


def edited(source: Path, name: str, edits) -> Path:
    """``source`` with ``edits`` applied, written as ``OUT/name.cu``."""
    text = source.read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            sys.exit(f"mla_f32_probe: {name}'s edit no longer applies to "
                     f"{source.name} ({text.count(old)} of {count}):\n{old}")
        text = text.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def parse(args):
    """{option: [paths]} from the command line."""
    opts = {"--parent-fwd": [], "--parent-dec": [], "--fwd-variant": [],
            "--dec-variant": []}
    key = None
    for a in args:
        if a in opts:
            key = a
        elif key is None:
            sys.exit(f"usage: {Path(__file__).name} --parent-fwd FILE.cu "
                     f"--parent-dec FILE.cu [--fwd-variant FILE.cu ...] "
                     f"[--dec-variant FILE.cu ...]")
        else:
            opts[key].append(Path(a).resolve())
    if len(opts["--parent-fwd"]) != 1 or len(opts["--parent-dec"]) != 1:
        sys.exit("mla_f32_probe: one --parent-fwd and one --parent-dec")
    return opts


def simt_call(torch, dll, q_lat, q_rope, ckv, krope, lengths, scale):
    """A call of the parent's f32 (512, 64) instance (SIMT) through its
    own interface: n_split equal splits a request, scratch (n_split, B*H,
    R)."""
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels.mla_decode_attention import ops as mla_ops
    b, h, r = q_lat.shape
    s, p = ckv.shape[1], krope.shape[-1]
    dev = q_lat.device
    n_split = mla_ops.n_splits(b, h, s, mla_ops._sm_count(dev.index))
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
        b, h, s, r, p, n_split, 0, float(scale), _launch.stream_handle(dev))
    _build.check(code, "mla_decode_attention (parent)")
    return out


def main() -> None:
    opts = parse(sys.argv[1:])
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mla_decode_attention import ops as mla_ops
    from repro_torch.kernels.mla_decode_attention import ref as mla_ref
    if not torch.cuda.is_available():
        sys.exit("mla_f32_probe: torch sees no CUDA device")
    card = cs.nvidia_smi()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    OUT.mkdir(parents=True, exist_ok=True)
    fwd_src = _build.CSRC / "flash_attention.cu"
    dec_src = _build.CSRC / "mla_decode_attention.cu"
    fwd_entry = ("moby_flash_attention",)
    dec_entry = ("moby_mla_decode_attention", "moby_mla_decode_runs")
    # name -> (source, C entry points, kernel)
    builds = {"fwd_parent": (opts["--parent-fwd"][0], fwd_entry, "fwd"),
              "dec_parent": (opts["--parent-dec"][0], dec_entry, "dec")}
    for name, edits, _ in FWD_STEPS + FWD_EXTRA:
        builds[name] = (edited(fwd_src, name, edits), fwd_entry, "fwd")
    for name, edits, _ in DEC_STEPS + DEC_DIAG:
        builds[name] = (edited(dec_src, name, edits), dec_entry, "dec")
    for i, path in enumerate(opts["--fwd-variant"]):
        builds[f"fwd_variant{i}"] = (path, fwd_entry, "fwd")
    for i, path in enumerate(opts["--dec-variant"]):
        builds[f"dec_variant{i}"] = (path, dec_entry, "dec")
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        port_lib = pool.submit(_build.load)
        done = {n: pool.submit(build, n, src, entries)
                for n, (src, entries, _) in builds.items()}
        libs = {"port": port_lib.result()}
        for n, (src, _, _) in builds.items():
            libs[n], regs = done[n].result()
            print(f"build {n} ({src.name}): " + "; ".join(regs), flush=True)
    port_load, port_runs = _build.load, mla_ops._runs

    def with_lib(name, fn):
        """fn() with the wrapper's library (and, for the decode, its runs
        at 128 heads, asked of that library before any capture) swapped
        for build ``name``'s."""
        dll = libs[name]
        _build.load = lambda: dll
        if hasattr(dll, "moby_mla_decode_runs"):
            n = runs.setdefault(name, dll.moby_mla_decode_runs(128))
            mla_ops._runs = lambda index, h: n
        try:
            return fn()
        finally:
            _build.load, mla_ops._runs = port_load, port_runs
    runs = {}

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"card": card}

    def turns(names, call, reps=20):
        """Each build timed once, then in reverse order."""
        ms = {n: [] for n in names}
        passes = {n: [] for n in names}
        for name in names + names[::-1]:
            def fn(name=name):
                return call(name)
            ms[name].append(cs.graph_ms(fn, torch, reps=reps))
            kerns = cs.device_kernels(torch, fn, calls=5)
            passes[name].append({(re.findall(r"(\w+_kernel)", k)
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

    # ---- K5 at (192, 128) ----
    report["fwd"] = {}
    fwd_all = ["fwd_parent"] + [n for n, _, _ in FWD_STEPS] + ["port"] + \
        [n for n, _, _ in FWD_EXTRA] + \
        [n for n in builds if n.startswith("fwd_variant")]
    for key, (b, h, kv, s, hd, vd) in {
            "mla_b": (2, 128, 128, 256, 192, 128),
            "s2048": (1, 128, 128, 2048, 192, 128),
            "lm_b_hd128": (2, 16, 2, 256, 128, 128)}.items():
        # At hd 128 (LM B's shape) the port's kernel is the parent's
        # design: the two alone, as a check that it did not move.
        fwd = fwd_all if hd == 192 else ["fwd_parent", "port"]
        rec, kern, _ = cs.check_flash(torch, dev, fa_ops, fa_ref, b, h, kv,
                                      s, s, hd, torch.float32, True, 0, vd=vd)
        cells = dict(zip(kern.__code__.co_freevars,
                         (c.cell_contents for c in kern.__closure__)))
        q, k, v, causal = cells["q"], cells["k"], cells["v"], True
        plain = cs.heads_at_a_time(torch, fa_ref.flash_attention_ref, 8) \
            if kv == h else fa_ref.flash_attention_ref

        def fcall(name):
            return with_lib(name, lambda: fa_ops.flash_attention(q, k, v,
                                                                 causal))
        for name in fwd:
            _, tol, _, _ = cs.attention_close(
                torch, fcall(name), plain,
                (q.float(), k.float(), v.float(), True), (q, k, v, True),
                f"forward {name} {key}")
            print(f"forward {name} {key}: within {tol}", flush=True)
        bound_ms, bound_by = cs.bound(rec["bytes"], rec["ops"], rec["peak"])
        sdpa_ms = cs.graph_ms(rec["library"], torch, reps=10)
        print(f"forward {key} {rec['shape']}: bound {bound_ms:.6f} ms "
              f"({bound_by}), SDPA {sdpa_ms:.5f} ms", flush=True)
        ms, passes = turns(fwd, fcall)
        mean = {n: statistics.mean(ms[n]) for n in fwd}
        steps = ["fwd_parent"] + [n for n, _, _ in FWD_STEPS] + ["port"] \
            if hd == 192 else ["fwd_parent", "port"]
        whats = [w for _, _, w in FWD_STEPS] + [WHAT_FWD_PORT] \
            if hd == 192 else ["the port's restructured source"]
        report["fwd"][key] = {
            "shape": rec["shape"], "ms": ms, "mean_ms": mean,
            "passes": passes, "bound_ms": bound_ms, "bound_by": bound_by,
            "sdpa_ms": sdpa_ms, "share_of_gain": shares(steps, mean, whats)}
        print(f"  port / parent {mean['port'] / mean['fwd_parent']:.4f}, "
              f"port / SDPA {mean['port'] / sdpa_ms:.4f}", flush=True)
        del q, k, v, rec, kern, cells
        torch.cuda.empty_cache()

    # ---- MLA decode f32 at (512, 64) ----
    report["dec"] = {}
    dec = ["dec_parent"] + [n for n, _, _ in DEC_STEPS] + ["port"] + \
        [n for n in builds if n.startswith("dec_variant")]
    diag = [n for n, _, _ in DEC_DIAG]
    for key, shape in {
            "mla_b": (2, 128, 512, 512, 64, torch.float32, [260, 260]),
            "seeded": (4, 128, 2048, 512, 64, torch.float32,
                       (1, 2049))}.items():
        rec, kern, _ = cs.check_mla_decode(torch, dev, mla_ops, mla_ref,
                                           *shape, 6 if key == "seeded"
                                           else 3)
        args = dict(zip(kern.__code__.co_freevars,
                        (c.cell_contents for c in kern.__closure__)))["args"]

        def dcall(name):
            if name == "dec_parent":
                return simt_call(torch, libs[name], *args)
            return with_lib(name, kern)
        for name in dec:
            _, tol, _, _ = cs.attention_close(
                torch, dcall(name), mla_ref.mla_decode_attention_ref,
                tuple(t.float() for t in args[:4]) + args[4:], args,
                f"decode {name} {key}")
            print(f"decode {name} {key}: within {tol}", flush=True)
        bound_ms, bound_by = cs.bound(rec["bytes"], rec["ops"], rec["peak"])
        sdpa_ms = cs.graph_ms(rec["library"], torch, reps=10)
        print(f"decode {key} {rec['shape']}: bound {bound_ms:.6f} ms "
              f"({bound_by}), f32 SIMT bound {rec['f32_simt_ms']:.6f} ms, "
              f"SDPA {sdpa_ms:.5f} ms; runs {runs}", flush=True)
        ms, passes = turns(dec + diag, dcall)
        mean = {n: statistics.mean(ms[n]) for n in dec + diag}
        steps = ["dec_parent"] + [n for n, _, _ in DEC_STEPS] + ["port"]
        whats = [w for _, _, w in DEC_STEPS] + [WHAT_DEC_PORT]
        report["dec"][key] = {
            "shape": rec["shape"], "ms": ms, "mean_ms": mean,
            "passes": passes, "bound_ms": bound_ms, "bound_by": bound_by,
            "f32_simt_bound_ms": rec["f32_simt_ms"], "sdpa_ms": sdpa_ms,
            "share_of_gain": shares(steps, mean, whats)}
        print(f"  port / parent {mean['port'] / mean['dec_parent']:.4f}",
              flush=True)
        del rec, kern, args
        torch.cuda.empty_cache()
    print(json.dumps({"mla_f32_probe": report}))


if __name__ == "__main__":
    main()
