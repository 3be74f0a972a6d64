"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

The sources have a plain C interface, so they build with ``nvcc`` alone
(no PyTorch headers: seconds, not minutes) into one shared library that
``ctypes`` loads. Each ``.cu`` compiles in its own ``nvcc`` process, all
started together, then one link step makes the library.

* Target: ``sm_90a`` (Hopper), ``-O3``; no ``--use_fast_math`` and
  ``-fmad=false``, so division stays IEEE and no multiply-add is fused —
  the kernels' comparisons and counts come out as in the plain versions.
* Where: ``build/repro_torch_kernels/`` at the repository root, built on
  first use. The library's name carries a hash of the sources and flags,
  so an edited ``.cu`` rebuilds; the compiler's output (``-Xptxas -v``
  register and shared-memory report) is kept beside it.
* Nothing here runs at import: the CPU tests import every module on hosts
  without ``nvcc``.
* ``builds`` counts the real builds of this process (not the loads of a
  library already on disk): the observability hooks mark a span in which
  it grew as a compile (``repro_torch.obs``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("errors.cu", "point_proj.cu", "iou2d.cu", "ransac_score.cu",
           "flash_attention.cu", "flash_attention_tc.cu",
           "decode_attention.cu",
           "pillar_scatter.cu", "auction.cu")
HEADERS = ("moby_kernels.cuh",)
# Where the CUDA toolkit installs nvcc when it is not on PATH.
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                     "-fPIC", "-Xptxas", "-v")

# Libraries compiled by this process (a library found on disk is none).
builds = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry point -> (argtypes, restype); see the .cu sources.
SIGNATURES = {
    "moby_error_string": ((_I,), ctypes.c_char_p),
    "moby_point_proj": ((_P, _LL, _P, _P, _I, _I, _P, _P, _P, _P, _P), _I),
    "moby_point_proj_labels": ((_P, _LL, _I, _P, _P, _I, _I, _P, _P, _P),
                               _I),
    "moby_iou2d": ((_P, _I, _P, _I, _I, _P, _P), _I),
    "moby_ransac_score": ((_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P, _P),
                          _I),
    "moby_flash_attention": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, ctypes.c_float, _P), _I),
    "moby_flash_attention_tc": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 ctypes.c_float, _P), _I),
    "moby_decode_attention_chunk": ((), _I),
    "moby_decode_attention": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, ctypes.c_float, _P), _I),
    "moby_pillar_scatter": ((_P, _P, _P, _LL, _I, _I, _P, _P), _I),
    "moby_pillar_scatter_bwd": ((_P, _P, _P, _P, _P, _LL, _I, _I, _P, _P, _P,
                                 _P), _I),
    "moby_auction": ((_P, _I, _I, _I, ctypes.POINTER(ctypes.c_float), _I, _I,
                      _P, _P, _P, _P), _I),
    "moby_auction_wide": ((_P, _I, _I, ctypes.POINTER(ctypes.c_float), _I,
                           _I, _P, _P, _P, _P, _P), _I),
    "moby_smem_optin": ((_I,), _I),
    "moby_auction_skeleton": ((_P, _I, _P, _P), _I),
}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError(f"nvcc not found (neither on PATH nor at "
                       f"{DEFAULT_NVCC}): the CUDA kernels of repro_torch "
                       f"need the CUDA toolkit to build")


def library_path() -> Path:
    """Where the library for the current sources and flags lands."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmoby_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the current one exists; return its path.

    The objects and the library are written under a temporary directory
    and moved into place in one rename, so a concurrent or interrupted
    build never leaves a partial library behind.
    """
    global builds
    lib = library_path()
    if lib.exists():
        return lib
    cc = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [cc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [(n, p.returncode, log) for n, p, log
                  in zip(SOURCES, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {n} (exit {rc})\n{log}" for n, rc, log in failed))
        out = Path(tmp) / lib.name
        link = subprocess.run([cc, *ARCH, "-shared", *map(str, objs), "-o",
                               str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):"
                               f"\n{link.stdout}")
        lib.with_suffix(".log").write_text(
            "".join(f"--- {n}\n{log}" for n, log in zip(SOURCES, logs)))
        os.replace(out, lib)
    builds += 1
    return lib


def build_count() -> int:
    """Libraries compiled by this process so far (``builds``)."""
    return builds


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library with every signature set."""
    dll = ctypes.CDLL(str(build()))
    for fn, (argtypes, restype) in SIGNATURES.items():
        f = getattr(dll, fn)
        f.argtypes = list(argtypes)
        f.restype = restype
    return dll


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code:
        msg = load().moby_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
