"""Builds the CUDA sources under ``repro_torch/csrc/`` into one shared
library with a plain C interface and loads it with ``ctypes``.

The build runs at first use, from the sources in the checkout only, into
``build/repro_torch/`` at the checkout's root (listed in ``.gitignore``).
Each source compiles in its own ``nvcc`` process, all started together;
the objects are then linked. The library's name carries a hash of the
sources and flags, so an edited source rebuilds. A failed build raises with
nvcc's output: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build only where the CUDA toolkit is installed")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd, what):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n"
                           f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build(verbose: bool = False) -> Path:
    """Compile (if the hashed library is missing) and return its path;
    ``verbose`` adds ptxas's register/shared-memory report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libreprotorch_{source_hash()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    tag = f"{os.getpid()}"
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *ARCH, *FLAGS, *ptxas, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / f"{lib.name}.{tag}.tmp"
    _run([nvcc, *ARCH, "-shared", "-o", str(tmp),
          *[str(o) for _, o, _ in procs]], "link")
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    os.replace(tmp, lib)                  # atomic: a reader never sees half
    if verbose:                           # nvcc/ptxas report, to stderr
        print("".join(logs), file=sys.stderr)
    return lib


def _declare(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.edc_cosine_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.edc_cosine_launch.restype = i
    lib.edc_cosine_scratch.argtypes = [i, i, i]
    lib.edc_cosine_scratch.restype = ctypes.c_longlong
    lib.madc_launch.argtypes = [vp, vp, i, vp]
    lib.madc_launch.restype = i
    ll = ctypes.POINTER(ctypes.c_longlong)
    lib.swa_attention_launch.argtypes = [vp, vp, vp, vp, ll, i, i, i, i, i,
                                         i, i, i, ctypes.c_float, i, i, vp]
    lib.swa_attention_launch.restype = i
    lib.ssd_intra_chunk_launch.argtypes = [vp, vp, vp, vp, vp, vp, ll, i, i,
                                           i, i, i, i, i, vp]
    lib.ssd_intra_chunk_launch.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib


def strides(*groups) -> ctypes.Array:
    """Groups of element strides, concatenated into a C long long array
    (the launch functions' ``st`` argument)."""
    flat = [int(x) for g in groups for x in g]
    return (ctypes.c_longlong * len(flat))(*flat)


def check(err: int, what: str):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
