"""Builds the CUDA sources under ``repro_torch/csrc/`` into one shared
library with a plain C interface and loads it with ``ctypes``.

The build runs at first use, from the sources in the checkout only, into
``build/repro_torch/`` at the checkout's root (listed in ``.gitignore``).
Each source compiles in its own ``nvcc`` process, all started together;
the objects are then linked. The library's name carries a hash of the
sources and flags, so an edited source rebuilds. ptxas's report of each
kernel's registers, shared memory and spills is kept beside the library
(``build_log()``). A failed build raises with nvcc's output: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
         "-Xptxas", "-v"]

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
    """A hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd, what):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n"
                           f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _lib_path() -> Path:
    return BUILD_DIR / f"libreprotorch_{source_hash()}.so"


def build_log() -> str:
    """nvcc's and ptxas's output from the build of the current sources
    (empty if the library was not built from this checkout's sources)."""
    log = _lib_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(verbose: bool = False) -> Path:
    """Compile (if the hashed library is missing) and return its path;
    ``verbose`` also prints nvcc's and ptxas's report to stderr."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _lib_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {obj.name.split('.')[0]}.cu\n{out}")
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / f"{lib.name}.{tag}.tmp"
    _run([nvcc, *ARCH, "-shared", "-o", str(tmp),
          *[str(o) for _, o, _ in procs]], "link")
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    log = BUILD_DIR / f"{lib.stem}.log.{tag}.tmp"
    log.write_text("".join(logs))
    os.replace(log, lib.with_suffix(".log"))
    os.replace(tmp, lib)                  # atomic: a reader never sees half
    if verbose:
        print("".join(logs), file=sys.stderr)
    return lib


def _declare(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.POINTER(ctypes.c_longlong)
    lib.edc_cosine_launch.argtypes = [vp, vp, vp, vp, ll, vp]
    lib.edc_cosine_launch.restype = i
    lib.edc_cosine_sums_launch.argtypes = [vp, vp, vp, vp, ll, vp]
    lib.edc_cosine_sums_launch.restype = i
    lib.edc_cosine_scratch.argtypes = [i, i, i]
    lib.edc_cosine_scratch.restype = ctypes.c_longlong
    lib.madc_launch.argtypes = [vp, vp, i, i, vp]
    lib.madc_launch.restype = i
    lib.swa_attention_launch.argtypes = [vp, vp, vp, vp, vp, ll, vp]
    lib.swa_attention_launch.restype = i
    lib.swa_attention_part_floats.argtypes = [i, i, i, i, i]
    lib.swa_attention_part_floats.restype = ctypes.c_longlong
    lib.swa_attention_tc_launch.argtypes = [vp, vp, vp, vp, ll, i, i, i, i,
                                            i, i, i, i, ctypes.c_float, vp]
    lib.swa_attention_tc_launch.restype = i
    lib.swa_attention_tc_smem.argtypes = [i]
    lib.swa_attention_tc_smem.restype = i
    lib.ssd_intra_chunk_launch.argtypes = [vp, vp, vp, vp, vp, vp, ll, vp]
    lib.ssd_intra_chunk_launch.restype = i
    lib.ssd_intra_chunk_tc_launch.argtypes = [vp, vp, vp, vp, vp, vp, ll, i,
                                              i, i, i, i, i, vp]
    lib.ssd_intra_chunk_tc_launch.restype = i
    lib.ssd_intra_chunk_tc_smem.argtypes = [i, i]
    lib.ssd_intra_chunk_tc_smem.restype = i
    lib.ssd_intra_chunk_tc_heads_per_cta.argtypes = [i, i, i, i]
    lib.ssd_intra_chunk_tc_heads_per_cta.restype = i
    lib.swa_attention_bwd_launch.argtypes = [vp] * 10 + [ll, vp]
    lib.swa_attention_bwd_launch.restype = i
    lib.swa_attention_bwd_tc_launch.argtypes = [vp] * 12 + [ll, vp]
    lib.swa_attention_bwd_tc_launch.restype = i
    lib.swa_attention_bwd_tc_smem.argtypes = [i, i]
    lib.swa_attention_bwd_tc_smem.restype = i
    lib.ssd_intra_chunk_bwd_launch.argtypes = ([vp] * 11 + [ll] + [i] * 9
                                               + [vp])
    lib.ssd_intra_chunk_bwd_launch.restype = i
    lib.ssd_intra_chunk_bwd_part_floats.argtypes = []
    lib.ssd_intra_chunk_bwd_part_floats.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library (built on first call; the lock is taken
    only until it is loaded)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib


@functools.lru_cache(maxsize=8)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index`` (the fp32 routes size grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(t: torch.Tensor, fn, *args) -> int:
    """``fn(*args, stream)`` on t's device and its current stream: a
    launch function of the library, whose CUDA error code it returns. The
    stream's raw handle comes without building a Stream object (PyTorch's
    own fast path, as Triton's launcher takes it); the current device is
    switched only when t lies on another one."""
    index = t.device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def strides(*groups) -> ctypes.Array:
    """Groups of element strides, concatenated into a C long long array
    (the launch functions' ``st`` argument)."""
    flat = [int(x) for g in groups for x in g]
    return (ctypes.c_longlong * len(flat))(*flat)


def tma_strides(kernel: str, name: str, t: torch.Tensor, ndims: int,
                broadcast: int | None = None) -> tuple:
    """t's element strides of its first ``ndims`` dims for a tensor map of
    a tensor-core route; dim ``ndims`` must be contiguous. TMA wants a
    16-byte aligned base and strides that are multiples of 16 bytes. A dim
    of size 1, or dim ``broadcast`` with stride 0 (an expansion the map
    reads as one slice), is never stepped, so it gets its contiguous
    stride. Raises ValueError naming ``kernel`` and ``name`` otherwise: the
    routes never switch."""
    if t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name}'s data pointer is not 16-byte "
                         "aligned, which the bf16 route's TMA loads need")
    if t.stride(ndims) != 1:
        raise ValueError(f"{kernel}: {name}'s dim {ndims} must be contiguous "
                         "for the bf16 route's TMA loads")
    out = []
    for dim in range(ndims):
        st = t.stride(dim)
        if t.shape[dim] == 1 or (dim == broadcast and st == 0):
            out.append(math.prod(t.shape[dim + 1:]))
            continue
        if st <= 0 or (st * t.element_size()) % 16:
            raise ValueError(f"{kernel}: {name}'s stride {st} of dim {dim} "
                             "is not a positive multiple of 16 bytes, which "
                             "the bf16 route's TMA loads need")
        out.append(st)
    return tuple(out)


def check(err: int, what: str):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
