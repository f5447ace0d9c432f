"""Blocked MADC proximity (paper eq. 7): the wrapper around the Hopper
kernel ``csrc/madc.cu``, which replaces the Pallas kernel
``repro.kernels.madc.madc_block``.

A CPU tensor runs the plain version (``kernels.ref.madc_ref``); a CUDA
tensor launches the kernel or raises — at every n: the reference's
interpret-mode crossover does not carry over, and none has been measured
on the H100 yet. ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0


def madc(M: torch.Tensor) -> torch.Tensor:
    """M: (n, n) fp32 cosine similarities -> (n, n) fp32 MADC."""
    if M.ndim != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"madc: M must be square, got {tuple(M.shape)}")
    if M.device.type == "cpu":
        return ref.madc_ref(M)
    if M.device.type != "cuda":
        raise ValueError(f"madc: M on {M.device}; CUDA or CPU only")
    if M.dtype != torch.float32:
        raise TypeError(f"madc: dtype {M.dtype}; fp32 only")
    if not M.is_contiguous():
        raise ValueError("madc: M must be contiguous")
    n = M.shape[0]
    if n == 0 or n * n >= 2 ** 62:
        raise ValueError(f"madc: n={n} outside the kernel's range")
    lib = build.library()
    out = torch.empty((n, n), dtype=torch.float32, device=M.device)
    with torch.cuda.device(M.device):
        err = lib.madc_launch(M.data_ptr(), out.data_ptr(), n,
                              torch.cuda.current_stream().cuda_stream)
    build.check(err, "madc launch")
    global launches
    launches += 1
    return out
