"""EDC cosine block E = K(ΔW, Vᵀ) (paper eq. 8): the wrapper around the
Hopper kernel ``csrc/edc_cosine.cu``, which replaces the Pallas kernel
``repro.kernels.edc_cosine.edc_cosine``.

A CPU tensor runs the plain version (``kernels.ref.cosine_block_ref``); a
CUDA tensor launches the kernel or raises. ``launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0
_DTYPES = (torch.float32, torch.bfloat16)
MAX_M = 16


def edc_cosine(dW: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """dW: (n, d), V: (d, m), fp32 or bf16 -> (n, m) fp32 cosines."""
    if dW.ndim != 2 or V.ndim != 2 or dW.shape[1] != V.shape[0]:
        raise ValueError(f"edc_cosine: shapes {tuple(dW.shape)} and "
                         f"{tuple(V.shape)} do not chain (n, d) @ (d, m)")
    if dW.device.type == "cpu" and V.device.type == "cpu":
        return ref.cosine_block_ref(dW, V)
    if dW.device.type != "cuda" or V.device != dW.device:
        raise ValueError(f"edc_cosine: dW on {dW.device}, V on {V.device}; "
                         "both must be on one CUDA device (or the CPU)")
    if dW.dtype not in _DTYPES or V.dtype not in _DTYPES:
        raise TypeError(f"edc_cosine: dtypes {dW.dtype}, {V.dtype}; "
                        "fp32 or bf16 only")
    if not (dW.is_contiguous() and V.is_contiguous()):
        raise ValueError("edc_cosine: dW and V must be contiguous")
    n, d = dW.shape
    m = V.shape[1]
    if not (0 < m <= MAX_M) or n == 0 or d == 0 or max(n, d) >= 2 ** 31:
        raise ValueError(f"edc_cosine: n={n}, d={d}, m={m} outside the "
                         f"kernel's range (1 <= m <= {MAX_M}, n, d >= 1)")
    lib = build.library()
    out = torch.empty((n, m), dtype=torch.float32, device=dW.device)
    scratch = torch.empty(lib.edc_cosine_scratch(n, d, m),
                          dtype=torch.float32, device=dW.device)
    err = build.launch(dW, lib.edc_cosine_launch, dW.data_ptr(),
                       V.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, d,
                       m, int(dW.dtype == torch.bfloat16),
                       int(V.dtype == torch.bfloat16))
    build.check(err, "edc_cosine launch")
    global launches
    launches += 1
    return out
