"""Mamba2 SSD intra-chunk block: the wrapper around the Hopper kernel
``csrc/ssd_chunk.cu``, which replaces the Pallas kernel
``repro.kernels.ssd_chunk.ssd_intra_chunk``.

``ssd_intra_chunk`` takes the model's chunked layout, as
``repro_torch.models.ssm.ssd_chunked`` holds it; ``ssd_intra_chunk_cells``
takes the Pallas kernel's (BH, NC, Q, ·) layout. Both reach one launch. A
CPU tensor runs the plain version (``kernels.ref.ssd_intra_chunk_ref``); a
CUDA tensor launches the kernel or raises. ``launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0
_DTYPES = (torch.float32, torch.bfloat16)
MAX_Q, MAX_P, MAX_N = 128, 64, 128


def ssd_intra_chunk(Xc: torch.Tensor, A_cs: torch.Tensor, Bc: torch.Tensor,
                    Cc: torch.Tensor):
    """Xc (b, c, Q, h, p); A_cs (b, h, c, Q) fp32, the inclusive cumsum of
    dt·A within each chunk; Bc, Cc (b, c, Q, h, n). Any strides with the
    last dim contiguous (a head expansion may be a stride-0 view).
    Returns (Y_diag (b, c, Q, h, p) fp32, states (b, c, h, p, n) fp32)."""
    b, c, Q, h, p = Xc.shape
    n = Bc.shape[-1]
    if (Bc.shape != (b, c, Q, h, n) or Cc.shape != Bc.shape
            or A_cs.shape != (b, h, c, Q)):
        raise ValueError(f"ssd_intra_chunk: X {tuple(Xc.shape)}, A_cs "
                         f"{tuple(A_cs.shape)}, B {tuple(Bc.shape)}, C "
                         f"{tuple(Cc.shape)}; want X (b, c, Q, h, p), A_cs "
                         "(b, h, c, Q), B and C (b, c, Q, h, n)")
    tensors = (Xc, A_cs, Bc, Cc)
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return ref.ssd_intra_chunk_ref(Xc, A_cs, Bc, Cc)
    if len(devs) != 1 or Xc.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk: inputs on "
                         f"{sorted(map(str, devs))}; all must be on one CUDA "
                         "device (or the CPU)")
    if (Xc.dtype not in _DTYPES or Bc.dtype != Xc.dtype
            or Cc.dtype != Xc.dtype or A_cs.dtype != torch.float32):
        raise TypeError(f"ssd_intra_chunk: X, B, C {Xc.dtype}, {Bc.dtype}, "
                        f"{Cc.dtype} (fp32 or bf16, alike) and A_cs "
                        f"{A_cs.dtype} (fp32)")
    if not (0 < Q <= MAX_Q and 0 < p <= MAX_P and 0 < n <= MAX_N) or \
            b * c * h == 0 or b * c * h >= 2 ** 31:
        raise ValueError(f"ssd_intra_chunk: Q={Q}, P={p}, N={n}, cells="
                         f"{b * c * h} outside the kernel's range (Q <= "
                         f"{MAX_Q}, P <= {MAX_P}, N <= {MAX_N})")
    if any(t.stride(-1) != 1 for t in (Xc, Bc, Cc)):
        raise ValueError("ssd_intra_chunk: the last dim of X, B, C must be "
                         "contiguous")
    lib = build.library()
    Y = torch.empty((b, c, Q, h, p), dtype=torch.float32, device=Xc.device)
    S = torch.empty((b, c, h, p, n), dtype=torch.float32, device=Xc.device)
    st = build.strides(Xc.stride()[:4], A_cs.stride(), Bc.stride()[:4],
                       Cc.stride()[:4], Y.stride()[:4], S.stride())
    err = build.launch(Xc, lib.ssd_intra_chunk_launch, Xc.data_ptr(),
                       A_cs.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                       Y.data_ptr(), S.data_ptr(), st, b, c, Q, h, p, n,
                       int(Xc.dtype == torch.bfloat16))
    build.check(err, "ssd_intra_chunk launch")
    global launches
    launches += 1
    return Y, S


def ssd_intra_chunk_cells(X: torch.Tensor, A_cs: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor):
    """The Pallas kernel's layout: X (BH, NC, Q, P); A_cs (BH, NC, Q);
    B, C (BH, NC, Q, N). Returns (Y_diag (BH, NC, Q, P) fp32,
    states (BH, NC, N, P) fp32) — states as (N, P) per cell, a transposed
    view of the (P, N) the model's layout gives."""
    Y, S = ssd_intra_chunk(X[:, :, :, None], A_cs[:, None], B[:, :, :, None],
                           C[:, :, :, None])
    return Y[:, :, :, 0], S[:, :, 0].transpose(-1, -2)
