"""Plain PyTorch versions of the ported kernels: what a CPU tensor runs,
and what ``chip_smoke.py`` holds each CUDA kernel against on the card."""
from __future__ import annotations

import torch

_EPS = 1e-12


def cosine_block_ref(dW: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """E[i, j] = <ΔW_i, V_:,j> / max(||ΔW_i|| · max(||V_:,j||, ε), ε).

    dW: (n, d); V: (d, m) -> (n, m) float32 (``repro.kernels.ref
    .cosine_block_ref``, with the column-norm clamp of the Pallas kernel
    ``edc_cosine.py:63-64`` as well as its ``max(·, ε)`` on the product)."""
    dW32 = dW.float()
    V32 = V.float()
    dots = dW32 @ V32
    rn = torch.linalg.norm(dW32, dim=1, keepdim=True)
    cn = torch.clamp(torch.linalg.norm(V32, dim=0, keepdim=True), min=_EPS)
    return dots / torch.clamp(rn * cn, min=_EPS)


def madc_ref(M: torch.Tensor) -> torch.Tensor:
    """MADC(i, j) = Σ_{z≠i,j} |M_iz − M_jz| / max(n−2, 1) (eq. 7): the
    (n, n, n) broadcast of ``repro.core.measures.madc``."""
    M = M.float()
    n = M.shape[0]
    diff = torch.abs(M[:, None, :] - M[None, :, :])       # (n, n, n) over z
    eye = torch.eye(n, dtype=torch.bool, device=M.device)
    excl = eye[:, None, :] | eye[None, :, :]              # z == i or z == j
    s = torch.sum(torch.where(excl, 0.0, diff), dim=-1)
    return s / max(n - 2, 1)
