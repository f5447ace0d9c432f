"""Randomized truncated SVD (Halko/Martinsson/Tropp), ``repro.core.svd``:
the range finder as matrix products + QR, all plain PyTorch
(``torch.matmul``, ``torch.linalg``) in fp32. The test matrix Ω is
injectable, so a parity test can feed the reference's."""
from __future__ import annotations

import torch

OVERSAMPLE = 8      # extra sketch columns beyond m


def randomized_truncated_svd(A: torch.Tensor, m: int, omega: torch.Tensor, *,
                             n_iter: int = 4,
                             oversample: int = OVERSAMPLE) -> torch.Tensor:
    """Top-m left singular vectors of A (d, n) -> V (d, m), orthonormal.

    For FedGroup A = ΔWᵀ with d = d_w >> n = #pretrain clients. ``omega``
    is the (n, min(m + oversample, n)) Gaussian test matrix, drawn by the
    caller (the trainers take it from ``draws.TorchDraws.svd_omega``).
    """
    d, n = A.shape
    k = min(m + oversample, n)
    A32 = A.float()
    omega = omega.to(A32.device, torch.float32)
    if tuple(omega.shape) != (n, k):
        raise ValueError(f"omega {tuple(omega.shape)} != {(n, k)}")
    Q, _ = torch.linalg.qr(A32 @ omega)                   # (d, k)
    for _ in range(n_iter):                               # subspace iteration
        W, _ = torch.linalg.qr(A32.T @ Q)                 # (n, k)
        Q, _ = torch.linalg.qr(A32 @ W)
    B = Q.T @ A32                                         # (k, n)
    Ub, _, _ = torch.linalg.svd(B, full_matrices=False)
    return (Q @ Ub)[:, :m]
