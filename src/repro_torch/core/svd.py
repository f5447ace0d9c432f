"""Randomized truncated SVD (Halko/Martinsson/Tropp), ``repro.core.svd``:
the range finder as matrix products + QR, all plain PyTorch
(``torch.matmul``, ``torch.linalg``) in fp32. The test matrix Ω is
injectable, so a parity test can feed the reference's. The tall QR is
Householder (``torch.linalg.qr``) or CholeskyQR2 (``cholesky_qr2``);
``fed.parallel.rsvd_sharded`` is this function on ΔW.

On a model axis (``mesh``: a ``launch.mesh.FedMesh`` whose model axis is
> 1) A is this rank's block of rows (a d-block of ΔWᵀ): ``A @ Ω`` and
``A @ W`` stay local, ``Aᵀ Q`` and ``Qᵀ A`` are summed over the model
group, and the tall QR runs as TSQR (``tsqr``). V comes back as this
rank's rows; it matches one device's up to the signs of its columns."""
from __future__ import annotations

import torch

OVERSAMPLE = 8      # extra sketch columns beyond m


def sharded(mesh) -> bool:
    """Whether ``mesh`` has a model axis the d-sharded products sum over."""
    return mesh is not None and mesh.model_shards > 1


def tsqr(Y: torch.Tensor, mesh) -> tuple:
    """QR of a tall (d, k) Y whose rows are sharded over the model axis:
    each rank's local QR, the M (k, k) R factors gathered over the model
    group in model-index order, the QR of that stack, and this rank's
    block of its Q applied -> (this rank's rows of Q, R replicated)."""
    k = Y.shape[1]
    if Y.shape[0] < k:
        raise ValueError(f"tsqr: a block of {Y.shape[0]} rows is shorter "
                         f"than its {k} columns")
    Q1, R1 = torch.linalg.qr(Y)
    Q2, R = torch.linalg.qr(mesh.model_gather(R1, 0))     # (M k, k)
    i = mesh.model_index
    return Q1 @ Q2[i * k:(i + 1) * k], R


def cholesky_qr2(Y: torch.Tensor, mesh=None):
    """CholeskyQR2: (Q, R) of a tall-skinny (d, k) Y from two rounds of
    Gram-matrix Cholesky. L⁻ᵀ is applied as a small (k, k) product, never
    a triangular solve on the tall operand (on a mesh that solve would
    gather Y). With a model-axis ``mesh`` Y's rows are sharded: each Gram
    is summed over the model group (two all-reduces) and Q comes back as
    this rank's rows."""
    total = mesh.model_sum if sharded(mesh) else (lambda t: t)

    def _cqr(A):
        k = A.shape[1]
        G = total(A.T @ A)                               # (k, k)
        eye = torch.eye(k, dtype=G.dtype, device=G.device)
        Lc = torch.linalg.cholesky(G + 1e-8 * eye)
        Linv = torch.linalg.solve_triangular(Lc, eye, upper=False)
        return A @ Linv.T, Lc.T
    Q1, R1 = _cqr(Y)
    Q2, R2 = _cqr(Q1)
    return Q2, R2 @ R1


def randomized_truncated_svd(A: torch.Tensor, m: int, omega: torch.Tensor, *,
                             n_iter: int = 4, oversample: int = OVERSAMPLE,
                             qr_impl: str = "householder",
                             mesh=None) -> torch.Tensor:
    """Top-m left singular vectors of A (d, n) -> V (d, m), orthonormal.

    For FedGroup A = ΔWᵀ with d = d_w >> n = #pretrain clients. ``omega``
    is the (n, min(m + oversample, n)) Gaussian test matrix, drawn by the
    caller (the trainers take it from ``draws.TorchDraws.svd_omega``).
    ``qr_impl``: ``"householder"`` (TSQR on a model axis) or
    ``"cholesky"``. With a model-axis ``mesh`` A and V are this rank's
    d-block; the small (n, k) QRs are replicated and need no collective.
    """
    d, n = A.shape
    k = min(m + oversample, n)
    if tuple(omega.shape) != (n, k):
        raise ValueError(f"omega {tuple(omega.shape)} != {(n, k)}")
    if qr_impl not in ("householder", "cholesky"):
        raise ValueError(f"qr_impl={qr_impl!r}: householder or cholesky")
    qr = torch.linalg.qr if qr_impl == "householder" else cholesky_qr2
    if not sharded(mesh):
        tall, total = qr, (lambda t: t)
    elif qr_impl == "householder":
        tall, total = (lambda Y: tsqr(Y, mesh)), mesh.model_sum
    else:
        tall, total = (lambda Y: cholesky_qr2(Y, mesh)), mesh.model_sum
    A32 = A.float()
    Q = tall(A32 @ omega.to(A32.device, torch.float32))[0]   # (d, k)
    for _ in range(n_iter):                               # subspace iteration
        W = qr(total(A32.T @ Q))[0]                       # (n, k)
        Q = tall(A32 @ W)[0]
    B = total(Q.T @ A32)                                  # (k, n)
    Ub, _, _ = torch.linalg.svd(B, full_matrices=False)
    return Q @ Ub[:, :m]                                  # (d, m), contiguous
