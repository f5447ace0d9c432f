"""Mesh-parallel FedGroup, its mesh-free half (``repro.fed.parallel``,
``parallel.py:336-447``): the pure functions of tensors that the
federated dry run (``launch/fed_dryrun.py``) drives at production size.

  make_parallel_round   one FedGroup round: K clients, each E epochs of
                        local SGD from its group's parameters, then
                        per-group weighted aggregation.
  cholesky_qr2, rsvd_sharded, edc_embedding_distributed, kmeans_step
                        Algorithm 3 on a production-size update matrix ΔW
                        (n_pre × d_w, d_w up to hundreds of millions):
                        the randomized SVD's heavy work is (d_w × small)
                        products; ``qr_impl="cholesky"`` replaces the
                        tall-skinny Householder QR by CholeskyQR2.

On the reference's mesh ΔW is sharded over "model" along d_w and the
small Gram products become all-reduces; on one device they are plain
products. As everywhere in the port, the randomized SVD's test matrix Ω
is an input (``repro_torch.draws``), not drawn from a key.

Not yet ported (ROADMAP.md queue 1, item 16): the mesh helpers,
``default_data_mesh`` … ``make_async_fold`` (``parallel.py:58-330``).
"""
from __future__ import annotations

import torch

from repro_torch.fed.rounds import make_round_executor
from repro_torch.kernels.edc_cosine import edc_cosine


def make_parallel_round(model, *, epochs: int, batch_size: int, lr: float,
                        mu: float, n_groups: int, max_samples: int):
    """Returns round_fn(group_params_stacked, membership, X, Y, n, idx)
      -> (new group params stacked, auxiliary global params, group deltas).

    group_params_stacked: param dict with leading axis m; membership: (K,)
    group id per client; X: (K, max_n, ...), Y: (K, max_n), n: (K,); idx:
    (K, round_fn.max_steps, batch_size) minibatch rows, where the reference
    takes a key per client.

    A thin adapter over ``fed.rounds.make_round_executor`` at η_G = 0, the
    fused round the trainers run. The executor's other outputs (the
    discrepancy, the mean loss, the flattened group deltas) are computed
    and dropped: eager PyTorch has no jit to eliminate them. The
    reference's ``quarantine`` pass-through is left to the executor's
    callers: no round here screens its clients."""
    core = make_round_executor(model, epochs=epochs, batch_size=batch_size,
                               lr=lr, mu=mu, n_groups=n_groups,
                               max_samples=max_samples, eta_g=0.0)

    def round_fn(group_params, membership, X, Y, n, idx):
        out = core(group_params, membership, X, Y, n, idx)
        return out.group_params, out.global_params, out.agg_delta

    round_fn.max_steps = core.max_steps
    return round_fn


def cholesky_qr2(Y: torch.Tensor):
    """CholeskyQR2: (Q, R) of a tall-skinny (d, k) Y from two rounds of
    Gram-matrix Cholesky. L⁻ᵀ is applied as a small (k, k) product, never
    a triangular solve on the tall operand (on a mesh that solve would
    gather Y)."""
    def _cqr(A):
        k = A.shape[1]
        G = A.T @ A                                      # (k, k)
        eye = torch.eye(k, dtype=G.dtype, device=G.device)
        Lc = torch.linalg.cholesky(G + 1e-8 * eye)
        Linv = torch.linalg.solve_triangular(Lc, eye, upper=False)
        return A @ Linv.T, Lc.T
    Q1, R1 = _cqr(Y)
    Q2, R2 = _cqr(Q1)
    return Q2, R2 @ R1


def rsvd_sharded(dW: torch.Tensor, m: int, *, omega: torch.Tensor,
                 n_iter: int = 4, oversample: int = 8,
                 qr_impl: str = "householder") -> torch.Tensor:
    """Top-m left singular directions of ΔWᵀ -> V (d_w, m).

    dW: (n, d_w); omega: the (n, min(m + oversample, n)) Gaussian test
    matrix. qr_impl: ``"householder"`` (``torch.linalg.qr``) or
    ``"cholesky"`` (``cholesky_qr2``)."""
    n, d = dW.shape
    k = min(m + oversample, n)
    if tuple(omega.shape) != (n, k):
        raise ValueError(f"omega {tuple(omega.shape)} != {(n, k)}")
    if qr_impl not in ("householder", "cholesky"):
        raise ValueError(f"qr_impl={qr_impl!r}: householder or cholesky")
    qr = torch.linalg.qr if qr_impl == "householder" else cholesky_qr2
    A = dW.float().T                                     # (d, n)
    Q = qr(A @ omega.to(A.device, torch.float32))[0]
    for _ in range(n_iter):
        W = qr(A.T @ Q)[0]
        Q = qr(A @ W)[0]
    B = Q.T @ A                                          # (k, n)
    Ub, _, _ = torch.linalg.svd(B, full_matrices=False)
    return Q @ Ub[:, :m]                                 # (d, m), contiguous


def edc_embedding_distributed(dW: torch.Tensor, m: int, *,
                              omega: torch.Tensor,
                              qr_impl: str = "householder"):
    """ΔW -> (E (n, m) cosine embedding, V (d_w, m)): the group cold
    start's hot path. E comes from ``edc_cosine``: the Hopper kernel on
    CUDA tensors, its plain version on the CPU and on ``meta``. The
    reference's ``use_kernel`` switch has no counterpart, so the cold start
    on the card always goes through the kernel."""
    V = rsvd_sharded(dW, m, omega=omega, qr_impl=qr_impl)
    return edc_cosine(dW, V), V


def kmeans_step(E: torch.Tensor, centers: torch.Tensor):
    """One Lloyd iteration on the embedding -> (assign (n,), new centers);
    an empty cluster keeps its center."""
    d2 = torch.sum(torch.square(E[:, None, :] - centers[None]), -1)
    assign = torch.argmin(d2, -1)
    onehot = (assign[:, None] == torch.arange(
        centers.shape[0], device=E.device)).float()
    counts = torch.sum(onehot, 0)
    sums = onehot.T @ E
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts[:, None], min=1), centers)
    return assign, new
