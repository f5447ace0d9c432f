"""Data-driven distance measures for client clustering (paper §3.3),
``repro.core.measures``.

  cosine_similarity_matrix  M_ij = S(i,j)                      (eq. 5/6)
  madc                      mean abs. diff of pairwise cosines (eq. 7)
  edc_embed                 decomposed cosine embedding         (eq. 8)
  edc_from_embedding        EDC distances of the embedding      (eq. 8)

``madc`` and ``edc_embed`` always go through the hand-written kernels
(``kernels.madc``, ``kernels.edc_cosine``): on the card the kernels run (or
the call raises); on the CPU their plain versions do. The reference's
trainer calls ``edc_embed`` without ``use_kernel``, which there means the
plain path; here there is no such switch, so the default EDC run goes
through the kernel on the card.

On a model axis (``mesh=``, a ``launch.mesh.FedMesh`` whose model axis is
> 1) the d_w columns are sharded: each rank passes its block, the partial
Grams, dots and squared norms are summed over the model group, and the
results are replicated (``edc_embed``'s V is this rank's rows of it).
"""
from __future__ import annotations

import torch

from repro_torch.core.svd import randomized_truncated_svd, sharded
from repro_torch.kernels.edc_cosine import (cosine_from_sums, edc_cosine,
                                            edc_cosine_partial)
from repro_torch.kernels.madc import madc as madc_kernel

_EPS = 1e-12


def row_normalize(x):
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=_EPS)


def cosine_similarity_matrix(dw_a, dw_b=None, *, mesh=None):
    """K(A, B): (n, q) pairwise cosine similarities. dw_*: (n, d) / (q, d).

    With a model-axis ``mesh`` dw_* are d-blocks: the partial Gram and the
    squared row norms, packed, are summed over the model group first."""
    if not sharded(mesh):
        a = row_normalize(dw_a)
        b = a if dw_b is None else row_normalize(dw_b)
        return torch.clamp(a @ b.T, -1.0, 1.0)
    b = dw_a if dw_b is None else dw_b
    n, q = dw_a.shape[0], b.shape[0]
    sums = mesh.model_sum(torch.cat([
        (dw_a @ b.T).reshape(-1), torch.sum(dw_a * dw_a, dim=1),
        torch.sum(b * b, dim=1)]))
    dots = sums[:n * q].view(n, q)
    na = torch.clamp(torch.sqrt(sums[n * q:n * q + n]), min=_EPS)
    nb = torch.clamp(torch.sqrt(sums[n * q + n:]), min=_EPS)
    return torch.clamp(dots / (na[:, None] * nb[None]), -1.0, 1.0)


def madc(M):
    """Mean-of-Absolute-Differences of pairwise Cosines (eq. 7).

    M: (n, n) cosine similarity matrix -> (n, n) dissimilarity matrix; the
    z != i, j exclusion removes the self-similarity observation bias."""
    return madc_kernel(M.contiguous())


def edc_embed(dW, m: int, omega, *, mesh=None):
    """Decompose ΔW into m singular directions and embed clients.

    dW: (n, d_w) parameter updates (with a model-axis ``mesh``, this rank's
    d-block); omega: the randomized SVD's (n, min(m + OVERSAMPLE, n)) test
    matrix. Returns (E (n, m), V (d_w, m); V's d-block on a model axis)."""
    V = randomized_truncated_svd(dW.T, m, omega, mesh=mesh)
    return edc_cosine_sharded(dW, V, mesh), V


def edc_cosine_sharded(dW, V, mesh=None):
    """E = K(ΔW, Vᵀ) (n, m): ``edc_cosine`` of the whole d, or on a model
    axis ``edc_cosine_partial`` of this rank's d-block, its packed sums
    summed over the model group (one all-reduce), then divided."""
    dW, V = dW.contiguous(), V.contiguous()
    if not sharded(mesh):
        return edc_cosine(dW, V)
    n, m = dW.shape[0], V.shape[1]
    return cosine_from_sums(mesh.model_sum(edc_cosine_partial(dW, V)), n, m)


def edc_from_embedding(E, m: int):
    """EDC(i,j) = ||E_i - E_j|| / m (eq. 8)."""
    d2 = torch.sum(torch.square(E[:, None, :] - E[None, :, :]), -1)
    return torch.sqrt(torch.clamp(d2, min=0.0)) / m


def cosine_dissimilarity(a, b):
    """Normalized cosine dissimilarity in [0, 1] (eq. 9 argument)."""
    num = torch.dot(a.reshape(-1), b.reshape(-1))
    den = torch.clamp(torch.linalg.norm(a) * torch.linalg.norm(b), min=_EPS)
    return (-num / den + 1.0) / 2.0
