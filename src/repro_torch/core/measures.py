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
"""
from __future__ import annotations

import torch

from repro_torch.core.svd import randomized_truncated_svd
from repro_torch.kernels.edc_cosine import edc_cosine
from repro_torch.kernels.madc import madc as madc_kernel

_EPS = 1e-12


def row_normalize(x):
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=_EPS)


def cosine_similarity_matrix(dw_a, dw_b=None):
    """K(A, B): (n, q) pairwise cosine similarities. dw_*: (n, d) / (q, d)."""
    a = row_normalize(dw_a)
    b = a if dw_b is None else row_normalize(dw_b)
    return torch.clamp(a @ b.T, -1.0, 1.0)


def madc(M):
    """Mean-of-Absolute-Differences of pairwise Cosines (eq. 7).

    M: (n, n) cosine similarity matrix -> (n, n) dissimilarity matrix; the
    z != i, j exclusion removes the self-similarity observation bias."""
    return madc_kernel(M.contiguous())


def edc_embed(dW, m: int, omega):
    """Decompose ΔW into m singular directions and embed clients.

    dW: (n, d_w) parameter updates; omega: the randomized SVD's
    (n, min(m + OVERSAMPLE, n)) test matrix. Returns (E (n, m), V (d_w, m))."""
    V = randomized_truncated_svd(dW.T, m, omega)
    E = edc_cosine(dW.contiguous(), V.contiguous())        # (n, m)
    return E, V


def edc_from_embedding(E, m: int):
    """EDC(i,j) = ||E_i - E_j|| / m (eq. 8)."""
    d2 = torch.sum(torch.square(E[:, None, :] - E[None, :, :]), -1)
    return torch.sqrt(torch.clamp(d2, min=0.0)) / m


def cosine_dissimilarity(a, b):
    """Normalized cosine dissimilarity in [0, 1] (eq. 9 argument)."""
    num = torch.dot(a.reshape(-1), b.reshape(-1))
    den = torch.clamp(torch.linalg.norm(a) * torch.linalg.norm(b), min=_EPS)
    return (-num / den + 1.0) / 2.0
