"""Clustering backends for the group cold start (``repro.core.cluster``).

  kmeans_pp      — K-Means++ seeding + Lloyd iterations on the EDC
                   embedding (paper Algorithm 3, EDC branch). The seeding's
                   draws are injectable as the chosen row indices.
  hierarchical   — agglomerative complete-linkage on a precomputed
                   proximity matrix (the MADC branch), host-side numpy: a
                   copy of the reference's, which cannot be imported here
                   (its module imports jax).
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# K-Means++
# ---------------------------------------------------------------------------

def _sq_dists(X, centers):
    return torch.sum(torch.square(X[:, None, :] - centers[None]), -1)


def pp_seed_indices(X: torch.Tensor, k: int,
                    generator: torch.Generator) -> torch.Tensor:
    """K-Means++ seeding (Arthur & Vassilvitskii 2006): the k chosen row
    indices of X, drawn from ``generator`` (a CPU generator) on a host copy
    of X. Like the reference's ``categorical`` over ``log(max(p, 1e-30))``,
    an all-zero distance vector draws uniformly."""
    Xc = X.detach().float().cpu()
    n = Xc.shape[0]
    chosen = [int(torch.randint(n, (), generator=generator))]
    for _ in range(1, k):
        d2 = torch.min(_sq_dists(Xc, Xc[chosen]), dim=1).values
        probs = d2 / torch.clamp(torch.sum(d2), min=1e-12)
        w = torch.clamp(probs, min=1e-30).double()
        chosen.append(int(torch.multinomial(w, 1, generator=generator)))
    return torch.tensor(chosen, dtype=torch.int64)


def kmeans_pp(X: torch.Tensor, k: int, seed_idx, n_iter: int = 50):
    """X: (n, m) -> (assignments (n,), centers (k, m)). ``seed_idx`` are the
    K-Means++ seeds' row indices (``draws.TorchDraws.kmeans_seeds`` draws
    them with ``pp_seed_indices``)."""
    X = X.float()
    centers = X[torch.as_tensor(seed_idx, dtype=torch.int64,
                                device=X.device)]
    for _ in range(n_iter):
        assign = torch.argmin(_sq_dists(X, centers), -1)
        onehot = torch.nn.functional.one_hot(assign, k).float()   # (n, k)
        counts = torch.sum(onehot, 0)                             # (k,)
        sums = onehot.T @ X                                       # (k, m)
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1),
                              centers)
    assign = torch.argmin(_sq_dists(X, centers), -1)
    return assign, centers


def kmeans_inertia(X, assign, centers):
    """Within-cluster sum-of-squares (the paper's clustering validity index)."""
    return torch.sum(torch.sum(torch.square(X - centers[assign]), -1))


# ---------------------------------------------------------------------------
# Hierarchical complete-linkage (numpy, host)
# ---------------------------------------------------------------------------

def hierarchical(proximity, k: int):
    """Agglomerative clustering with complete linkage.

    proximity: (n, n) symmetric dissimilarity matrix (e.g. MADC).
    Returns integer labels (n,) with k clusters.

    Merged-away rows/columns are masked to +inf in the full matrix and the
    next pair is a single ``argmin(D)``; masked entries are +inf, so
    row-major ``argmin`` order over the full matrix is the active
    submatrix's row-major order (ties break as in the reference).
    """
    D = np.array(proximity, dtype=np.float64, copy=True)
    n = D.shape[0]
    np.fill_diagonal(D, np.inf)
    members = {i: [i] for i in range(n)}
    n_active = n
    while n_active > k:
        i, j = np.unravel_index(np.argmin(D), D.shape)
        if j < i:
            i, j = j, i
        # complete linkage: distance to merged = max of distances
        upd = np.maximum(D[i], D[j])
        D[i, :] = D[:, i] = upd
        D[i, i] = np.inf
        D[j, :] = D[:, j] = np.inf
        members[i].extend(members.pop(j))
        n_active -= 1
    labels = np.zeros(n, dtype=np.int32)
    for lbl, root in enumerate(sorted(members)):
        labels[members[root]] = lbl
    return labels
