"""Federated dataset container + non-IID partitioners: a copy of
``repro.data.federated``.

Offline-reproduction note (repro band = data gate): MNIST/FEMNIST/Sent140
downloads are unavailable in this environment, so the generators in
``repro_torch.data.generators`` synthesize datasets with the *same statistical
structure* the paper manipulates: class-conditional clusters, label-skew
(#classes/client), power-law client sizes, writer/account-level feature
shift. The Shamir Synthetic(α,β) set is exactly the paper's formula.

All clients are padded to ``max_samples`` so one batched local solver
serves every client (the client axis is a batch dimension).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FederatedData:
    """Stacked, padded per-client data.

    x_train: (N, max_n, ...) float   y_train: (N, max_n) int
    n_train: (N,) valid counts       (same trio for test)
    """
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    n_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    n_test: np.ndarray
    n_classes: int
    meta: dict = field(default_factory=dict)

    @property
    def n_clients(self) -> int:
        return self.x_train.shape[0]

    def client(self, i: int):
        return {
            "x": self.x_train[i, : self.n_train[i]],
            "y": self.y_train[i, : self.n_train[i]],
            "x_test": self.x_test[i, : self.n_test[i]],
            "y_test": self.y_test[i, : self.n_test[i]],
        }

    def store(self):
        """This population behind the host-resident ``ClientStore`` API,
        the streamed trainers' small-N backing (``fed.store``)."""
        from repro_torch.fed.store import ArrayClientStore
        return ArrayClientStore(self)


def power_law_sizes(rng: np.random.Generator, n_clients: int, total: int,
                    alpha: float = 1.5, min_size: int = 10,
                    max_size: int = 512) -> np.ndarray:
    """Client training-set sizes following a (truncated) power law, as in the
    paper's MNIST setup ("the training set size follows a power law")."""
    raw = rng.pareto(alpha, n_clients) + 1.0
    sizes = raw / raw.sum() * total
    return np.clip(sizes.astype(int), min_size, max_size)


def pack_clients(name: str, clients: list, n_classes: int,
                 meta: dict | None = None) -> FederatedData:
    """clients: list of dicts with x/y/x_test/y_test -> padded FederatedData."""
    N = len(clients)
    max_tr = max(len(c["y"]) for c in clients)
    max_te = max(max(len(c["y_test"]) for c in clients), 1)
    feat = clients[0]["x"].shape[1:]
    xt = np.zeros((N, max_tr) + feat, np.float32)
    yt = np.zeros((N, max_tr), np.int32)
    nt = np.zeros((N,), np.int32)
    xe = np.zeros((N, max_te) + feat, np.float32)
    ye = np.zeros((N, max_te), np.int32)
    ne = np.zeros((N,), np.int32)
    for i, c in enumerate(clients):
        n, m = len(c["y"]), len(c["y_test"])
        xt[i, :n], yt[i, :n], nt[i] = c["x"], c["y"], n
        if m:
            xe[i, :m], ye[i, :m], ne[i] = c["x_test"], c["y_test"], m
    return FederatedData(name, xt, yt, nt, xe, ye, ne, n_classes, meta or {})


def label_skew_partition(rng: np.random.Generator, X: np.ndarray,
                         Y: np.ndarray, n_clients: int,
                         classes_per_client: int, n_classes: int,
                         total_train: int, test_frac: float = 0.2):
    """Assign each client ``classes_per_client`` classes and sub-sample its
    data from those classes only (the paper's non-IID MNIST construction)."""
    sizes = power_law_sizes(rng, n_clients, total_train)
    by_class = {c: list(np.where(Y == c)[0]) for c in range(n_classes)}
    for c in by_class:
        rng.shuffle(by_class[c])
    cursors = {c: 0 for c in range(n_classes)}
    clients = []
    for i in range(n_clients):
        cls = rng.choice(n_classes, classes_per_client, replace=False)
        n_i = sizes[i]
        idx = []
        for j, c in enumerate(cls):
            want = n_i // classes_per_client + (1 if j < n_i % classes_per_client else 0)
            pool = by_class[c]
            take = []
            while len(take) < want:
                if cursors[c] >= len(pool):       # recycle (sampling w/o
                    cursors[c] = 0                 # replacement until exhausted)
                    rng.shuffle(pool)
                take.append(pool[cursors[c]])
                cursors[c] += 1
            idx.extend(take)
        idx = np.array(idx)
        rng.shuffle(idx)
        n_te = max(1, int(len(idx) * test_frac))
        clients.append({
            "x": X[idx[n_te:]], "y": Y[idx[n_te:]],
            "x_test": X[idx[:n_te]], "y_test": Y[idx[:n_te]],
        })
    return clients
