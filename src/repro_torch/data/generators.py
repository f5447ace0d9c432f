"""Synthetic federated dataset generators: a copy of
``repro.data.generators`` (same seed, same bytes).

  mnist_like    10-class class-conditional clusters in R^784, label-skew
                partition with #classes/client knob (paper §3.1 / Table 1).
  femnist_like  62 classes, 200 writer-clients; each writer applies a private
                affine style transform — natural feature-shift non-IID.
  synthetic     Shamir et al. Synthetic(alpha, beta) — exactly the paper's
                generator (60-dim, 10 classes, d_w = 610 with MCLR).
  sent140_like  binary sentiment over token sequences; each client (account)
                has a private topic mixture; positive/negative lexicons.
  virtual_synthetic / virtual_mnist_like
                the same structures as lazy ``fed.store.VirtualClientStore``
                populations (10^5-10^6 clients, each generated on first
                touch from its own seed) for the streamed trainers.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.federated import (FederatedData,
                                        label_skew_partition, pack_clients,
                                        power_law_sizes)


def _class_prototypes(rng, n_classes: int, dim: int, sep: float = 2.2):
    protos = rng.normal(0, 1, (n_classes, dim)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    return protos * sep


def mnist_like(seed: int = 0, n_clients: int = 1000,
               classes_per_client: int = 2, total_train: int = 69035,
               dim: int = 784, n_classes: int = 10) -> FederatedData:
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(rng, n_classes, dim)
    n_total = int(total_train * 1.4)
    Y = rng.integers(0, n_classes, n_total)
    X = (protos[Y] + rng.normal(0, 1.0, (n_total, dim))).astype(np.float32)
    clients = label_skew_partition(rng, X, Y, n_clients, classes_per_client,
                                   n_classes, total_train)
    return pack_clients(f"mnist_like_c{classes_per_client}", clients,
                        n_classes, {"classes_per_client": classes_per_client})


def femnist_like(seed: int = 0, n_clients: int = 200,
                 total_train: int = 18345, dim: int = 784,
                 n_classes: int = 62, n_styles: int = 5) -> FederatedData:
    """Writer-level non-IID: clients belong to latent style groups; each
    style applies a shared rotation+shift to the class prototypes, and each
    writer adds a small private perturbation.  The latent styles give CFL
    something real to discover — mirroring FEMNIST's writer clusters."""
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(rng, n_classes, dim)
    # style transforms: random orthogonal-ish mixing + bias
    styles = []
    for s in range(n_styles):
        M = np.eye(dim, dtype=np.float32) + 0.35 * rng.normal(
            0, 1 / np.sqrt(dim), (dim, dim)).astype(np.float32)
        b = rng.normal(0, 0.9, dim).astype(np.float32)
        styles.append((M, b))
    sizes = power_law_sizes(rng, n_clients, total_train, min_size=30,
                            max_size=400)
    style_of = rng.integers(0, n_styles, n_clients)
    clients = []
    for i in range(n_clients):
        M, b = styles[style_of[i]]
        n_i = sizes[i]
        # each writer covers a subset of classes (handwriting habit)
        cls = rng.choice(n_classes, rng.integers(8, 20), replace=False)
        y = rng.choice(cls, n_i)
        x = protos[y] + rng.normal(0, 0.9, (n_i, dim)).astype(np.float32)
        x = x @ M.T + b + rng.normal(0, 0.1, (n_i, dim)).astype(np.float32)
        n_te = max(1, n_i // 5)
        clients.append({"x": x[n_te:].astype(np.float32), "y": y[n_te:],
                        "x_test": x[:n_te].astype(np.float32), "y_test": y[:n_te]})
    return pack_clients("femnist_like", clients, n_classes,
                        {"style_of": style_of})


def synthetic(alpha: float = 1.0, beta: float = 1.0, seed: int = 0,
              n_clients: int = 100, dim: int = 60,
              n_classes: int = 10) -> FederatedData:
    """Shamir/FedProx Synthetic(alpha, beta) — the paper's exact generator."""
    rng = np.random.default_rng(seed)
    sizes = power_law_sizes(rng, n_clients, 75349, min_size=20, max_size=1200)
    diag = np.array([(j + 1) ** -1.2 for j in range(dim)], np.float32)
    clients = []
    for i in range(n_clients):
        u = rng.normal(0, alpha)
        Bv = rng.normal(0, beta)
        v = rng.normal(Bv, 1, dim)
        W = rng.normal(u, 1, (dim, n_classes)).astype(np.float32)
        b = rng.normal(u, 1, n_classes).astype(np.float32)
        n_i = sizes[i]
        x = rng.normal(v, np.sqrt(diag), (n_i, dim)).astype(np.float32)
        logits = x @ W + b
        y = np.argmax(logits, 1).astype(np.int32)
        n_te = max(1, n_i // 5)
        clients.append({"x": x[n_te:], "y": y[n_te:],
                        "x_test": x[:n_te], "y_test": y[:n_te]})
    return pack_clients(f"synthetic_{alpha}_{beta}", clients, n_classes, {})


def _virtual_sizes(seed: int, n_clients: int, mean_size: int,
                   min_size: int, max_size: int):
    """(n_train, n_test) per-client size vectors, power-law distributed —
    the only O(N) arrays a virtual population materializes up front."""
    rng = np.random.default_rng(seed)
    total = power_law_sizes(rng, n_clients, mean_size * n_clients,
                            min_size=min_size, max_size=max_size)
    n_test = np.maximum(1, total // 5).astype(np.int32)
    n_train = (total - n_test).astype(np.int32)
    return n_train, n_test


def virtual_synthetic(alpha: float = 1.0, beta: float = 1.0, seed: int = 0,
                      n_clients: int = 100_000, dim: int = 60,
                      n_classes: int = 10, mean_size: int = 40,
                      min_size: int = 10, max_size: int = 120,
                      memmap_dir: str | None = None, **store_kw):
    """Shamir Synthetic(alpha, beta) as a lazy ``VirtualClientStore``.

    Statistically the same population as ``synthetic`` but with per-client
    seeding (``SeedSequence([seed, i])``), so client i's shard is a pure
    function of i — generated on first touch, optionally persisted to
    memory-mapped shard files, never stacked host- or device-side."""
    from repro_torch.fed.store import VirtualClientStore
    n_train, n_test = _virtual_sizes(seed, n_clients, mean_size,
                                     min_size, max_size)
    diag = np.array([(j + 1) ** -1.2 for j in range(dim)], np.float32)

    def client_fn(i: int):
        rng = np.random.default_rng([seed, 7919, i])
        u = rng.normal(0, alpha)
        Bv = rng.normal(0, beta)
        v = rng.normal(Bv, 1, dim)
        W = rng.normal(u, 1, (dim, n_classes)).astype(np.float32)
        b = rng.normal(u, 1, n_classes).astype(np.float32)
        tot = int(n_train[i]) + int(n_test[i])
        x = rng.normal(v, np.sqrt(diag), (tot, dim)).astype(np.float32)
        y = np.argmax(x @ W + b, 1).astype(np.int32)
        n_te = int(n_test[i])
        return {"x": x[n_te:], "y": y[n_te:],
                "x_test": x[:n_te], "y_test": y[:n_te]}

    return VirtualClientStore(
        f"virtual_synthetic_{alpha}_{beta}_N{n_clients}", n_clients,
        client_fn, max_train=int(n_train.max()), max_test=int(n_test.max()),
        feat=(dim,), n_classes=n_classes, n_train=n_train, n_test=n_test,
        memmap_dir=memmap_dir, **store_kw)


def virtual_mnist_like(seed: int = 0, n_clients: int = 100_000,
                       classes_per_client: int = 2, dim: int = 64,
                       n_classes: int = 10, mean_size: int = 40,
                       min_size: int = 10, max_size: int = 120,
                       memmap_dir: str | None = None, **store_kw):
    """Label-skew class-cluster population as a lazy ``VirtualClientStore``
    (the ``mnist_like`` structure without the global sampling pool, so each
    client is independently generable)."""
    from repro_torch.fed.store import VirtualClientStore
    n_train, n_test = _virtual_sizes(seed, n_clients, mean_size,
                                     min_size, max_size)
    protos = _class_prototypes(np.random.default_rng(seed), n_classes, dim)

    def client_fn(i: int):
        rng = np.random.default_rng([seed, 104729, i])
        cls = rng.choice(n_classes, classes_per_client, replace=False)
        tot = int(n_train[i]) + int(n_test[i])
        y = rng.choice(cls, tot).astype(np.int32)
        x = (protos[y] + rng.normal(0, 1.0, (tot, dim))).astype(np.float32)
        n_te = int(n_test[i])
        return {"x": x[n_te:], "y": y[n_te:],
                "x_test": x[:n_te], "y_test": y[:n_te]}

    return VirtualClientStore(
        f"virtual_mnist_c{classes_per_client}_N{n_clients}", n_clients,
        client_fn, max_train=int(n_train.max()), max_test=int(n_test.max()),
        feat=(dim,), n_classes=n_classes, n_train=n_train, n_test=n_test,
        memmap_dir=memmap_dir, **store_kw)


def sent140_like(seed: int = 0, n_clients: int = 772, vocab: int = 1000,
                 seq_len: int = 25, total_train: int = 40783) -> FederatedData:
    """Binary sentiment over token sequences.  Each account mixes a private
    topic distribution with shared positive/negative lexicons, so accounts
    are statistically heterogeneous in both vocabulary and label balance."""
    rng = np.random.default_rng(seed)
    n_topics = 8
    pos_lex = rng.choice(vocab, 60, replace=False)
    neg_lex = np.array([t for t in rng.choice(vocab, 120, replace=False)
                        if t not in set(pos_lex)][:60])
    topic_words = [rng.choice(vocab, 120, replace=False) for _ in range(n_topics)]
    sizes = power_law_sizes(rng, n_clients, total_train, min_size=12,
                            max_size=200)
    clients = []
    for i in range(n_clients):
        mix = rng.dirichlet(np.ones(n_topics) * 0.4)
        pos_rate = np.clip(rng.beta(3, 3), 0.15, 0.85)
        n_i = sizes[i]
        y = (rng.random(n_i) < pos_rate).astype(np.int32)
        x = np.zeros((n_i, seq_len), np.int32)
        for s in range(n_i):
            topic = rng.choice(n_topics, p=mix)
            base = rng.choice(topic_words[topic], seq_len)
            lex = pos_lex if y[s] == 1 else neg_lex
            n_sent = rng.integers(3, 8)
            pos = rng.choice(seq_len, n_sent, replace=False)
            base[pos] = rng.choice(lex, n_sent)
            x[s] = base
        n_te = max(1, n_i // 5)
        clients.append({"x": x[n_te:].astype(np.float32), "y": y[n_te:],
                        "x_test": x[:n_te].astype(np.float32), "y_test": y[:n_te]})
    return pack_clients("sent140_like", clients, 2, {"seq_len": seq_len})
