"""Shared helpers of the port's parity tests: replaying the JAX package's
random draws so that both packages see the same numbers.

The JAX package draws inside its programs from ``jax.random`` keys; the
port asks a draws object (``repro_torch.draws``). ``ReplayDraws`` answers
those calls by walking the reference trainer's key chain in the same
order, so a port trainer built with it sees exactly the reference's
minibatch indices, SVD test matrix and K-Means++ seeds.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch


@functools.partial(jax.jit, static_argnums=(2, 3))
def _replay(keys, n, max_steps: int, batch_size: int):
    def one(key, nv):
        nv = jnp.maximum(nv, 1)

        def body(k, _):
            k, sk = jax.random.split(k)
            return k, jax.random.randint(sk, (batch_size,), 0, nv)

        _, idx = jax.lax.scan(body, key, None, length=max_steps)
        return idx

    return jax.vmap(one)(keys, n)


def replay_batch_indices(keys, n, max_steps: int, batch_size: int):
    """(K, max_steps, B) int64: the rows ``repro.fed.client``'s solver
    draws for each client key — a ``split`` then ``randint`` per step
    (compiled once per shape: the draws are integer ops, the same bits
    as op by op)."""
    idx = _replay(jnp.asarray(keys), jnp.asarray(n, jnp.int32),
                  int(max_steps), int(batch_size))
    return torch.as_tensor(np.asarray(idx).astype(np.int64))


def pp_seed_indices_jax(key, X, k: int):
    """The row indices ``repro.core.cluster._pp_seed`` picks (it returns
    only the centres): the same key splits and draws, unrolled."""
    X = jnp.asarray(X, jnp.float32)
    n = X.shape[0]
    k0, key = jax.random.split(key)
    first = jax.random.randint(k0, (), 0, n)
    centers = jnp.zeros((k, X.shape[1]), X.dtype).at[0].set(X[first])
    chosen = [int(first)]
    for i in range(1, k):
        d2 = jnp.min(jnp.sum(jnp.square(X[:, None, :] - centers[None]), -1)
                     + jnp.where(jnp.arange(k)[None, :] < i, 0.0, jnp.inf),
                     axis=1)
        kk, key = jax.random.split(key)
        probs = d2 / jnp.maximum(jnp.sum(d2), 1e-12)
        j = jax.random.categorical(kk, jnp.log(jnp.maximum(probs, 1e-30)))
        centers = centers.at[i].set(X[j])
        chosen.append(int(j))
    return torch.tensor(chosen, dtype=torch.int64)


class ReplayDraws:
    """The reference trainer's key chain (``PRNGKey(seed)``), answered in
    the order its trainers split the key: one split per solver call, one
    three-way split (SVD, K-Means++) per EDC group cold start.

    Its state is the key itself (``uint32[2]``), as the JAX trainer's
    checkpoint stores it: ``_km_key`` is used up inside the group cold
    start and never crosses a round boundary."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)
        self._km_key = None

    def get_state(self) -> np.ndarray:
        return np.asarray(self.key).copy()

    def set_state(self, state):
        self.key = jnp.asarray(np.asarray(state, np.uint32))

    def batch_indices(self, n, max_steps: int, batch_size: int):
        self.key, sk = jax.random.split(self.key)
        keys = jax.random.split(sk, n.shape[0])
        return replay_batch_indices(keys, n.cpu().numpy(), max_steps,
                                    batch_size).to(n.device)

    def svd_omega(self, n: int, k: int, device):
        self.key, sk_svd, self._km_key = jax.random.split(self.key, 3)
        om = jax.random.normal(sk_svd, (n, k), jnp.float32)
        return torch.as_tensor(np.array(om)).to(device)

    def kmeans_seeds(self, X, k: int):
        return pp_seed_indices_jax(self._km_key, X.detach().cpu().numpy(), k)


def tnp(x) -> np.ndarray:
    """Tensor or array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
