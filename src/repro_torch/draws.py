"""Every random draw on the main path, behind one object.

The JAX package draws from ``jax.random`` keys inside its programs: the
local solver's minibatch indices (``client.py:46-47``), the randomized
SVD's test matrix Ω (``svd.py:26``) and the K-Means++ seeding
(``cluster.py:24,34``). The port's trainers ask a draws object for each of
them, in the order the reference splits its key, so a parity test can hand
in an object that replays the reference's draws and the two packages see
the same numbers.

``TorchDraws`` is the default: one CPU ``torch.Generator``, so a seed gives
the same draws whichever device the trainer runs on (the draws are small
and copied to the device).

A draws object's state is one numpy array (``get_state`` / ``set_state``),
which a trainer checkpoint stores under the name the reference gives its
PRNG key, ``model/key``. ``TorchDraws``'s is the generator's state: the
port's own random stream, which the JAX package's strict load refuses (its
key is ``uint32[2]``). An object that replays the reference's draws gives
the key itself, and its archives load into the JAX trainers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cluster import pp_seed_indices
from repro_torch.fed.client import draw_batch_indices


class TorchDraws:
    def __init__(self, seed: int = 0):
        self.generator = torch.Generator().manual_seed(int(seed))

    def get_state(self) -> np.ndarray:
        """The generator's state (uint8 bytes) as numpy."""
        return self.generator.get_state().numpy().copy()

    def set_state(self, state: np.ndarray):
        self.generator.set_state(torch.as_tensor(np.asarray(state, np.uint8)))

    def batch_indices(self, n: torch.Tensor, max_steps: int,
                      batch_size: int) -> torch.Tensor:
        """(K, max_steps, B) int64 minibatch rows, uniform in [0, n_k)."""
        return draw_batch_indices(n, max_steps, batch_size, self.generator)

    def svd_omega(self, n: int, k: int, device) -> torch.Tensor:
        """(n, k) standard-normal test matrix of the randomized SVD."""
        return torch.randn((n, k), generator=self.generator).to(device)

    def kmeans_seeds(self, X: torch.Tensor, k: int) -> torch.Tensor:
        """(k,) row indices of X chosen by K-Means++ seeding."""
        return pp_seed_indices(X, k, self.generator)
