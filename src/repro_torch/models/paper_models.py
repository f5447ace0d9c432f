"""The paper's own experiment models: MCLR, MLP, LSTM sentiment classifier
(``repro.models.paper_models``), as plain functions on param dicts.

Table 2 of the paper:
  MNIST    MCLR (d_w=7,850)     MLP-128 (d_w=101,770)
  FEMNIST  MCLR (d_w=20,410)    MLP-512 (d_w=415,258)
  Synthetic(1,1) MCLR (d_w=610)
  Sent140  LSTM (d_w=243,861)

Each model exposes
  init(generator, device="cuda") -> params   (pass "cpu" off the card)
  apply(params, x) -> logits          (one client: x is (B, ...))
  loss / accuracy / correct_count(params, batch)
``torch.Generator`` and ``jax.random`` give different numbers from one
seed, so parity tests carry the JAX ``init`` params over
(``repro_torch.convert``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch import resolve_device


@dataclass(frozen=True)
class ModelSpec:
    name: str
    init: Callable
    apply: Callable

    def loss(self, params, batch):
        logits = self.apply(params, batch["x"])
        logp = F.log_softmax(logits.float(), -1)
        labels = batch["y"].long()
        return -torch.mean(torch.gather(logp, -1, labels[:, None]))

    def accuracy(self, params, batch):
        logits = self.apply(params, batch["x"])
        return torch.mean((torch.argmax(logits, -1) == batch["y"]).float())

    def correct_count(self, params, batch):
        logits = self.apply(params, batch["x"])
        return torch.sum(torch.argmax(logits, -1) == batch["y"])


def _normal(generator, shape, device, scale):
    # drawn on the generator's device (the CPU by default) so one seed gives
    # the same weights whichever device the model is then placed on; on
    # meta nothing is drawn (shapes only, for the dry run)
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    gdev = generator.device if generator is not None else "cpu"
    return (torch.randn(shape, generator=generator, device=gdev)
            * scale).to(device)


# ---------------------------------------------------------------------------

def mclr(in_dim: int, n_classes: int) -> ModelSpec:
    """Multinomial logistic regression (convex)."""
    def init(generator=None, device="cuda"):
        device = resolve_device(device)
        return {"w": torch.zeros((in_dim, n_classes), device=device),
                "b": torch.zeros((n_classes,), device=device)}

    def apply(params, x):
        return x @ params["w"] + params["b"]

    return ModelSpec(f"mclr_{in_dim}x{n_classes}", init, apply)


def mlp(in_dim: int, hidden: int, n_classes: int) -> ModelSpec:
    """One-hidden-layer perceptron (the paper's MLP-128 / MLP-512)."""
    def init(generator=None, device="cuda"):
        device = resolve_device(device)
        s1 = (2.0 / in_dim) ** 0.5
        s2 = (2.0 / hidden) ** 0.5
        return {"w1": _normal(generator, (in_dim, hidden), device, s1),
                "b1": torch.zeros((hidden,), device=device),
                "w2": _normal(generator, (hidden, n_classes), device, s2),
                "b2": torch.zeros((n_classes,), device=device)}

    def apply(params, x):
        h = torch.relu(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]

    return ModelSpec(f"mlp_{in_dim}x{hidden}x{n_classes}", init, apply)


def lstm_classifier(vocab: int, embed: int, hidden: int,
                    n_classes: int = 2) -> ModelSpec:
    """LSTM sequence classifier (the paper's Sent140 model)."""
    def init(generator=None, device="cuda"):
        device = resolve_device(device)
        s = (1.0 / hidden) ** 0.5
        return {
            "emb": _normal(generator, (vocab, embed), device, 0.1),
            "wx": _normal(generator, (embed, 4 * hidden), device,
                          (1.0 / embed) ** 0.5),
            "wh": _normal(generator, (hidden, 4 * hidden), device, s),
            "b": torch.zeros((4 * hidden,), device=device),
            "w_out": _normal(generator, (hidden, n_classes), device, s),
            "b_out": torch.zeros((n_classes,), device=device),
        }

    def apply(params, x):          # x: (B, T) tokens (stored as float in the
        B, T = x.shape             # padded federated container)
        e = params["emb"][x.to(torch.int32).long()]   # float -> int32 cast
        h = torch.zeros((B, params["wh"].shape[0]), dtype=e.dtype,
                        device=e.device)
        c = h
        for t in range(T):
            z = e[:, t] @ params["wx"] + h @ params["wh"] + params["b"]
            i, f, g, o = torch.chunk(z, 4, -1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h @ params["w_out"] + params["b_out"]

    return ModelSpec(f"lstm_{vocab}x{embed}x{hidden}", init, apply)
