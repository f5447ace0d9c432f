"""Optimizers on dicts of tensors (``repro.optim``): SGD, momentum, AdamW,
the FedProx proximal helper and a cosine learning-rate schedule."""
from repro_torch.optim.solvers import (adamw_init, adamw_update,
                                       cosine_schedule, momentum_init,
                                       momentum_update, proximal_grad,
                                       sgd_update)

__all__ = ["adamw_init", "adamw_update", "cosine_schedule", "momentum_init",
           "momentum_update", "proximal_grad", "sgd_update"]
