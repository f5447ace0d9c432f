"""Optimizers on ``dict[str, Tensor]`` parameters (``repro.optim.solvers``):
SGD, momentum, AdamW, the FedProx proximal gradient and a cosine
learning-rate schedule. Optimizer state (velocity, AdamW's moments) is
fp32 whatever the parameters' dtype; parameters keep theirs."""
from __future__ import annotations

import math

import torch


def sgd_update(params: dict, grads: dict, lr: float) -> dict:
    return {k: p - lr * grads[k] for k, p in params.items()}


def momentum_init(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def momentum_update(params: dict, grads: dict, vel: dict, lr: float,
                    beta: float = 0.9):
    vel = {k: beta * v + grads[k].float() for k, v in vel.items()}
    params = {k: (p.float() - lr * vel[k]).to(p.dtype)
              for k, p in params.items()}
    return params, vel


def adamw_init(params: dict) -> dict:
    return {"mu": momentum_init(params), "nu": momentum_init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def adamw_update(params: dict, grads: dict, opt: dict, lr: float, *,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    step = opt["step"] + 1
    t = step.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        mu = b1 * opt["mu"][k] + (1 - b1) * g
        nu = b2 * opt["nu"][k] + (1 - b2) * torch.square(g)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        p32 = p.float()
        new_p[k] = (p32 - lr * (u + weight_decay * p32)).to(p.dtype)
        new_mu[k], new_nu[k] = mu, nu
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}


def proximal_grad(params: dict, anchor: dict, mu: float) -> dict:
    """∇ of the FedProx term (μ/2)·||w − w0||²."""
    return {k: mu * (p - anchor[k]) for k, p in params.items()}


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine decay to
    ``min_frac · base_lr`` at ``total``; fp32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(step < warmup, warm, cos)
