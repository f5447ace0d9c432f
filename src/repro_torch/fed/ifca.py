"""IFCA (Ghosh et al., NeurIPS 2020), ``repro.fed.ifca``.

Per round the server broadcasts all m cluster models to the selected
clients; each client takes the model with the least local training loss as
its cluster and trains it. The argmin-loss estimate is the fused round's
assignment stage (``make_ifca_assign``), so a round is still one call of
the round executor; the communication count keeps the m× broadcast
((m + 1) model transfers per selected client per round).
"""
from __future__ import annotations

import torch
from torch.func import vmap

from repro_torch.fed import client as client_lib
from repro_torch.fed.engine import FedConfig, GroupedTrainer, RoundMetrics

INIT_OFFSET = 17        # group inits from seed + 17, as the reference


def group_losses(model, group_params, X, Y, n) -> torch.Tensor:
    """(m, K) mean train loss of each client under each stacked group
    model."""
    per_client = vmap(client_lib.client_mean_loss(model),
                      in_dims=(None, 0, 0, 0))
    return vmap(lambda gp: per_client(gp, X, Y, n))(group_params)


def make_ifca_assign(model):
    """Assignment stage: per-client argmin of mean train loss over the m
    stacked group models (IFCA §3 cluster-identity estimate)."""
    def assign(group_params, X, Y, n, state):
        return torch.argmin(group_losses(model, group_params, X, Y, n),
                            dim=0)                          # (K,) over m

    return assign


class IFCATrainer(GroupedTrainer):
    """``init_group_params`` (an m-stacked dict) replaces the random
    centres; the other keywords are ``FedAvgTrainer``'s."""

    framework = "ifca"

    def __init__(self, model, data, cfg: FedConfig, init_group_params=None,
                 **kw):
        super().__init__(model, data, cfg, **kw)
        # random initialisations of the cluster centres (IFCA §3)
        self.group_params = self._random_groups(INIT_OFFSET,
                                                init_group_params)

    def _exec_spec(self) -> dict:
        return {"n_groups": self.m, "eta_g": 0.0,
                "assign_fn": make_ifca_assign(self.model)}

    def _stage_comm(self, k: int):
        # the m× broadcast accounting is per ALIVE client, block or not
        self.comm_params += (self.m + 1) * k * self.model_size

    def _async_stream_arg(self, idx):
        return None      # the in-round argmin-loss stage needs no state

    def round(self, t: int, idx=None) -> RoundMetrics:
        if idx is None:
            idx = self._select()
        # IFCA broadcasts all m cluster models to every selected client
        self.comm_params += (self.m + 1) * len(idx) * self.model_size
        x, y, n = self._client_batch(idx)
        ex = self._round_executor()
        out = ex(self.group_params, None, x, y, n,
                 self._batch_indices(n, ex.max_steps))
        self.group_params = out.group_params
        self._adopt_membership(idx, out.membership.cpu().numpy())
        return self._add_round(t, self._round_eval(t), out)
