"""FeSEM (Xie et al. 2020, "Multi-Center Federated Learning"),
``repro.fed.fesem``.

ℓ2-distance stochastic EM: the server keeps m centres; each selected
client is assigned (E-step) to the centre nearest its last local model in
ℓ2, trains from it, and the centres become the weighted averages of their
members' local models (M-step ≡ the round's intra-group FedAvg).

Both halves run inside one call of the fused round: the E-step is the
assignment stage (``make_fesem_assign``), and the per-client flattened
local models ``local_flat`` are an (N, d_w) device tensor that the round
updates in place (``fesem_state_update``) — no host round trip. It is
allocated once with the round blocks' trash row, as (N+1, d_w), and
``local_flat`` is the view of its first N rows: a block carries the whole
buffer without copying it, and a captured graph keeps its address.

With a streamed population the (N, d_w) matrix stays on the host, in the
population's state table (lazy CPU rows, default centre 0): each round
gathers the cohort's rows (draining the state writer first), copies them
to the device and runs the same fused round on the (K, d_w) rows with
cohort-local ids; the updated rows go back through the writer thread.

A pinned checkpoint holds the (N, d_w) matrix as ``model/local_flat``; a
streamed one holds the touched host rows through the population's state
table.

Async (``async_depth >= 1``): a pinned dispatch reads the cohort's rows
into a copy and its fold writes them back into the buffer; a streamed
dispatch carries the rows gathered at stage time (the writer drained
first), and its fold hands the updated rows to the writer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fed.engine import FedConfig, GroupedTrainer, RoundMetrics
from repro_torch.models.modules import flatten_stacked, flatten_updates

INIT_OFFSET = 29        # group inits from seed + 29, as the reference


def make_fesem_assign():
    """Assignment stage: argmin-ℓ2 E-step of each selected client's last
    local model against the flattened group centres. state:
    {"local_flat": (n_clients, d_w), "idx": (K,) selected client ids}.

    The distance is Σ (a − c)², as the reference computes it: the
    expansion ‖a‖² + ‖c‖² − 2a·c cancels catastrophically at d_w ~ 4e5 and
    flips the argmin near ties. The (K, m, d_w) difference is formed whole
    (166 MB at K = 20, m = 5, d_w = 415,258 in fp32), not chunked."""
    def assign(group_params, X, Y, n, state):
        centers = flatten_stacked(group_params)                 # (m, d_w)
        local = state["local_flat"][state["idx"]]               # (K, d_w)
        d2 = torch.sum(torch.square(local[:, None, :] - centers[None]), -1)
        return torch.argmin(d2, dim=1)

    return assign


def fesem_state_update(state, membership, deltas, finals):
    """Write the selected clients' new flattened local models into the
    persistent (n_clients, d_w) matrix, in place on its device
    (``index_copy_``: no copy of the whole matrix, no host round trip)."""
    local_flat = state["local_flat"]
    local_flat.index_copy_(0, state["idx"], flatten_stacked(finals))
    return {"idx": state["idx"], "local_flat": local_flat}


class FeSEMTrainer(GroupedTrainer):
    """``init_group_params`` (an m-stacked dict) replaces the random
    centres; the other keywords are ``FedAvgTrainer``'s."""

    framework = "fesem"

    def __init__(self, model, data, cfg: FedConfig, init_group_params=None,
                 **kw):
        super().__init__(model, data, cfg, **kw)
        self.group_params = self._random_groups(INIT_OFFSET,
                                                init_group_params)
        # each client's last local model, all starting at centre 0
        flat0 = flatten_updates(self.group_param(0))
        if self.population is not None:
            # host rows in the state table; only the cohort's reach the card
            self.local_flat = None
            self.population.state.init_local_flat(flat0)
        else:
            # plus the zero trash row of the round blocks' padded lanes
            self._local_flat_rows = flat0[None].repeat(self.n_clients + 1, 1)
            self._local_flat_rows[-1] = 0.0
            self.local_flat = self._local_flat_rows[:-1]

    def _exec_spec(self) -> dict:
        return {"n_groups": self.m, "eta_g": 0.0,
                "assign_fn": make_fesem_assign(),
                "state_update_fn": fesem_state_update}

    # -- round-block carry: the (N+1, d_w) local-model buffer rides along
    def _block_kwargs(self) -> dict:
        kw = dict(self._exec_spec())
        # a round's E-step state from the carried buffer (idx already
        # redirected to the trash row for padded lanes), and the buffer
        # back out of the M-step scatter
        kw["make_state"] = lambda aux, idx, mem: {"local_flat": aux,
                                                  "idx": idx}
        kw["state_to_aux"] = lambda st: st["local_flat"]
        return kw

    def _carry_aux(self):
        return self._local_flat_rows

    def _carry_refs(self, carry: dict):
        super()._carry_refs(carry)
        self._local_flat_rows = carry["aux"]
        self.local_flat = carry["aux"][:-1]

    # -- async streaming: the E-step rows ride each staged dispatch --------
    def _async_stream_arg(self, idx):
        # the rows a client would train from at dispatch time: the gather
        # drains the writer, so every earlier fold's scatter is in
        rows = self.population.gather_local_flat(idx).to(self.device)
        return {"local_flat": rows,
                "idx": torch.arange(len(idx), device=self.device)}

    def _async_adopt(self, out, idx, folded_groups, folded_global):
        super()._async_adopt(out, idx, folded_groups, folded_global)
        self.population.scatter_local_flat(
            idx, out.assign_state["local_flat"])

    # -- checkpoint: + the pinned (N, d_w) local-model matrix ----------------
    def _ckpt_model_tree(self) -> dict:
        tree = super()._ckpt_model_tree()
        if self.local_flat is not None:
            tree["local_flat"] = self.local_flat
        return tree

    def _ckpt_load_model(self, tree: dict):
        super()._ckpt_load_model(tree)
        if "local_flat" in tree:
            # into the buffer that also holds the blocks' trash row
            self._local_flat_rows[:-1].copy_(tree["local_flat"])
            self.local_flat = self._local_flat_rows[:-1]

    def round(self, t: int, idx=None) -> RoundMetrics:
        if idx is None:
            idx = self._select()
        # FeSEM: server-side E-step, then 1 centre down + 1 model up
        self.comm_params += 2 * len(idx) * self.model_size
        x, y, n = self._client_batch(idx)
        ex = self._round_executor()
        if self.population is not None:
            # the cohort's host rows with cohort-local ids: the same fused
            # round on (K, d_w) instead of (N, d_w)
            rows = self.population.gather_local_flat(idx).to(self.device)
            state = {"local_flat": rows,
                     "idx": torch.arange(len(idx), device=self.device)}
        else:
            state = {"local_flat": self.local_flat,
                     "idx": torch.as_tensor(np.asarray(idx, np.int64),
                                            device=self.device)}
        out = ex(self.group_params, state, x, y, n,
                 self._batch_indices(n, ex.max_steps))
        self.group_params = out.group_params
        if self.population is not None:
            self.population.scatter_local_flat(
                idx, out.assign_state["local_flat"])
        else:
            self.local_flat = out.assign_state["local_flat"]
        self._adopt_membership(idx, out.membership.cpu().numpy())
        return self._add_round(t, self._round_eval(t), out)
