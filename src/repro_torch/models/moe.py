"""Mixture-of-Experts layer with capacity dispatch (``repro.models.moe``).

  * top-k router (fp32, whatever the param dtype) with softmax gates,
    normalized over the top k.
  * ``moe_apply``: the flattened (token, slot) assignments are ranked
    within their expert by a one-hot cumulative sum in token-major order
    and scattered into a dense (E, C, D) buffer of capacity C; assignments
    past an expert's capacity are dropped (their combine weight is zero).
  * ``moe_apply_grouped``: the same per group (a batch row), by a stable
    sort on the expert id; every gather stays inside its group.
  * expert compute: batched products over the expert axis (``bmm``), as
    the JAX package computes them outside any Pallas kernel.
  * aux losses: Switch load-balance loss, router z-loss, and each
    expert's share of the assignments.
  * determinism on the card: no sum goes through atomics, in the forward
    (the combine is a sum over each token's k slots) or the backward (a
    token's copies are gathered by indexing, whose backward sorts).

The capacity is ``int(round(tokens · k / E · capacity_factor))`` (Python's
round, half to even), at least 1, rounded up to a multiple of 8, exactly
as the JAX package computes it: any other rounding drops other tokens.

Over a model axis (``tp``, ``modules.ModelAxis``) whose size divides E, a
rank holds E / M experts (expert parallelism). The router is replicated:
each rank routes its tokens whole (gates, experts, capacity, ranks, the
same on the model group's ranks), fills and runs only its experts'
buffers, combines their slots (a token's slots in their fixed order, the
others adding zero) and the model group sums the combine; the shared
experts split d_ff as an MLP does. When the batch is split over data
slices (``tp.data_split``) the routing is the whole batch's, as one
device's: the capacity counts every slice's tokens, a slot's rank counts
the slices before it (each slice's per-expert counts, gathered over the
data group) and the aux losses are means over every slice. In training
the tokens and the gates enter the rank's experts (``ModelAxis.enter``),
so the router's gradient is whole on every rank.

With the expert stacks over ("data", "model") (``moe_2d``, training) a
rank holds E / (D·M) experts and runs them on every slice's tokens: the
expert exchange below.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.modules import act_fn, dense_init, randn


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    expert_load: torch.Tensor         # fraction of tokens routed per expert


def init_moe(gen, d_model: int, d_ff: int, n_experts: int,
             n_shared: int = 0, shared_d_ff: int | None = None,
             gated: bool = True, dtype=torch.float32, device="cpu"):
    scale = 1.0 / math.sqrt(d_model)
    p = {
        "router": dense_init(gen, d_model, n_experts, torch.float32, device,
                             scale=0.02),
        "w_up": (randn(gen, (n_experts, d_model, d_ff), device)
                 * scale).to(dtype),
        "w_down": (randn(gen, (n_experts, d_ff, d_model), device)
                   * (1.0 / d_ff ** 0.5)).to(dtype),
    }
    if gated:
        p["w_gate"] = (randn(gen, (n_experts, d_model, d_ff), device)
                       * scale).to(dtype)
    if n_shared > 0:
        sdff = shared_d_ff or d_ff
        p["shared"] = {
            "w_up": dense_init(gen, d_model, n_shared * sdff, dtype, device),
            "w_gate": dense_init(gen, d_model, n_shared * sdff, dtype,
                                 device),
            "w_down": dense_init(gen, n_shared * sdff, d_model, dtype,
                                 device),
        }
    return p


def _capacity(tokens: int, top_k: int, n_experts: int,
              capacity_factor: float) -> int:
    c = max(1, int(round(tokens * top_k / n_experts * capacity_factor)))
    return (c + 7) // 8 * 8


def _route(params, x: torch.Tensor, top_k: int, normalize_gates: bool):
    """fp32 router logits, softmax probs, and the top-k gates and experts
    (descending, as ``jax.lax.top_k``)."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1, sorted=True)
    if normalize_gates:
        gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)
    return logits, probs, gate_vals, expert_ids


def _experts(params, buf: torch.Tensor, act: str) -> torch.Tensor:
    """(E, C, D) -> (E, C, D): each expert's MLP on its rows."""
    a = act_fn(act)
    dt = buf.dtype
    up = torch.bmm(buf, params["w_up"].to(dt))
    if "w_gate" in params:
        h = a(torch.bmm(buf, params["w_gate"].to(dt))) * up
    else:
        h = a(up)
    return torch.bmm(h, params["w_down"].to(dt))


def _shared(params, x: torch.Tensor, act: str) -> torch.Tensor:
    sh = params["shared"]
    g = act_fn(act)(x @ sh["w_gate"].to(x.dtype))
    return (g * (x @ sh["w_up"].to(x.dtype))) @ sh["w_down"].to(x.dtype)


def _aux(logits, probs, expert_ids, n_experts: int, tp=None) -> tuple:
    E = n_experts
    if tp is not None and tp.data_split:
        return _aux_split(logits, probs, expert_ids, E, tp)
    me = torch.mean(probs.reshape(-1, E), dim=0)
    ce = torch.mean(F.one_hot(expert_ids[..., 0].reshape(-1), E).float(),
                    dim=0)
    load_balance = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    flat = expert_ids.reshape(-1)
    load = torch.sum(F.one_hot(flat, E).float(), dim=0) / flat.numel()
    return load_balance, z_loss, load


def _aux_split(logits, probs, expert_ids, E: int, tp) -> tuple:
    """``_aux`` over every data slice's tokens: the sums summed over the
    data group (one collective), then divided by the batch's counts."""
    D = tp.mesh.data_shards
    n = probs.reshape(-1, E).shape[0] * D
    flat = expert_ids.reshape(-1)
    sums = tp.data_sum(torch.cat([
        torch.sum(probs.reshape(-1, E), dim=0),
        torch.sum(F.one_hot(expert_ids[..., 0].reshape(-1), E).float(), 0),
        torch.sum(F.one_hot(flat, E).float(), dim=0),
        torch.sum(torch.square(torch.logsumexp(logits, dim=-1)))[None]]))
    me, ce = sums[:E] / n, sums[E:2 * E] / n
    load = sums[2 * E:3 * E] / (flat.numel() * D)
    return E * torch.sum(me * ce), sums[3 * E] / n, load


def _two_d(tp) -> bool:
    """Whether the expert stacks are split over ("data", "model")
    (``moe_2d``)."""
    if tp is None or "w_up" not in tp.specs:
        return False
    e = tp.specs["w_up"][0]
    return isinstance(e, tuple) and "data" in e


def _local_experts(params, tp) -> tuple:
    """(the first expert this rank holds, how many): all of them unless
    the model axis splits the expert stacks; over ("data", "model") the
    rank's place counts the data axis first."""
    El = params["w_up"].shape[0]
    if tp is None or not tp.split("w_up"):
        return 0, El
    if _two_d(tp):
        return (tp.mesh.fsdp_index * tp.size + tp.index) * El, El
    return tp.index * El, El


def _combine(params, x, y, experts_split: bool, act: str, tp):
    """y (the routed experts' combine, partial when ``experts_split``)
    plus the shared experts, summed over the model group where either is
    a partial sum."""
    if "shared" not in params:
        return tp.sum(y) if experts_split else y
    sh_tp = tp.sub("shared") if tp is not None else None
    sh_split = sh_tp is not None and sh_tp.split("w_down")
    sh = _shared(params, tp.enter(x) if sh_split else x, act)
    if experts_split and sh_split:
        return tp.sum(y + sh)
    if experts_split:
        return tp.sum(y) + sh
    return y + (tp.sum(sh) if sh_split else sh)


# ---------------------------------------------------------------------------
# Experts over ("data", "model") (``moe_2d``): the expert exchange
# ---------------------------------------------------------------------------
# The whole batch's dispatch buffer is (R, E, C, D): R = 1 for the scatter
# dispatch, whose slices fill disjoint cells of one buffer (a slot's rank
# counts the slices before it), so the slices' buffers SUM to it; R = the
# groups for the grouped one, whose slices' groups STACK. A rank holds E /
# (D·M) experts. In: the data group's sum or stack of the slices' buffers
# (nothing when the batch is not split over the slices), cut to the rank's
# experts. Out: every rank's experts' outputs written into a zero-filled
# (R, E, C, D) buffer summed over the world (pod 0's ranks write: the other
# pods hold replicas), cut back to the slice's groups. Each one's backward
# is the other's forward, so both are an all-to-all over the world emulated
# by the zero-filled sum (gloo on CUDA tensors takes only ``all_reduce`` and
# ``broadcast``); every rank of a slice ends with the slice's whole output
# and gradient, the same on its model group.

def _slices_in(t, mesh, mode: str):
    """The whole batch's rows of a slice's (R, ...) ``t``: ``"sum"``, its
    data group's sum; ``"stack"``, their (D·R, ...) stack; ``"none"``, t."""
    if mode == "sum":
        return mesh.data_sum(t.to(torch.float32, copy=True)).to(t.dtype)
    if mode == "stack":
        return mesh.data_stack(t.float()).to(t.dtype).flatten(0, 1)
    return t


def _world_out(t, mesh, mode: str, e0: int, E: int):
    """This rank's experts' (R', El, C, D) ``t`` written into a zero-filled
    (R', E, C, D) buffer at ``e0``, summed over the world, cut to the
    slice's rows (``"stack"``)."""
    buf = t.new_zeros((t.shape[0], E) + tuple(t.shape[2:]),
                      dtype=torch.float32)
    if mesh.first_pod:          # the other pods hold replicas of its experts
        buf[:, e0:e0 + t.shape[1]] = t
    out = mesh.all_reduce(buf).to(t.dtype)
    if mode == "stack":
        R = out.shape[0] // mesh.data_shards
        out = out[mesh.data_index * R:(mesh.data_index + 1) * R]
    return out


class _ExpertsIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, mesh, mode, e0, El):
        ctx.mesh, ctx.mode, ctx.e0, ctx.E = mesh, mode, e0, buf.shape[1]
        return _slices_in(buf, mesh, mode)[:, e0:e0 + El].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _world_out(g, ctx.mesh, ctx.mode, ctx.e0, ctx.E), None, \
            None, None, None


class _ExpertsOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, mesh, mode, e0, E):
        ctx.mesh, ctx.mode, ctx.e0, ctx.El = mesh, mode, e0, out.shape[1]
        return _world_out(out, mesh, mode, e0, E)

    @staticmethod
    def backward(ctx, g):
        g = _slices_in(g, ctx.mesh, ctx.mode)
        return g[:, ctx.e0:ctx.e0 + ctx.El].contiguous(), None, None, \
            None, None


def _experts_2d(params, buf, act: str, tp, mode: str):
    """The rank's experts of the whole batch's (R, E, C, D) buffer, their
    outputs exchanged back: -> the slice's (R, E, C, D) expert outputs,
    whole."""
    mode = mode if tp.data_split else "none"
    e0, El = _local_experts(params, tp)
    E = buf.shape[1]
    if torch.is_grad_enabled() and buf.requires_grad:
        mine = _ExpertsIn.apply(buf, tp.mesh, mode, e0, El)
    else:
        mine = _slices_in(buf, tp.mesh, mode)[:, e0:e0 + El]
    R, _, C, D = mine.shape
    out = _experts(params, mine.transpose(0, 1).reshape(El, R * C, D),
                   act).reshape(El, R, C, D).transpose(0, 1)
    if torch.is_grad_enabled() and out.requires_grad:
        return _ExpertsOut.apply(out.contiguous(), tp.mesh, mode, e0, E)
    return _world_out(out, tp.mesh, mode, e0, E)


def moe_apply(params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu",
              normalize_gates: bool = True, tp=None):
    """x: (B, S, D) -> (y, MoEAux). With ``tp``: the rank's experts (see
    the module's docstring)."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    N = B * S
    xt = x.reshape(N, D)
    logits, probs, gate_vals, expert_ids = _route(params, xt, top_k,
                                                  normalize_gates)
    split_data = tp is not None and tp.data_split
    capacity = _capacity(N * (tp.mesh.data_shards if split_data else 1),
                         top_k, E, capacity_factor)

    # rank of each (token, slot) within its expert: a token-major running
    # count per expert, scanned along contiguous (E, N*k) rows (a scan down
    # the outer dim of (N*k, E) runs E-wide on the card: 15 ms a layer at
    # Granite-MoE's prefill)
    flat_e = expert_ids.reshape(-1)                              # (N*k,)
    onehot = F.one_hot(flat_e, E).T.contiguous()                 # (E, N*k)
    rank = torch.sum(torch.cumsum(onehot, dim=1) * onehot, dim=0) - 1
    if split_data:
        # the slots of the data slices before this one come first
        counts = tp.data_stack(torch.sum(onehot, dim=1))         # (D, E)
        before = torch.sum(counts[:tp.mesh.data_index], dim=0)
        rank = rank + before[flat_e]
    keep = rank < capacity
    safe_rank = torch.where(keep, rank, capacity - 1)

    # this rank's experts e0 .. e0 + El − 1 (all of them without a split;
    # over ("data", "model") every expert, exchanged: ``_experts_2d``)
    two_d = _two_d(tp)
    e0, El = (0, E) if two_d else _local_experts(params, tp)
    split = El < E
    if split:
        mine = (flat_e >= e0) & (flat_e < e0 + El)
        keep = keep & mine
        local_e = torch.where(mine, flat_e - e0, 0)
        # the tokens and their gates enter the rank's experts
        xd, gv = tp.enter(xt), tp.enter(gate_vals)
    else:
        local_e, xd, gv = flat_e, xt, gate_vals

    # scatter tokens into (E, C, D); a dropped slot adds zero to cell C-1
    tok_idx = torch.arange(N, device=x.device).repeat_interleave(top_k)
    src = torch.where(keep[:, None], xd[tok_idx], 0)
    buf = torch.zeros((El, capacity, D), dtype=xt.dtype, device=x.device)
    buf.index_put_((local_e, safe_rank), src, accumulate=True)

    if two_d:
        out_buf = _experts_2d(params, buf[None], act, tp, "sum")[0]
    else:
        out_buf = _experts(params, buf, act)

    # combine back with the gate weights: a token's k slots are rows
    # t·k .. t·k + k − 1, so the combine is a sum over k in a fixed order
    # (an index_add_ adds them with atomics on the card, in any order)
    gathered = out_buf[local_e, safe_rank]                       # (N*k, D)
    w = (gv.reshape(-1) * keep).to(xt.dtype)
    y = (gathered * w[:, None]).reshape(N, top_k, D).sum(1)
    y = _combine(params, xt, y, split, act, tp)
    return y.reshape(B, S, D), MoEAux(*_aux(logits, probs, expert_ids, E,
                                            tp))


def moe_apply_grouped(params, x: torch.Tensor, *, top_k: int,
                      capacity_factor: float = 1.25, act: str = "silu",
                      normalize_gates: bool = True, tp=None):
    """x: (B, S, D) -> (y, MoEAux). Groups = batch rows; each group has
    its own capacity of ``S · k / E · capacity_factor`` (so a data split
    changes no routing). With ``tp``: the rank's experts."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    G, T = B, S
    dev = x.device
    logits, probs, gate_vals, expert_ids = _route(params, x, top_k,
                                                  normalize_gates)
    TK = T * top_k
    C = _capacity(T, top_k, E, capacity_factor)

    flat_e = expert_ids.reshape(G, TK)
    tok_of_slot = (torch.arange(TK, device=dev) // top_k).expand(G, TK)
    order = torch.argsort(flat_e, dim=1, stable=True)            # (G, TK)
    sorted_e = torch.gather(flat_e, 1, order)
    sorted_tok = torch.gather(tok_of_slot, 1, order)

    counts = torch.sum(F.one_hot(flat_e, E), dim=1)              # (G, E)
    starts = torch.cumsum(counts, dim=1) - counts
    rank_sorted = (torch.arange(TK, device=dev)[None, :]
                   - torch.gather(starts, 1, sorted_e))          # (G, TK)
    keep_sorted = rank_sorted < C

    # (G, E, C): which sorted slot fills buffer cell (e, c)
    cells = torch.arange(C, device=dev)[None, None, :]
    src_slot = starts[:, :, None] + cells
    cell_valid = cells < torch.clamp(counts, max=C)[:, :, None]
    slot_idx = torch.clamp(src_slot, 0, TK - 1).reshape(G, E * C)
    tok_for_buf = torch.gather(sorted_tok, 1, slot_idx)          # (G, E*C)
    two_d = _two_d(tp)
    e0, El = (0, E) if two_d else _local_experts(params, tp)
    # the tokens (and below the gates) enter the rank's experts
    xd = tp.enter(x) if El < E else x
    # advanced indexing, not torch.gather: a token fills up to k cells, and
    # gather's backward (scatter_add_) would sum their gradients with
    # atomics on the card; indexing's backward sums them in a fixed order
    buf = xd[torch.arange(G, device=dev)[:, None], tok_for_buf]
    buf = buf * cell_valid.reshape(G, E * C, 1).to(buf.dtype)

    if two_d:
        out_e = _experts_2d(params, buf.reshape(G, E, C, D), act, tp,
                            "stack")
    else:
        ebuf = buf.reshape(G, E, C, D)[:, e0:e0 + El].transpose(0, 1)
        out_e = _experts(params, ebuf.reshape(El, G * C, D),
                         act).reshape(El, G, C, D).transpose(0, 1)
    if El < E:
        # the other ranks' experts read zeros here: their slots add zero
        out_e = torch.cat([out_e.new_zeros((G, e0, C, D)), out_e,
                           out_e.new_zeros((G, E - e0 - El, C, D))], dim=1)
    out_flat = out_e.reshape(G, E * C, D)

    # combine: sorted slots read their buffer cell, then unsort
    dest = sorted_e * C + torch.clamp(rank_sorted, 0, C - 1)     # (G, TK)
    vals_sorted = torch.gather(out_flat, 1, dest[..., None].expand(G, TK, D))
    vals_sorted = vals_sorted * keep_sorted[..., None].to(vals_sorted.dtype)
    inv = torch.argsort(order, dim=1, stable=True)
    vals = torch.gather(vals_sorted, 1, inv[..., None].expand(G, TK, D))
    gv = tp.enter(gate_vals) if El < E else gate_vals
    w = gv.reshape(G, T, top_k).to(vals.dtype)
    y = torch.sum(vals.reshape(G, T, top_k, D) * w[..., None], dim=2)
    y = _combine(params, x, y, El < E, act, tp)
    return y, MoEAux(*_aux(logits, probs, expert_ids, E, tp))
