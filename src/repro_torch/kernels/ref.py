"""Plain PyTorch versions of the ported kernels: what a CPU tensor runs,
and what ``chip_smoke.py`` holds each CUDA kernel against on the card."""
from __future__ import annotations

import torch

_EPS = 1e-12


def cosine_block_ref(dW: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """E[i, j] = <ΔW_i, V_:,j> / max(||ΔW_i|| · max(||V_:,j||, ε), ε).

    dW: (n, d); V: (d, m) -> (n, m) float32 (``repro.kernels.ref
    .cosine_block_ref``, with the column-norm clamp of the Pallas kernel
    ``edc_cosine.py:63-64`` as well as its ``max(·, ε)`` on the product)."""
    dW32 = dW.float()
    V32 = V.float()
    dots = dW32 @ V32
    rn = torch.linalg.norm(dW32, dim=1, keepdim=True)
    cn = torch.clamp(torch.linalg.norm(V32, dim=0, keepdim=True), min=_EPS)
    return dots / torch.clamp(rn * cn, min=_EPS)


def madc_ref(M: torch.Tensor) -> torch.Tensor:
    """MADC(i, j) = Σ_{z≠i,j} |M_iz − M_jz| / max(n−2, 1) (eq. 7): the
    (n, n, n) broadcast of ``repro.core.measures.madc``."""
    M = M.float()
    n = M.shape[0]
    diff = torch.abs(M[:, None, :] - M[None, :, :])       # (n, n, n) over z
    eye = torch.eye(n, dtype=torch.bool, device=M.device)
    excl = eye[:, None, :] | eye[None, :, :]              # z == i or z == j
    s = torch.sum(torch.where(excl, 0.0, diff), dim=-1)
    return s / max(n - 2, 1)


NEG_INF = -1e30


def swa_attention_ref(q, k, v, *, window: int | None, causal: bool = True,
                      scale: float | None = None) -> torch.Tensor:
    """Dense masked softmax attention (``repro.kernels.ref
    .swa_attention_ref``), all in fp32.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H a multiple of KV. Query i
    sits at absolute position i + (Sk − Sq) (decode-tail alignment); a key
    is kept where kpos <= qpos (causal) and kpos > qpos − window. Masked
    scores are −1e30, not −inf. Returns (B, Sq, H, hd) fp32."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = 1.0 / hd ** 0.5
    dev = q.device
    qpos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=dev)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    # kv head j serves heads j·(H/KV) .. (j+1)·(H/KV) − 1 (``jnp.repeat``)
    k32 = k.float().repeat_interleave(H // k.shape[2], dim=2)
    v32 = v.float().repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k32) * scale
    s = torch.where(ok[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v32)


def ssd_intra_chunk_ref(Xc, A_cs, Bc, Cc):
    """Steps 1-2 of the chunked SSD (``repro.models.ssm.ssd_chunked``,
    ``ssm.py:104-110``): the intra-chunk output and each chunk's state.

    Xc (b, c, Q, h, p); A_cs (b, h, c, Q) fp32, the inclusive cumsum of
    dt·A within each chunk; Bc, Cc (b, c, Q, h, n). Returns
    (Y_diag (b, c, Q, h, p) fp32, states (b, c, h, p, n) fp32), where
      Y_diag = (C Bᵀ ⊙ L) X,  L_ij = exp(a_i − a_j) for j <= i, else 0
      state  = Σ_k exp(a_Q − a_k) X_k ⊗ B_k.
    L is a select on −1e30 before the exp, never a 0/1 multiply: for
    j > i, exp(a_i − a_j) overflows and inf·0 would be NaN."""
    Q = A_cs.shape[-1]
    X32, B32, C32 = Xc.float(), Bc.float(), Cc.float()
    diff = A_cs[..., :, None] - A_cs[..., None, :]           # (b,h,c,Q,Q)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=A_cs.device).tril()
    L = torch.exp(torch.where(tril, diff, NEG_INF))
    Y_diag = torch.einsum("bcqhn,bckhn,bhcqk,bckhp->bcqhp", C32, B32, L, X32)
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)            # (b,h,c,Q)
    states = torch.einsum("bckhn,bhck,bckhp->bchpn", B32, decay_states, X32)
    return Y_diag, states


def ssd_chunk_ref(X, dtA, B, C):
    """Single-chunk SSD via the sequential recurrence (``repro.kernels.ref
    .ssd_chunk_ref``): the oracle of the chunked form.

    X: (b, q, h, p); dtA: (b, q, h); B, C: (b, q, h, n).
    Returns (Y (b, q, h, p), final_state (b, h, p, n)), all fp32."""
    b, q, h, p = X.shape
    n = B.shape[-1]
    X32, A32 = X.float(), dtA.float()
    B32, C32 = B.float(), C.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=X.device)
    ys = []
    for t in range(q):
        dec = torch.exp(A32[:, t])[..., None, None]              # (b,h,1,1)
        state = dec * state + torch.einsum("bhp,bhn->bhpn", X32[:, t],
                                           B32[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C32[:, t]))
    return torch.stack(ys, dim=1), state
