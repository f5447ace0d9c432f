"""Plain PyTorch versions of the ported kernels: what a CPU tensor runs
(and a ``meta`` tensor, shapes only, as the dry run builds them), and what
``chip_smoke.py`` holds each CUDA kernel against on the card."""
from __future__ import annotations

import torch

EPS = _EPS = 1e-12
_PLAIN = {torch.device("cpu"), torch.device("meta")}


def runs_plain(*tensors: torch.Tensor) -> bool:
    """Whether a wrapper runs its plain version: every tensor on the CPU,
    or every one on ``meta``; anything else is the kernel's or raises."""
    devs = {t.device for t in tensors}
    return len(devs) == 1 and devs <= _PLAIN


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


def cosine_sums_ref(dW: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """The plain version of ``edc_cosine_partial``: ``[dots (n, m) | row
    sums of squares (n) | V's column sums of squares (m)]`` of a d-block,
    packed, in fp32, nothing divided. Summed over the blocks of d and
    finished by ``kernels.edc_cosine.cosine_from_sums`` it is
    ``cosine_block_ref`` of the whole."""
    dW32 = dW.float()
    V32 = V.float()
    return torch.cat([(dW32 @ V32).reshape(-1),
                      torch.sum(dW32 * dW32, dim=1),
                      torch.sum(V32 * V32, dim=0)])


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


def _f32(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or float64 left as it is (a gradcheck's inputs)."""
    return x if x.dtype == torch.float64 else x.float()


def _swa_kept(Sq: int, Sk: int, window, causal: bool, device):
    """(Sq, Sk) bool: query i (at position i + Sk − Sq) keeps key j."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


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
    ok = _swa_kept(Sq, Sk, window, causal, q.device)
    # kv head j serves heads j·(H/KV) .. (j+1)·(H/KV) − 1 (``jnp.repeat``)
    k32 = _f32(k).repeat_interleave(H // k.shape[2], dim=2)
    v32 = _f32(v).repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", _f32(q), k32) * scale
    s = torch.where(ok[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v32)


def swa_attention_bwd_ref(q, k, v, o, do, *, window: int | None,
                          causal: bool = True, scale: float | None = None,
                          rounded: bool = False):
    """The backward of ``swa_attention_ref`` written out, as the kernels
    compute it: the row log-sum-exp is recomputed from q and k,
    P = exp(S − lse) (0 where masked), D_i = Σ_d dO_i·O_i,
    dS = P ⊙ (dP − D) with dP = dO Vᵀ, then dQ = scale·dS K,
    dK = scale·dSᵀ Q and dV = Pᵀ dO, dK and dV summed over the H/KV query
    heads of each kv head.

    ``rounded`` rounds where the ``tc`` route (``csrc/swa_attention_bwd_tc
    .cu``) rounds: dO to bf16 before every use (D too), and P and dS to
    bf16 before the products that take them (dV, dK, dQ); every product of
    bf16 values is exact in fp32 and every sum fp32, as on the tensor
    cores. Without it everything is fp32 (``csrc/swa_attention_bwd.cu``).

    q, o, do: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); o is the forward's
    output. Returns (dq, dk, dv) in fp32 (float64 inputs stay float64)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / hd ** 0.5
    ok = _swa_kept(Sq, Sk, window, causal, q.device)
    q32, o32 = _f32(q), _f32(o)
    do32 = _f32(do.to(torch.bfloat16) if rounded else do)
    k32 = _f32(k).repeat_interleave(G, dim=2)
    v32 = _f32(v).repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    s = torch.where(ok[None, None], s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    d_row = torch.sum(do32 * o32, dim=-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = p * (dp - d_row)
    if rounded:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    return (dq, dk.reshape(B, Sk, KV, G, hd).sum(3),
            dv.reshape(B, Sk, KV, G, hd).sum(3))


def _ssd_heads(t, h: int):
    """B or C by group (b, c, Q, g, n) -> by head (b, c, Q, h, n): head j
    reads group j // (h/g), as ``mamba2_fwd``'s expansion does."""
    g = t.shape[3]
    if h % g:
        raise ValueError(f"ssd_intra_chunk: {g} B/C groups do not divide "
                         f"{h} heads")
    return t if g == h else t.repeat_interleave(h // g, dim=3)


def _ssd_groups(t, g: int):
    """A per-head gradient (b, c, Q, h, n) summed over each group's heads
    -> (b, c, Q, g, n)."""
    b, c, Q, h, n = t.shape
    return t if g == h else t.reshape(b, c, Q, g, h // g, n).sum(4)


def ssd_intra_chunk_ref(Xc, A_cs, Bc, Cc):
    """Steps 1-2 of the chunked SSD (``repro.models.ssm.ssd_chunked``,
    ``ssm.py:104-110``): the intra-chunk output and each chunk's state.

    Xc (b, c, Q, h, p); A_cs (b, h, c, Q) fp32, the inclusive cumsum of
    dt·A within each chunk; Bc, Cc (b, c, Q, g, n), g dividing h (head j
    reads group j // (h/g); g = h is one B/C a head). Returns
    (Y_diag (b, c, Q, h, p) fp32, states (b, c, h, p, n) fp32), where
      Y_diag = (C Bᵀ ⊙ L) X,  L_ij = exp(a_i − a_j) for j <= i, else 0
      state  = Σ_k exp(a_Q − a_k) X_k ⊗ B_k.
    L is a select on −1e30 before the exp, never a 0/1 multiply: for
    j > i, exp(a_i − a_j) overflows and inf·0 would be NaN."""
    h = Xc.shape[3]
    X32 = _f32(Xc)
    B32, C32 = (_ssd_heads(_f32(t), h) for t in (Bc, Cc))
    L, tril = _ssd_L(A_cs)
    Y_diag = torch.einsum("bcqhn,bckhn,bhcqk,bckhp->bcqhp", C32, B32, L, X32)
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)            # (b,h,c,Q)
    states = torch.einsum("bckhn,bhck,bckhp->bchpn", B32, decay_states, X32)
    return Y_diag, states


def _ssd_L(A_cs):
    """(L (b,h,c,Q,Q), the causal mask (Q,Q)): L_ij = exp(a_i − a_j) for
    j <= i, else 0, by a select on −1e30 before the exp."""
    Q = A_cs.shape[-1]
    diff = A_cs[..., :, None] - A_cs[..., None, :]           # (b,h,c,Q,Q)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=A_cs.device).tril()
    return torch.exp(torch.where(tril, diff, NEG_INF)), tril


def ssd_intra_chunk_bwd_ref(Xc, A_cs, Bc, Cc, dY, dS):
    """The backward of ``ssd_intra_chunk_ref`` written out, per (batch,
    chunk, head) cell, with each group's dB and dC summed over its heads as
    the kernel ``csrc/ssd_chunk_bwd.cu`` sums them. With G = C Bᵀ,
    M = G ⊙ L, dM = dY Xᵀ (kept where j <= i), W = dM ⊙ L and
    decay_k = exp(a_Q − a_k):
      dX = Mᵀ dY + decay ⊙ (B dSᵀ)
      dC = W B
      dB = Wᵀ C + decay ⊙ (X dS)
      dA_cs = rowsum(dM ⊙ M) − colsum(dM ⊙ M) − h, plus Σ h at the last
              position, with h_k = decay_k · X_kᵀ dS B_k (the state's).
    L keeps its select on −1e30 before the exp here too: exp(a_i − a_j)
    for j > i overflows, and inf · 0 would be NaN.

    Xc (b, c, Q, h, p), A_cs (b, h, c, Q), Bc, Cc (b, c, Q, g, n); dY
    (b, c, Q, h, p) and dS (b, c, h, p, n), the gradients of Y_diag and of
    the states. Returns (dX, dA_cs, dB, dC) in fp32 (float64 stays), dB
    and dC (b, c, Q, g, n): one gradient a group."""
    h, g = Xc.shape[3], Bc.shape[3]
    X32 = _f32(Xc)
    B32, C32 = (_ssd_heads(_f32(t), h) for t in (Bc, Cc))
    A = _f32(A_cs)
    dY32, dS32 = _f32(dY), _f32(dS)
    L, tril = _ssd_L(A)
    G = torch.einsum("bcihn,bcjhn->bhcij", C32, B32)
    M = G * L
    dM = torch.where(tril, torch.einsum("bcihp,bcjhp->bhcij", dY32, X32),
                     0.0)
    W = dM * L
    decay = torch.exp(A[..., -1:] - A).permute(0, 2, 3, 1)[..., None]
    U = torch.einsum("bckhn,bchpn->bckhp", B32, dS32)         # B dSᵀ
    dX = torch.einsum("bhcij,bcihp->bcjhp", M, dY32) + decay * U
    dC = torch.einsum("bhcij,bcjhn->bcihn", W, B32)
    dB = (torch.einsum("bhcij,bcihn->bcjhn", W, C32)
          + decay * torch.einsum("bckhp,bchpn->bckhn", X32, dS32))
    T = dM * M
    hk = (decay * torch.sum(X32 * U, dim=-1, keepdim=True))[..., 0]
    hk = hk.permute(0, 3, 1, 2)                                # (b,h,c,Q)
    dA = T.sum(-1) - T.sum(-2) - hk
    dA[..., -1] += hk.sum(-1)
    return dX, dA, _ssd_groups(dB, g), _ssd_groups(dC, g)


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
