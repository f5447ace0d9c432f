"""Mamba2 SSD intra-chunk block: the wrapper around two Hopper kernels that
replace the Pallas kernel ``repro.kernels.ssd_chunk.ssd_intra_chunk``:

- route ``tc``, ``csrc/ssd_chunk_tc.cu``: X, B, C all bf16 with Q = 64 or
  128 and P = N = 64 (Zamba2's prefill). Tensor cores (``wgmma``) fed by
  TMA; C·Bᵀ once per (batch, chunk) when B and C are one group expanded
  over the heads with stride 0, only the causal triangle's tiles; the
  fp32 operands of the two products are split into three bf16 terms, so
  the outputs keep fp32 accuracy (within 2e-4 of the plain version).
- route ``fp32``, ``csrc/ssd_chunk.cu``: every other input (fp32, or
  another Q, P, N). Tensor cores at fp32 accuracy: each fp32 product is
  three TF32 products (``mma.sync``); C·Bᵀ once per CTA for a block of
  heads that share one B/C group (``ssd_heads_per_cta``), only the causal
  triangle's tiles; with one head a CTA, a kernel of its own that builds
  C·Bᵀ and the state in parallel warps.

The route depends on dtype and shape only (``_route``). On the ``tc``
route an input that breaks TMA's rules raises; it never switches route.
``ssd_intra_chunk`` takes the model's chunked layout, as
``repro_torch.models.ssm.ssd_chunked`` holds it, with B and C by group
(b, c, Q, g, n), g dividing h: the forward reads one group as a stride-0
expansion over the heads (a per-head copy only for 1 < g < h);
``ssd_intra_chunk_cells``
takes the Pallas kernel's (BH, NC, Q, ·) layout. Both reach one launch. A
CPU tensor runs the plain version (``kernels.ref.ssd_intra_chunk_ref``),
and so does a ``meta`` tensor (shapes only: the dry run); a CUDA tensor
launches a kernel or raises. ``launches`` counts every launch,
``launches_by_route`` each route's.

The backward (``SsdIntraChunkFn``, ``ssd_intra_chunk_bwd``) is
``csrc/ssd_chunk_bwd.cu`` on the card, one route for bf16 and fp32
(TF32 ``mma.sync`` at fp32 accuracy; a CTA forms C·Bᵀ once for a block
of a group's heads, ``ssd_bwd_heads_per_cta``; dB and dC are summed over
each group's heads in the kernel and written once a group), and
``kernels.ref.ssd_intra_chunk_bwd_ref`` on the CPU; ``launches_bwd``
counts its launches. Without grad the call is exactly the forward above.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0
launches_by_route = {"tc": 0, "fp32": 0}
launches_bwd = 0
_DTYPES = (torch.float32, torch.bfloat16)
MAX_Q, MAX_P, MAX_N = 128, 64, 128
TC_Q, TC_P, TC_N = (64, 128), 64, 64


def _route(dtype_x, dtype_bc, Q: int, P: int, N: int) -> str:
    """``"tc"`` for bf16 X and B/C with Q 64 or 128 and P = N = 64, else
    ``"fp32"``."""
    if (dtype_x == torch.bfloat16 and dtype_bc == torch.bfloat16
            and Q in TC_Q and P == TC_P and N == TC_N):
        return "tc"
    return "fp32"


def ssd_heads_per_cta(b: int, c: int, h: int, per_head: bool,
                      n_sm: int) -> int:
    """Heads per CTA of the fp32 route, which share one C·Bᵀ: 1 when B or C
    differ per head; else the largest power of two (at most h) whose grid
    of b·c·⌈h/hb⌉ CTAs still gives every SM one: 16 at Zamba2's fp32
    prefill (b·c = 64, 64 heads), fewer C·Bᵀ and one wave of CTAs, faster
    there than 8 or 4 on the H100 (PERF.md, from ``chip_smoke.py``'s
    sweep)."""
    if per_head:
        return 1
    hb = 1
    while 2 * hb <= h and b * c * -(-h // (2 * hb)) >= n_sm:
        hb *= 2
    return hb


def ssd_bwd_heads_per_cta(b: int, c: int, g: int, rep: int,
                          n_sm: int) -> int:
    """Heads per CTA of the backward's first kernel, all of one B/C group
    (``rep`` = h/g heads each), which share one C·Bᵀ: the largest power of
    two dividing ``rep`` whose grid of b·c·g·rep/hb CTAs still gives every
    SM one (16 at Zamba2's training shape: b·c = 64, one group of 64
    heads, 256 CTAs)."""
    hb = 1
    while rep % (2 * hb) == 0 and b * c * g * (rep // (2 * hb)) >= n_sm:
        hb *= 2
    return hb


def _group_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """B or C by group (b, c, Q, g, n) -> by head (b, c, Q, h, n) for the
    forward kernels: itself for g = h, a stride-0 view for g = 1, a copy
    (head j reads group j // (h/g)) otherwise."""
    g = t.shape[3]
    if g == h:
        return t
    if g == 1:
        return t.expand(*t.shape[:3], h, t.shape[4])
    return t.repeat_interleave(h // g, dim=3)


def _check_groups(name: str, Xc, A_cs, Bc, Cc):
    if Xc.ndim != 5 or Bc.ndim != 5:
        raise ValueError(f"{name}: X {tuple(Xc.shape)}, B {tuple(Bc.shape)}"
                         "; want X (b, c, Q, h, p) and B, C (b, c, Q, g, n)")
    b, c, Q, h, p = Xc.shape
    g, n = Bc.shape[3], Bc.shape[4]
    if (Bc.shape[:3] != (b, c, Q) or Cc.shape != Bc.shape or g < 1
            or h % g or A_cs.shape != (b, h, c, Q)):
        raise ValueError(f"{name}: X {tuple(Xc.shape)}, A_cs "
                         f"{tuple(A_cs.shape)}, B {tuple(Bc.shape)}, C "
                         f"{tuple(Cc.shape)}; want X (b, c, Q, h, p), "
                         "A_cs (b, h, c, Q), B and C (b, c, Q, g, n) with g "
                         "dividing h")
    return b, c, Q, h, p, g, n


def _tma_strides(name: str, t: torch.Tensor, ndims: int,
                 broadcast: int | None = None) -> tuple:
    """t's element strides of its first ``ndims`` dims for a tensor map
    (``build.tma_strides`` checks TMA's rules; a stride-0 head expansion,
    dim ``broadcast``, is read as one head)."""
    return build.tma_strides("ssd_intra_chunk", name, t, ndims, broadcast)


def _per_head(t: torch.Tensor) -> int:
    """1 when B or C differs per head, 0 for one group expanded with
    stride 0 (or one head)."""
    return int(t.shape[3] > 1 and t.stride(3) != 0)


def _plan(Xc, A_cs, Bc, Cc, heads_per_cta) -> tuple:
    """Checks a call's signature and returns what every call with it
    launches: ``("cpu",)``; ``("tc",)``; or ``("fp32", params, Y shape,
    S shape)``, params the C launcher's constant arguments."""
    b, c, Q, h, p = Xc.shape
    n = Bc.shape[-1]
    if (Bc.shape != (b, c, Q, h, n) or Cc.shape != Bc.shape
            or A_cs.shape != (b, h, c, Q)):
        raise ValueError(f"ssd_intra_chunk: X {tuple(Xc.shape)}, A_cs "
                         f"{tuple(A_cs.shape)}, B {tuple(Bc.shape)}, C "
                         f"{tuple(Cc.shape)}; want X (b, c, Q, h, p), A_cs "
                         "(b, h, c, Q), B and C (b, c, Q, h, n)")
    devs = {t.device for t in (Xc, A_cs, Bc, Cc)}
    if ref.runs_plain(Xc, A_cs, Bc, Cc):
        return ("cpu",)
    if len(devs) != 1 or Xc.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk: inputs on "
                         f"{sorted(map(str, devs))}; all must be on one CUDA "
                         "device (or the CPU)")
    if (Xc.dtype not in _DTYPES or Bc.dtype != Xc.dtype
            or Cc.dtype != Xc.dtype or A_cs.dtype != torch.float32):
        raise TypeError(f"ssd_intra_chunk: X, B, C {Xc.dtype}, {Bc.dtype}, "
                        f"{Cc.dtype} (fp32 or bf16, alike) and A_cs "
                        f"{A_cs.dtype} (fp32)")
    if not (0 < Q <= MAX_Q and 0 < p <= MAX_P and 0 < n <= MAX_N) or \
            b * c * h == 0 or b * c * h >= 2 ** 31:
        raise ValueError(f"ssd_intra_chunk: Q={Q}, P={p}, N={n}, cells="
                         f"{b * c * h} outside the kernel's range (Q <= "
                         f"{MAX_Q}, P <= {MAX_P}, N <= {MAX_N})")
    if any(t.stride(-1) != 1 for t in (Xc, Bc, Cc)):
        raise ValueError("ssd_intra_chunk: the last dim of X, B, C must be "
                         "contiguous")
    if _route(Xc.dtype, Bc.dtype, Q, p, n) == "tc":
        if h > 65535:
            raise ValueError(f"ssd_intra_chunk: h={h} heads outside the "
                             "bf16 route's range (<= 65535)")
        return ("tc",)
    per_head = bool(_per_head(Bc) or _per_head(Cc))
    if heads_per_cta is None:
        hb = ssd_heads_per_cta(b, c, h, per_head,
                               build.sm_count(Xc.device.index))
    elif 0 < heads_per_cta <= h and (heads_per_cta == 1 or not per_head):
        hb = heads_per_cta
    else:
        raise ValueError(f"ssd_intra_chunk: heads_per_cta={heads_per_cta} "
                         f"with h={h}, B/C per head {per_head} (1 <= it <= "
                         "h, and 1 when B or C differ per head)")
    y_st = (c * Q * h * p, Q * h * p, h * p, p)       # Y, S contiguous
    s_st = (c * h * p * n, h * p * n, p * n, n, 1)
    prm = build.strides(Xc.stride()[:4], A_cs.stride(), Bc.stride()[:4],
                        Cc.stride()[:4], y_st, s_st,
                        (b, c, Q, h, p, n, int(Xc.dtype == torch.bfloat16),
                         hb))
    return ("fp32", prm, (b, c, Q, h, p), (b, c, h, p, n))


_plans: dict = {}


def ssd_intra_chunk(Xc: torch.Tensor, A_cs: torch.Tensor, Bc: torch.Tensor,
                    Cc: torch.Tensor, heads_per_cta: int | None = None):
    """Xc (b, c, Q, h, p); A_cs (b, h, c, Q) fp32, the inclusive cumsum of
    dt·A within each chunk; Bc, Cc (b, c, Q, g, n), g dividing h (head j
    reads group j // (h/g); g = h is one B/C a head, which may be a
    stride-0 expansion). Any strides with the last dim contiguous.
    Returns (Y_diag (b, c, Q, h, p) fp32, states (b, c, h, p, n) fp32).
    ``heads_per_cta`` overrides ``ssd_heads_per_cta`` on the fp32 route
    (the sweep in ``chip_smoke.py`` that sets it). A signature (shapes,
    strides, dtypes, devices) is checked and planned once; later calls
    with it only allocate and launch. With grad enabled and an input that
    requires it, the call goes through ``SsdIntraChunkFn`` (the same
    forward; its backward is ``ssd_intra_chunk_bwd``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (Xc, A_cs, Bc, Cc)):
        return SsdIntraChunkFn.apply(Xc, A_cs, Bc, Cc, heads_per_cta)
    return _forward(Xc, A_cs, Bc, Cc, heads_per_cta)


def _forward(Xc, A_cs, Bc, Cc, heads_per_cta):
    """The forward kernels (or the plain version) on B and C by head (a
    call with one B/C a head goes straight to them)."""
    if Bc.ndim == 5 and Xc.ndim == 5 and Bc.shape[3] != Xc.shape[3]:
        _check_groups("ssd_intra_chunk", Xc, A_cs, Bc, Cc)
        h = Xc.shape[3]
        Bc, Cc = _group_heads(Bc, h), _group_heads(Cc, h)
    return _forward_heads(Xc, A_cs, Bc, Cc, heads_per_cta)


def _forward_heads(Xc, A_cs, Bc, Cc, heads_per_cta):
    key = (Xc.shape, Bc.shape, Cc.shape, A_cs.shape, Xc.stride(),
           A_cs.stride(), Bc.stride(), Cc.stride(), Xc.dtype, Bc.dtype,
           Cc.dtype, A_cs.dtype, Xc.device, A_cs.device, Bc.device,
           Cc.device, heads_per_cta)
    plan = _plans.get(key)
    if plan is None:
        plan = _plan(Xc, A_cs, Bc, Cc, heads_per_cta)
        if len(_plans) >= 512:
            _plans.clear()
        _plans[key] = plan
    route = plan[0]
    if route == "cpu":
        return ref.ssd_intra_chunk_ref(Xc, A_cs, Bc, Cc)
    lib = build.library()
    if route == "fp32":
        _, prm, y_shape, s_shape = plan
        Y = torch.empty(y_shape, dtype=torch.float32, device=Xc.device)
        S = torch.empty(s_shape, dtype=torch.float32, device=Xc.device)
        err = build.launch(Xc, lib.ssd_intra_chunk_launch, Xc.data_ptr(),
                           A_cs.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                           Y.data_ptr(), S.data_ptr(), prm)
    else:
        b, c, Q, h, p = Xc.shape
        n = Bc.shape[-1]
        tma = (_tma_strides("X", Xc, 4), _tma_strides("A_cs", A_cs, 3),
               _tma_strides("B", Bc, 4, broadcast=3),
               _tma_strides("C", Cc, 4, broadcast=3))
        Y = torch.empty((b, c, Q, h, p), dtype=torch.float32,
                        device=Xc.device)
        S = torch.empty((b, c, h, p, n), dtype=torch.float32,
                        device=Xc.device)
        st = build.strides(*tma, Y.stride()[:4], S.stride())
        err = build.launch(Xc, lib.ssd_intra_chunk_tc_launch, Xc.data_ptr(),
                           A_cs.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                           Y.data_ptr(), S.data_ptr(), st, b, c, Q, h,
                           _per_head(Bc), _per_head(Cc))
        if err < 0:
            raise RuntimeError("ssd_intra_chunk: cuTensorMapEncodeTiled "
                               f"refused a tensor map (CUresult {-err})")
    build.check(err, f"ssd_intra_chunk launch ({route} route)")
    global launches
    launches += 1
    launches_by_route[route] += 1
    return Y, S


class SsdIntraChunkFn(torch.autograd.Function):
    """``ssd_intra_chunk`` with a backward: the forward is the kernel (or
    the plain version on the CPU) as without grad; it saves its inputs (B
    and C by group), and the backward is ``ssd_intra_chunk_bwd``. Gradients
    come back in the inputs' dtypes, dB and dC one a group."""

    @staticmethod
    def forward(ctx, Xc, A_cs, Bc, Cc, heads_per_cta):
        Y, S = _forward(Xc, A_cs, Bc, Cc, heads_per_cta)
        ctx.save_for_backward(Xc, A_cs, Bc, Cc)
        return Y, S

    @staticmethod
    def backward(ctx, dY, dS):
        Xc, A_cs, Bc, Cc = ctx.saved_tensors
        dX, dA, dB, dC = ssd_intra_chunk_bwd(Xc, A_cs, Bc, Cc, dY, dS)
        return (dX.to(Xc.dtype), dA.to(A_cs.dtype), dB.to(Bc.dtype),
                dC.to(Cc.dtype), None)


def ssd_intra_chunk_bwd(Xc: torch.Tensor, A_cs: torch.Tensor,
                        Bc: torch.Tensor, Cc: torch.Tensor,
                        dY: torch.Tensor, dS: torch.Tensor):
    """The gradients (dX, dA_cs, dB, dC), all fp32, of ``ssd_intra_chunk``
    at its inputs, given the gradients dY (b, c, Q, h, p) and dS
    (b, c, h, p, n) of its two outputs; B, C and so dB, dC by group
    (b, c, Q, g, n). A CPU tensor runs the plain version
    (``kernels.ref.ssd_intra_chunk_bwd_ref``); a CUDA tensor launches
    ``csrc/ssd_chunk_bwd.cu`` (two kernels: per block of a group's heads,
    ``ssd_bwd_heads_per_cta``, then per group; no atomics) or raises.
    ``launches_bwd`` counts its calls on the card."""
    b, c, Q, h, p = Xc.shape
    n = Bc.shape[-1] if Bc.ndim == 5 else 0
    if (Xc.ndim != 5 or Bc.ndim != 5 or dY.shape != Xc.shape
            or dS.shape != (b, c, h, p, n)):
        raise ValueError(f"ssd_intra_chunk_bwd: X {tuple(Xc.shape)}, B "
                         f"{tuple(Bc.shape)}, dY {tuple(dY.shape)}, dS "
                         f"{tuple(dS.shape)}; want X and dY (b, c, Q, h, "
                         "p), B and C (b, c, Q, g, n), dS (b, c, h, p, n)")
    g = _check_groups("ssd_intra_chunk_bwd", Xc, A_cs, Bc, Cc)[5]
    devs = {t.device for t in (Xc, A_cs, Bc, Cc, dY, dS)}
    if ref.runs_plain(Xc, A_cs, Bc, Cc, dY, dS):
        return ref.ssd_intra_chunk_bwd_ref(Xc, A_cs, Bc, Cc, dY, dS)
    if len(devs) != 1 or Xc.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk_bwd: inputs on "
                         f"{sorted(map(str, devs))}; all must be on one "
                         "CUDA device (or the CPU)")
    if (Xc.dtype not in _DTYPES or Bc.dtype != Xc.dtype
            or Cc.dtype != Xc.dtype or A_cs.dtype != torch.float32):
        raise TypeError(f"ssd_intra_chunk_bwd: X, B, C {Xc.dtype}, "
                        f"{Bc.dtype}, {Cc.dtype} (fp32 or bf16, alike) and "
                        f"A_cs {A_cs.dtype} (fp32)")
    if not (0 < Q <= MAX_Q and 0 < p <= MAX_P and 0 < n <= MAX_N) or \
            b * c * h == 0 or b * c * h >= 2 ** 31:
        raise ValueError(f"ssd_intra_chunk_bwd: Q={Q}, P={p}, N={n}, cells="
                         f"{b * c * h} outside the kernel's range (Q <= "
                         f"{MAX_Q}, P <= {MAX_P}, N <= {MAX_N})")
    if any(t.stride(-1) != 1 for t in (Xc, Bc, Cc)):
        raise ValueError("ssd_intra_chunk_bwd: the last dim of X, B, C must "
                         "be contiguous")
    rep = h // g
    hb = ssd_bwd_heads_per_cta(b, c, g, rep, build.sm_count(Xc.device.index))
    dY = dY.float().contiguous()
    dS = dS.float().contiguous()
    dev = Xc.device
    lib = build.library()
    dX = torch.empty((b, c, Q, h, p), dtype=torch.float32, device=dev)
    dA = torch.empty((b, h, c, Q), dtype=torch.float32, device=dev)
    dB = torch.empty((b, c, Q, g, n), dtype=torch.float32, device=dev)
    dC = torch.empty_like(dB)
    # each first-kernel CTA's Σ_h Wᵀ, summed per group by the second
    part = torch.empty(b * c * g * (rep // hb)
                       * lib.ssd_intra_chunk_bwd_part_floats(),
                       dtype=torch.float32, device=dev)
    st = build.strides(Xc.stride()[:4], Bc.stride()[:4], Cc.stride()[:4],
                       A_cs.stride())
    err = build.launch(Xc, lib.ssd_intra_chunk_bwd_launch, Xc.data_ptr(),
                       A_cs.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                       dY.data_ptr(), dS.data_ptr(), dX.data_ptr(),
                       dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                       part.data_ptr(), st, b, c, Q, h, g, p, n, hb,
                       int(Xc.dtype == torch.bfloat16))
    build.check(err, "ssd_intra_chunk_bwd launch")
    global launches_bwd
    launches_bwd += 1
    return dX, dA, dB, dC


def ssd_intra_chunk_cells(X: torch.Tensor, A_cs: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor):
    """The Pallas kernel's layout: X (BH, NC, Q, P); A_cs (BH, NC, Q);
    B, C (BH, NC, Q, N). Returns (Y_diag (BH, NC, Q, P) fp32,
    states (BH, NC, N, P) fp32) — states as (N, P) per cell, a transposed
    view of the (P, N) the model's layout gives."""
    Y, S = ssd_intra_chunk(X[:, :, :, None], A_cs[:, None], B[:, :, :, None],
                           C[:, :, :, None])
    return Y[:, :, :, 0], S[:, :, 0].transpose(-1, -2)
