"""Sliding-window flash attention, forward: the wrapper around two Hopper
kernels that replace the Pallas kernel
``repro.kernels.swa_attention.swa_attention``:

- route ``tc``, ``csrc/swa_attention_tc.cu``: q, k, v all bf16 with head
  dim 64 or 128 (Zamba2's prefill). Tensor cores (``wgmma``) fed by TMA;
  P is rounded to bf16 before P·V, as the JAX zoo's ``sdpa`` does, so it
  agrees with the plain version within 1e-2.
- route ``fp32``, ``csrc/swa_attention.cu``: every other input (fp32,
  mixed fp32/bf16 q vs k/v, or another head dim up to 256). Tensor cores
  at fp32 accuracy: each fp32 product is three TF32 products (``mma.sync``,
  big·big + big·small + small·big); within 3e-5. Where the grid of
  (128-row query tile, batch·head) CTAs would not fill the card, the key
  range of a query tile is split over CTAs (``swa_plan``) and a second
  kernel combines the partials, which live in a workspace kept per device
  and stream (``_workspace``).

The route depends on dtype and head dim only (``_route``). On the ``tc``
route an input that breaks TMA's rules raises; it never switches route. A
CPU tensor runs the plain version (``kernels.ref.swa_attention_ref``), and
so does a ``meta`` tensor (shapes only: the dry run); a CUDA tensor
launches a kernel or raises. ``launches`` counts every launch,
``launches_by_route`` each route's.

The backward (``SwaAttentionFn``, ``swa_attention_bwd``) has two routes
of its own, picked by ``_bwd_route`` from the dtypes alone:

- route ``tc``, ``csrc/swa_attention_bwd_tc.cu``: q, k, v all bf16, any
  head dim up to 256 (padded to a multiple of 16 in shared memory).
  ``mma.sync`` bf16 tensor cores with fp32 accumulators; dO is cast to
  bf16 once here, and P and dS are rounded to bf16 before their products,
  as SDPA's backward rounds (``kernels.ref.swa_attention_bwd_ref(...,
  rounded=True)`` is its plain version). With H > KV each query head's
  dK / dV goes to a workspace that a last kernel sums per kv head.
- route ``fp32``, ``csrc/swa_attention_bwd.cu``: fp32 or mixed inputs
  (the smoke variants' fp32 training steps); SIMT fp32.

A CPU (or ``meta``) tensor runs ``kernels.ref.swa_attention_bwd_ref``; a
CUDA tensor
launches its route or raises, never the other route. ``launches_bwd``
counts every backward launch, ``launches_bwd_by_route`` each route's.
Without grad the call is exactly the forward above.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref

launches = 0
launches_by_route = {"tc": 0, "fp32": 0}
launches_bwd = 0
launches_bwd_by_route = {"tc": 0, "fp32": 0}
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 128)
BLOCK_Q = 128           # fp32 route: query rows per CTA (8 warps of 16)
MAX_SPLIT = 64          # fp32 route: the most chunks of one query tile


def block_k(hd: int) -> int:
    """The fp32 route's key tile: 64 keys at hd <= 64, 32 to 192, else 16
    (the kernel's ``block_k`` of the padded head dim 64·⌈hd/64⌉)."""
    return 64 if hd <= 64 else 32 if hd <= 192 else 16


def key_tiles(qt: int, Sq: int, Sk: int, bk: int, window, causal) -> tuple:
    """Key tiles [lo, hi) that hold a kept key for some row of query tile
    qt, as the kernel's ``tile_range`` computes them (at least one)."""
    off, q0 = Sk - Sq, qt * BLOCK_Q
    pmin, pmax = q0 + off, min(q0 + BLOCK_Q, Sq) - 1 + off
    k_lo = max(0, pmin - window + 1) if window else 0
    k_hi = min(Sk, pmax + 1) if causal else Sk
    lo = k_lo // bk
    return lo, max(lo + 1, -(-k_hi // bk))


@functools.lru_cache(maxsize=256)
def swa_plan(BH: int, Sq: int, Sk: int, hd: int, window, causal: bool,
             n_sm: int) -> tuple:
    """(chunk, nsplit) for the fp32 route: each CTA walks at most ``chunk``
    key tiles of its query tile; ``nsplit`` is the most chunks of any query
    tile (1: no split, no combine). The grid of whole query tiles is kept
    when it holds two CTAs per SM; otherwise the chunk is halved, from the
    longest tile range down, until it does (or is one tile, or a query
    tile would have more than ``MAX_SPLIT`` chunks), so the tile on the
    diagonal no longer sets the time."""
    bk = block_k(hd)
    spans = [hi - lo for lo, hi in (key_tiles(qt, Sq, Sk, bk, window, causal)
                                    for qt in range(-(-Sq // BLOCK_Q)))]
    chunk, target = max(spans), 2 * n_sm
    while (chunk > 1 and BH * sum(-(-n // chunk) for n in spans) < target
           and -(-max(spans) // -(-chunk // 2)) <= MAX_SPLIT):
        chunk = -(-chunk // 2)
    return chunk, max(-(-n // chunk) for n in spans)


def _route(dtype_q, dtype_kv, hd: int) -> str:
    """``"tc"`` for bf16 q and k/v with hd 64 or 128, else ``"fp32"``."""
    if (dtype_q == torch.bfloat16 and dtype_kv == torch.bfloat16
            and hd in TC_HEAD_DIMS):
        return "tc"
    return "fp32"


def _bwd_route(dtype_q, dtype_kv, hd: int) -> str:
    """The backward's route: ``"tc"`` for bf16 q and k/v at any head dim up
    to ``MAX_HEAD_DIM``, else ``"fp32"``."""
    if (dtype_q == torch.bfloat16 and dtype_kv == torch.bfloat16
            and 0 < hd <= MAX_HEAD_DIM):
        return "tc"
    return "fp32"


def _tma_strides(name: str, t: torch.Tensor) -> tuple:
    """t's (b, s, h) element strides for a tensor map (``build.tma_strides``
    checks TMA's rules)."""
    return build.tma_strides("swa_attention", name, t, 3)


def _check_shapes(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"swa_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want q "
                         "(B, Sq, H, hd) and k, v (B, Sk, KV, hd)")
    B, Sq, H, hd = q.shape
    _, Sk, KV, hdk = k.shape
    if k.shape[0] != B or hdk != hd or KV < 1 or H % KV:
        raise ValueError(f"swa_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (H a multiple of "
                         "KV, same B and hd)")
    if Sq > Sk or Sq == 0:
        raise ValueError(f"swa_attention: Sq={Sq} queries against Sk={Sk} "
                         "keys; the queries are the last Sq positions, so "
                         "0 < Sq <= Sk")
    if window is not None and window < 1:
        raise ValueError(f"swa_attention: window={window} keeps no key")


def _plan(q, k, v, window, causal) -> tuple:
    """Checks a call's signature and returns what every call with it
    launches: ``("cpu",)``; ``("tc",)``; or ``("fp32", params, partial
    floats, out shape)``, params the C launcher's constant arguments (no
    partials without a split)."""
    _check_shapes(q, k, v, window)
    devs = {q.device, k.device, v.device}
    if ref.runs_plain(q, k, v):
        return ("cpu",)
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"swa_attention: q, k, v on {sorted(map(str, devs))}"
                         "; all must be on one CUDA device (or the CPU)")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"swa_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; fp32 or bf16, k and v alike")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM or B * H > 65535:
        raise ValueError(f"swa_attention: hd={hd}, B·H={B * H} outside the "
                         f"kernel's range (hd <= {MAX_HEAD_DIM}, "
                         "B·H <= 65535)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("swa_attention: the head dim of q, k, v must be "
                         "contiguous")
    route = _route(q.dtype, k.dtype, hd)
    if route == "tc":
        return ("tc",)
    chunk, nsplit = swa_plan(B * H, Sq, Sk, hd, window, bool(causal),
                             build.sm_count(q.device.index))
    nfloats = 0
    if nsplit > 1:
        nfloats = build.library().swa_attention_part_floats(B, H, Sq, hd,
                                                            nsplit)
    prm = build.strides(q.stride()[:3], k.stride()[:3], v.stride()[:3],
                        (Sq * H * hd, H * hd, hd),
                        (B, Sq, Sk, H, KV, hd, window or 0, int(causal),
                         int(q.dtype == torch.bfloat16),
                         int(k.dtype == torch.bfloat16), chunk, nsplit))
    return ("fp32", prm, nfloats, (B, Sq, H, hd))


_plans: dict = {}
_workspaces: dict = {}


def _workspace(device: torch.device, floats: int) -> int:
    """The partials of a split launch: one buffer per device and stream,
    grown when a plan needs more (the launches of one stream use it in
    order; the caching allocator keeps a freed one until they are done)."""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
        _workspaces[key] = ws
    return ws.data_ptr()


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int | None = None,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), fp32 or bf16 ->
    (B, Sq, H, hd) fp32. Query i sits at absolute position i + (Sk − Sq);
    the window keeps keys with kpos > qpos − window. A signature (shapes,
    strides, dtypes, devices, window, causal) is checked and planned once;
    later calls with it only allocate and launch. With grad enabled and an
    input that requires it, the call goes through ``SwaAttentionFn``
    (the same forward; its backward is ``swa_attention_bwd``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return SwaAttentionFn.apply(q, k, v, window, causal)
    return _forward(q, k, v, window, causal)


def _forward(q, k, v, window, causal) -> torch.Tensor:
    key = (q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
           q.dtype, k.dtype, v.dtype, q.device, k.device, v.device, window,
           causal)
    plan = _plans.get(key)
    if plan is None:
        plan = _plan(q, k, v, window, causal)
        if len(_plans) >= 512:
            _plans.clear()
        _plans[key] = plan
    route = plan[0]
    if route == "cpu":
        return ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    lib = build.library()
    if route == "fp32":
        _, prm, nfloats, shape = plan
        out = torch.empty(shape, dtype=torch.float32, device=q.device)
        part = _workspace(q.device, nfloats) if nfloats else None
        err = build.launch(q, lib.swa_attention_launch, q.data_ptr(),
                           k.data_ptr(), v.data_ptr(), out.data_ptr(), part,
                           prm)
    else:
        B, Sq, H, hd = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        tma = [_tma_strides(name, t) for name, t in (("q", q), ("k", k),
                                                      ("v", v))]
        out = torch.empty((B, Sq, H, hd), dtype=torch.float32,
                          device=q.device)
        st = build.strides(*tma, out.stride()[:3])
        err = build.launch(q, lib.swa_attention_tc_launch, q.data_ptr(),
                           k.data_ptr(), v.data_ptr(), out.data_ptr(), st, B,
                           Sq, Sk, H, KV, hd, window or 0, int(causal),
                           1.0 / hd ** 0.5)
        if err < 0:
            raise RuntimeError("swa_attention: cuTensorMapEncodeTiled "
                               f"refused a tensor map (CUresult {-err})")
    build.check(err, f"swa_attention launch ({route} route)")
    global launches
    launches += 1
    launches_by_route[route] += 1
    return out


class SwaAttentionFn(torch.autograd.Function):
    """``swa_attention`` with a backward: the forward is the kernel (or the
    plain version on the CPU) as without grad; it saves q, k, v and the
    fp32 output, and the backward is ``swa_attention_bwd``. Gradients come
    back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        out = _forward(q, k, v, window, causal)
        ctx.save_for_backward(q, k, v, out)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = swa_attention_bwd(q, k, v, out, dout,
                                       window=ctx.window, causal=ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def swa_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *,
                      window: int | None = None, causal: bool = True):
    """The gradients (dq, dk, dv), all fp32, of ``swa_attention`` at q, k,
    v, given its output ``o`` and the output's gradient ``do`` (both
    (B, Sq, H, hd)). A CPU tensor runs the plain version
    (``kernels.ref.swa_attention_bwd_ref``); a CUDA tensor launches the
    route ``_bwd_route`` picks (each three passes: the rows' log-sum-exp
    and D, then dK / dV per key tile, then dQ per query tile; no atomics)
    or raises. ``launches_bwd`` counts its calls on the card."""
    _check_shapes(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"swa_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}; want q's {tuple(q.shape)}")
    devs = {t.device for t in (q, k, v, o, do)}
    if ref.runs_plain(q, k, v, o, do):
        return ref.swa_attention_bwd_ref(q, k, v, o, do, window=window,
                                         causal=causal)
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"swa_attention_bwd: inputs on "
                         f"{sorted(map(str, devs))}; all must be on one "
                         "CUDA device (or the CPU)")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"swa_attention_bwd: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; fp32 or bf16, k and v alike")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM or B * H > 65535:
        raise ValueError(f"swa_attention_bwd: hd={hd}, B·H={B * H} outside "
                         f"the kernel's range (hd <= {MAX_HEAD_DIM}, "
                         "B·H <= 65535)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("swa_attention_bwd: the head dim of q, k, v must "
                         "be contiguous")
    route = _bwd_route(q.dtype, k.dtype, hd)
    o = o.float().contiguous()
    do = do.to(torch.bfloat16 if route == "tc" else torch.float32)
    do = do.contiguous()
    dev = q.device
    ws = torch.empty((2, B * H * Sq), dtype=torch.float32, device=dev)
    dq = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=dev)
    dk = torch.empty((B, Sk, KV, hd), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    shape = (B, Sq, Sk, H, KV, hd, window or 0, int(causal))
    lib = build.library()
    if route == "tc":
        # GQA / MQA: each query head's dK, dV, summed per kv head at the end
        part = (torch.empty((2, B, Sk, H, hd), dtype=torch.float32,
                            device=dev) if H != KV else None)
        prm = build.strides(q.stride()[:3], k.stride()[:3], v.stride()[:3],
                            shape)
        err = build.launch(q, lib.swa_attention_bwd_tc_launch, q.data_ptr(),
                           k.data_ptr(), v.data_ptr(), do.data_ptr(),
                           o.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(),
                           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                           None if part is None else part[0].data_ptr(),
                           None if part is None else part[1].data_ptr(), prm)
    else:
        prm = build.strides(q.stride()[:3], k.stride()[:3], v.stride()[:3],
                            shape, (int(q.dtype == torch.bfloat16),
                                    int(k.dtype == torch.bfloat16)))
        err = build.launch(q, lib.swa_attention_bwd_launch, q.data_ptr(),
                           k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           do.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(),
                           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), prm)
    build.check(err, f"swa_attention_bwd launch ({route} route)")
    global launches_bwd
    launches_bwd += 1
    launches_bwd_by_route[route] += 1
    return dq, dk, dv
