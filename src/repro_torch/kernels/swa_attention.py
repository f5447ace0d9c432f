"""Sliding-window flash attention, forward: the wrapper around two Hopper
kernels that replace the Pallas kernel
``repro.kernels.swa_attention.swa_attention``:

- route ``tc``, ``csrc/swa_attention_tc.cu``: q, k, v all bf16 with head
  dim 64 or 128 (Zamba2's prefill). Tensor cores (``wgmma``) fed by TMA;
  P is rounded to bf16 before P·V, as the JAX zoo's ``sdpa`` does, so it
  agrees with the plain version within 1e-2.
- route ``fp32``, ``csrc/swa_attention.cu``: every other input (fp32, or
  another head dim up to 256). CUDA cores, all in fp32; within 3e-5.

The route depends on dtype and head dim only (``_route``). On the ``tc``
route an input that breaks TMA's rules raises; it never switches route. A
CPU tensor runs the plain version (``kernels.ref.swa_attention_ref``); a
CUDA tensor launches a kernel or raises. ``launches`` counts every launch,
``launches_by_route`` each route's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0
launches_by_route = {"tc": 0, "fp32": 0}
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 128)


def _route(dtype_q, dtype_kv, hd: int) -> str:
    """``"tc"`` for bf16 q and k/v with hd 64 or 128, else ``"fp32"``."""
    if (dtype_q == torch.bfloat16 and dtype_kv == torch.bfloat16
            and hd in TC_HEAD_DIMS):
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


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int | None = None,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), fp32 or bf16 ->
    (B, Sq, H, hd) fp32. Query i sits at absolute position i + (Sk − Sq);
    the window keeps keys with kpos > qpos − window."""
    _check_shapes(q, k, v, window)
    devs = {q.device, k.device, v.device}
    if devs == {torch.device("cpu")}:
        return ref.swa_attention_ref(q, k, v, window=window, causal=causal)
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
        tma = [_tma_strides(name, t) for name, t in (("q", q), ("k", k),
                                                      ("v", v))]
    lib = build.library()
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    scale = 1.0 / hd ** 0.5
    if route == "tc":
        st = build.strides(*tma, out.stride()[:3])
        err = build.launch(q, lib.swa_attention_tc_launch, q.data_ptr(),
                           k.data_ptr(), v.data_ptr(), out.data_ptr(), st, B,
                           Sq, Sk, H, KV, hd, window or 0, int(causal),
                           scale)
        if err < 0:
            raise RuntimeError("swa_attention: cuTensorMapEncodeTiled "
                               f"refused a tensor map (CUresult {-err})")
    else:
        st = build.strides(*(t.stride()[:3] for t in (q, k, v, out)))
        err = build.launch(q, lib.swa_attention_launch, q.data_ptr(),
                           k.data_ptr(), v.data_ptr(), out.data_ptr(), st, B,
                           Sq, Sk, H, KV, hd, window or 0, int(causal), scale,
                           int(q.dtype == torch.bfloat16),
                           int(k.dtype == torch.bfloat16))
    build.check(err, f"swa_attention launch ({route} route)")
    global launches
    launches += 1
    launches_by_route[route] += 1
    return out
