"""EDC cosine block E = K(ΔW, Vᵀ) (paper eq. 8): the wrapper around the
Hopper kernel ``csrc/edc_cosine.cu``, which replaces the Pallas kernel
``repro.kernels.edc_cosine.edc_cosine``. Any m >= 1.

The kernel splits d into slices sized from the card's SM count, n into
blocks of at most ``ROWS_MAX`` rows and V's m columns into tiles of at
most ``MAX_TILE`` (``plan``): one CTA per (slice, row block, column tile)
writes its partial sums, and a second kernel sums them per row in a
fixed order. A call signature (shapes, strides, dtypes, devices) is
checked and planned once; later calls with it allocate the output and
launch. The partials live in a workspace kept per device and stream.

The partial-sum entry ``edc_cosine_partial`` serves a d-block of ΔW on
a model axis: the same first kernel, then ``edc_sums_kernel``, which
writes the sums undivided as one packed buffer ``[dots (n, m) | row sums
of squares (n) | V's column sums of squares (m)]``; the caller sums it
over the model axis and divides (``cosine_from_sums``).

A CPU tensor runs the plain version (``kernels.ref.cosine_block_ref``,
``cosine_sums_ref``), and so does a ``meta`` tensor (shapes only: the dry
run); a CUDA tensor launches the kernel or raises. ``launches`` and
``partial_launches`` count the two entries' launches.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

launches = 0
partial_launches = 0
_DTYPES = (torch.float32, torch.bfloat16)
MAX_TILE = 16           # V columns per CTA
TILE_WIDTHS = (4, 8, 12, 16)   # the widths the kernel is built for
WARPS = 8               # per CTA (the kernel's kWarps)
ROWS_PER_WARP = 4       # rows a warp's step covers (kR)
ROWS_MAX = 256          # rows per CTA (kRowsMax)
SMEM_MAX = 113 * 1024   # shared memory of a CTA, two an SM (kSmemMax)
CTAS_PER_SM = 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stride(width: int) -> int:
    """Row stride (floats) of V's tile in shared memory: ≡ 4 (mod 8), so
    a quarter warp's float4 reads of 8 columns hit 32 banks (Tile::S)."""
    return width if width % 8 == 4 else width + 4


def step(width: int) -> int:
    """Columns of a warp's step: 4 loads a lane and row at width <= 12,
    else 2 (Tile::kStep)."""
    return 32 * (4 if width <= 12 else 2)


def max_slice(width: int) -> int:
    """The longest slice whose V tile (in whole steps) and the warps'
    pieces of shared row groups fit in ``SMEM_MAX``."""
    pieces = 2 * WARPS * ROWS_PER_WARP * (width + 1)
    return (SMEM_MAX // 4 - pieces) // stride(width) // step(width) \
        * step(width)


class Plan(NamedTuple):
    """What a launch for (n, d, m) runs: d in ``ns`` slices of ``slice``
    columns, n in ``nrb`` blocks of ``rows`` rows, m in ``ncb`` column
    tiles of ``width``; one CTA each, and ``scratch_floats`` of partials:
    n·(m + 1) row sums (dots, then the sum of squares) and m column sums
    of squares of V, per slice."""
    slice: int
    ns: int
    rows: int
    nrb: int
    ncb: int
    width: int
    scratch_floats: int


def _tiles(m: int) -> tuple:
    """(tiles, width): ⌈m / MAX_TILE⌉ column tiles as even as the widths
    allow, ⌈m / tiles⌉ columns rounded up to a multiple of 4."""
    ncb = _cdiv(m, MAX_TILE)
    return ncb, 4 * _cdiv(_cdiv(m, ncb), 4)


@functools.lru_cache(maxsize=256)
def plan(n: int, d: int, m: int, n_sm: int) -> Plan:
    """The kernel's grid for ΔW (n, d) and V (d, m) on a card of ``n_sm``
    SMs: rows in as few blocks of at most ``ROWS_MAX`` as can be, even to
    a multiple of 4; the fewest whole waves of ``CTAS_PER_SM`` CTAs an SM
    whose slices fit in shared memory, the slices as even as 32-column
    multiples allow (at least 256), so every CTA has about the same
    work."""
    ncb, width = _tiles(m)
    nrb = _cdiv(n, ROWS_MAX)
    rows = ROWS_PER_WARP * _cdiv(_cdiv(n, nrb), ROWS_PER_WARP)
    per_slice = ncb * nrb
    wave = n_sm * CTAS_PER_SM
    waves = _cdiv(_cdiv(d, max_slice(width)) * per_slice, wave)
    ns = _cdiv(waves * wave, per_slice)
    sl = max(256, 32 * _cdiv(_cdiv(d, ns), 32))
    ns = _cdiv(d, sl)
    return Plan(slice=sl, ns=ns, rows=rows, nrb=_cdiv(n, rows), ncb=ncb,
                width=width, scratch_floats=(n * (m + 1) + m) * ns)


def d_slices(d: int, sl: int) -> list:
    """[c0, c1) of each CTA's columns of ΔW (and rows of V)."""
    return [(c0, min(c0 + sl, d)) for c0 in range(0, d, sl)]


def col_tiles(m: int) -> list:
    """[k0, k1) of V's columns in each column tile (``plan``'s width;
    the last tile's columns past m are zeros in the kernel)."""
    ncb, width = _tiles(m)
    return [(b * width, min((b + 1) * width, m)) for b in range(ncb)]


def row_blocks(n: int, rows: int) -> list:
    """[r0, r1) of ΔW's rows in each row block."""
    return [(r0, min(r0 + rows, n)) for r0 in range(0, n, rows)]


def warp_steps(groups: int, nb: int) -> list:
    """[t0, t1) of each working warp's steps: a CTA's groups·nb steps
    (row group g's steps are g·nb ... g·nb + nb − 1) split evenly over
    min(WARPS, groups) warps, so a row group is split between at most
    two warps."""
    aw = min(WARPS, groups)
    t = groups * nb
    return [(w * t // aw, (w + 1) * t // aw) for w in range(aw)]


def _plan_call(dW: torch.Tensor, V: torch.Tensor) -> tuple:
    """Checks a call's signature: ``("cpu",)`` (the plain version, for CPU
    or ``meta`` tensors), or ``("cuda", params,
    scratch floats, out shape)``, params the C launcher's arguments."""
    if dW.ndim != 2 or V.ndim != 2 or dW.shape[1] != V.shape[0]:
        raise ValueError(f"edc_cosine: shapes {tuple(dW.shape)} and "
                         f"{tuple(V.shape)} do not chain (n, d) @ (d, m)")
    if ref.runs_plain(dW, V):
        return ("cpu",)
    if dW.device.type != "cuda" or V.device != dW.device:
        raise ValueError(f"edc_cosine: dW on {dW.device}, V on {V.device}; "
                         "both must be on one CUDA device (or the CPU)")
    if dW.dtype not in _DTYPES or V.dtype not in _DTYPES:
        raise TypeError(f"edc_cosine: dtypes {dW.dtype}, {V.dtype}; "
                        "fp32 or bf16 only")
    if not (dW.is_contiguous() and V.is_contiguous()):
        raise ValueError("edc_cosine: dW and V must be contiguous")
    n, d = dW.shape
    m = V.shape[1]
    if min(n, d, m) == 0 or max(n, d, m) >= 2 ** 31:
        raise ValueError(f"edc_cosine: n={n}, d={d}, m={m} outside the "
                         "kernel's range (1 <= n, d, m < 2^31)")
    p = plan(n, d, m, build.sm_count(dW.device.index))
    prm = build.strides((n, d, m, int(dW.dtype == torch.bfloat16),
                         int(V.dtype == torch.bfloat16), p.slice, p.ns,
                         p.rows, p.nrb, p.width, p.ncb))
    return ("cuda", prm, p.scratch_floats, (n, m))


_plans: dict = {}
_workspaces: dict = {}


def _workspace(device: torch.device, floats: int) -> int:
    """The partials: one buffer per device and stream, grown when a plan
    needs more (the launches of one stream use it in order; the caching
    allocator keeps a freed one until they are done)."""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
        _workspaces[key] = ws
    return ws.data_ptr()


def _planned(dW: torch.Tensor, V: torch.Tensor) -> tuple:
    """``_plan_call`` of this call's signature, checked once and cached."""
    key = (dW.shape, V.shape, dW.stride(), V.stride(), dW.dtype, V.dtype,
           dW.device, V.device)
    call = _plans.get(key)
    if call is None:
        call = _plan_call(dW, V)
        if len(_plans) >= 512:
            _plans.clear()
        _plans[key] = call
    return call


def edc_cosine(dW: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """dW: (n, d), V: (d, m), fp32 or bf16 -> (n, m) fp32 cosines."""
    call = _planned(dW, V)
    if call[0] == "cpu":
        return ref.cosine_block_ref(dW, V)
    _, prm, floats, shape = call
    out = torch.empty(shape, dtype=torch.float32, device=dW.device)
    err = build.launch(dW, build.library().edc_cosine_launch, dW.data_ptr(),
                       V.data_ptr(), out.data_ptr(),
                       _workspace(dW.device, floats), prm)
    build.check(err, "edc_cosine launch")
    global launches
    launches += 1
    return out


def edc_cosine_partial(dW: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """The partial-sum entry. dW: (n, d), V: (d, m), fp32 or bf16 (a
    d-block of each) -> (n·m + n + m,) fp32 ``[dots | row squares | V's
    column squares]``, summed over d in the kernel's fixed slice order,
    nothing divided."""
    call = _planned(dW, V)
    if call[0] == "cpu":
        return ref.cosine_sums_ref(dW, V)
    _, prm, floats, (n, m) = call
    out = torch.empty(n * m + n + m, dtype=torch.float32, device=dW.device)
    err = build.launch(dW, build.library().edc_cosine_sums_launch,
                       dW.data_ptr(), V.data_ptr(), out.data_ptr(),
                       _workspace(dW.device, floats), prm)
    build.check(err, "edc_cosine_partial launch")
    global partial_launches
    partial_launches += 1
    return out


def split_sums(packed: torch.Tensor, n: int, m: int) -> tuple:
    """(dots (n, m), row squares (n,), column squares (m,)) views of a
    packed ``edc_cosine_partial`` buffer."""
    return (packed[:n * m].view(n, m), packed[n * m:n * m + n],
            packed[n * m + n:])


def cosine_from_sums(packed: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """E (n, m) from the packed sums over all of d: the two ε clamps of
    ``ref.cosine_block_ref``, norms as square roots of the sums."""
    dots, rsq, csq = split_sums(packed, n, m)
    cn = torch.clamp(torch.sqrt(csq), min=ref.EPS)
    return dots / torch.clamp(torch.sqrt(rsq)[:, None] * cn[None], min=ref.EPS)
