"""Blocked MADC proximity (paper eq. 7): the wrapper around the Hopper
kernel ``csrc/madc.cu``, which replaces the Pallas kernel
``repro.kernels.madc.madc_block``.

A CPU tensor runs the plain version (``kernels.ref.madc_ref``); a CUDA
tensor launches the kernel or raises — at every n: the reference's
interpret-mode crossover does not carry over. ``launches`` counts the
kernel's launches. The kernel computes the upper triangle of output tiles
only, from a 1-D grid (``madc_tile_of``), and mirrors each tile.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, ref

launches = 0
TILES = (16, 32, 64)


def madc_tiles(n: int) -> int:
    """The output tile edge for n: the counterpart of the Pallas
    ``madc_tiles``, with the H100's own numbers (PERF.md, from the tile
    sweep of ``chip_smoke.py``). Small tiles win while the upper triangle
    of larger ones leaves SMs idle: 16 below 1024 (28 blocks at the main
    path's n = 100, where 64 gives 3; 4.3 µs against 28 µs), 32 below
    1280, 64 from there on, where the 4×4 register tile's arithmetic
    density pays."""
    if n < 1024:
        return 16
    if n < 1280:
        return 32
    return 64


def madc_tile_of(t: int) -> tuple:
    """(i-tile, j-tile) of block t of the kernel's 1-D grid over the upper
    triangle, computed as ``csrc/madc.cu`` does: j-tile a = the largest a
    with a(a+1)/2 <= t (a float square root, then exact integer
    corrections), i-tile t − a(a+1)/2, so i-tile <= j-tile."""
    a = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while (a + 1) * (a + 2) // 2 <= t:
        a += 1
    while a * (a + 1) // 2 > t:
        a -= 1
    return t - a * (a + 1) // 2, a


def madc(M: torch.Tensor, tile: int | None = None) -> torch.Tensor:
    """M: (n, n) fp32 cosine similarities -> (n, n) fp32 MADC, exactly
    symmetric. ``tile`` overrides ``madc_tiles(n)`` (16, 32 or 64)."""
    if M.ndim != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"madc: M must be square, got {tuple(M.shape)}")
    dev = M.device
    if dev.type == "cpu":
        return ref.madc_ref(M)
    if dev.type != "cuda":
        raise ValueError(f"madc: M on {dev}; CUDA or CPU only")
    if M.dtype != torch.float32:
        raise TypeError(f"madc: dtype {M.dtype}; fp32 only")
    if not M.is_contiguous():
        raise ValueError("madc: M must be contiguous")
    n = M.shape[0]
    if n == 0 or n * n >= 2 ** 62:
        raise ValueError(f"madc: n={n} outside the kernel's range")
    if tile is None:
        tile = madc_tiles(n)
    elif tile not in TILES:
        raise ValueError(f"madc: tile={tile}; one of {TILES}")
    lib = build.library()
    out = torch.empty_like(M)
    err = build.launch(M, lib.madc_launch, M.data_ptr(), out.data_ptr(), n,
                       tile)
    build.check(err, "madc launch")
    global launches
    launches += 1
    return out
