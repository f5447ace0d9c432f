"""The hand-written kernels' launch counts, read and reset together.

Each kernel module (``kernels.edc_cosine``, ``kernels.madc``,
``kernels.swa_attention``, ``kernels.ssd_chunk``) dispatches on its own: a
CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
the call raises. There is no crossover and no fallback.
"""
from __future__ import annotations

from repro_torch.kernels import edc_cosine as _edc
from repro_torch.kernels import madc as _madc
from repro_torch.kernels import ssd_chunk as _ssd
from repro_torch.kernels import swa_attention as _swa

KERNELS = {"edc_cosine": _edc, "madc": _madc, "swa_attention": _swa,
           "ssd_intra_chunk": _ssd}
_ROUTED = {"swa_attention": _swa, "ssd_intra_chunk": _ssd}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}, and the launches of
    each route of ``swa_attention`` and ``ssd_intra_chunk`` as
    ``<name>.tc`` and ``<name>.fp32``."""
    counts = {name: mod.launches for name, mod in KERNELS.items()}
    for name, mod in _ROUTED.items():
        for route, n in mod.launches_by_route.items():
            counts[f"{name}.{route}"] = n
    return counts


def partial_launch_counts() -> dict:
    """{``edc_cosine_partial``: launches of ``edc_cosine``'s partial-sum
    entry (a d-block on a model axis) since the last reset}."""
    return {"edc_cosine_partial": _edc.partial_launches}


def backward_launch_counts() -> dict:
    """{``swa_attention_bwd``, ``ssd_intra_chunk_bwd``: launches of the
    backward kernels since the last reset}."""
    return {f"{name}_bwd": mod.launches_bwd for name, mod in _ROUTED.items()}


def backward_route_counts() -> dict:
    """{``swa_attention_bwd.tc``, ``swa_attention_bwd.fp32``: launches of
    each route of the SWA backward since the last reset}."""
    return {f"swa_attention_bwd.{route}": n
            for route, n in _swa.launches_bwd_by_route.items()}


def reset_launch_counts():
    for mod in KERNELS.values():
        mod.launches = 0
    _edc.partial_launches = 0
    for mod in _ROUTED.values():
        for route in mod.launches_by_route:
            mod.launches_by_route[route] = 0
        mod.launches_bwd = 0
    for route in _swa.launches_bwd_by_route:
        _swa.launches_bwd_by_route[route] = 0
