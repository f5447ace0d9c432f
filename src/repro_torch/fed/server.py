"""Server-side helpers the port's trainers call (``repro.fed.server``)."""
from __future__ import annotations


def tree_index(group_params: dict, j: int) -> dict:
    """j-th group's parameters (views) from an m-stacked param dict."""
    return {k: g[j] for k, g in group_params.items()}
