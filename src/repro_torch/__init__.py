"""PyTorch/CUDA port of the FedGroup system (the JAX package ``repro`` is
the reference it is tested against).

Layout mirrors ``repro``: ``data``, ``models``, ``fed``, ``core``,
``kernels`` (hand-written CUDA for Hopper, ``csrc/``) and ``launch``.
Parameters are ``dict[str, Tensor]``; every entry point takes an explicit
``device=`` and runs on ``cuda`` unless the caller asks for ``"cpu"``.

TF32 is switched off here, for both matrix products and cuDNN: the plain
products on the main path (the local solver, the randomized SVD, the
segment-sum aggregation) must stay full fp32 to agree with the fp32
reference.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; asking for CUDA without a card
    raises — nothing silently carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev
