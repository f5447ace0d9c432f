"""The zoo's attention families on the card: ``swa_attention`` at the new
families' head layouts (GQA, MQA, hd 256 and 80, bidirectional) at reduced
sequence lengths against its plain version, on the route each shape takes,
and each family's smoke forward and a few serve steps on the card against
the same run on the CPU. Marked ``gpu``: without a card every test skips
(decided in the ``cuda`` fixture, never at import). Run on a GPU machine
with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_zoo_families_gpu.py

Tolerances: the kernel's ``fp32`` route 3e-5, its tensor-core route 1e-2
(it rounds P to bf16, as tests/test_torch_kernels_gpu.py holds it); a
smoke forward or serve step on the card against the CPU 1e-4 (fp32)."""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swa_attention as swa_mod
from repro_torch.models import zoo
from repro_torch.models.modules import tree_map

pytestmark = pytest.mark.gpu
SWA_TOL = {"tc": 1e-2, "fp32": 3e-5}
FAMILIES = ["gemma-2b", "glm4-9b", "granite-20b", "nemotron-4-15b",
            "internvl2-1b", "hubert-xlarge", "granite-moe-1b-a400m"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); the CPU tests cover the plain versions")
    return torch.Generator(device="cuda").manual_seed(0)


# (label, B, S, H, KV, hd, window, causal, route): chip_smoke.py's phase-2
# cases at a reduced S
CASES = [
    ("gemma-prefill", 2, 256, 8, 1, 256, None, True, "fp32"),
    ("gemma-long500k", 1, 512, 8, 1, 256, 128, True, "fp32"),
    ("glm4", 2, 256, 32, 2, 128, None, True, "tc"),
    ("granite20b", 1, 256, 48, 1, 128, None, True, "tc"),
    ("internvl2", 2, 200, 14, 2, 64, None, True, "tc"),
    ("hubert", 2, 160, 16, 16, 80, None, False, "fp32"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_swa_at_the_families_shapes_matches_plain(cuda, case):
    _, B, S, H, KV, hd, window, causal, route = case
    q = torch.randn((B, S, H, hd), generator=cuda, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((B, S, KV, hd), generator=cuda, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    assert swa_mod._route(q.dtype, k.dtype, hd) == route
    ops.reset_launch_counts()
    got = swa_mod.swa_attention(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()[f"swa_attention.{route}"] == 1
    want = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    tol = SWA_TOL[route]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def _inputs(cfg, B, S, gen):
    if cfg.family == "audio":
        return {"frames": torch.randn((B, S, cfg.frontend_dim),
                                      generator=gen)}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (B, cfg.n_patches, cfg.frontend_dim), generator=gen)
    return batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_smoke_forward_on_card_matches_cpu(cuda, arch):
    """fp32: one ``fp32``-route launch per layer; logits within 1e-4."""
    cfg = registry.smoke_variant(registry.get(arch))
    params = zoo.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    batch = _inputs(cfg, 2, 48, torch.Generator().manual_seed(1))
    want, want_aux = zoo.forward(params, cfg, batch)
    ops.reset_launch_counts()
    got, aux = zoo.forward(tree_map(lambda t: t.cuda(), params), cfg,
                           {k: t.cuda() for k, t in batch.items()})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["swa_attention.fp32"] == cfg.n_layers
    assert counts["swa_attention"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for k in want_aux:
        torch.testing.assert_close(aux[k].cpu(), want_aux[k], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", ["gemma-2b", "internvl2-1b",
                                  "granite-moe-1b-a400m"])
def test_family_smoke_serve_on_card_matches_cpu(cuda, arch):
    """8 decode steps (no kernel) on the card against the CPU."""
    cfg = registry.smoke_variant(registry.get(arch))
    params = zoo.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    gp = tree_map(lambda t: t.cuda(), params)
    tok = torch.randint(0, cfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(2))
    cc = zoo.init_cache(cfg, 2, 8, device="cpu")
    gc = zoo.init_cache(cfg, 2, 8, device="cuda")
    for t in range(8):
        pos = torch.full((2,), t)
        want, cc = zoo.serve_step(params, cfg, cc, tok[:, t:t + 1], pos)
        got, gc = zoo.serve_step(gp, cfg, gc, tok[:, t:t + 1].cuda(),
                                 pos.cuda())
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_family_bf16_smoke_forward_takes_the_tensor_core_route(cuda):
    """bf16 at the smoke's hd 64: the ``tc`` route, once per layer."""
    cfg = registry.smoke_variant(registry.get("glm4-9b")).replace(
        dtype="bfloat16")
    params = zoo.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg, device="cuda")
    ops.reset_launch_counts()
    logits, _ = zoo.forward(params, cfg, {"tokens": torch.randint(
        0, cfg.vocab_size, (2, 64), device="cuda", generator=cuda)})
    torch.cuda.synchronize()
    assert ops.launch_counts()["swa_attention.tc"] == cfg.n_layers
    assert bool(torch.isfinite(logits).all())
