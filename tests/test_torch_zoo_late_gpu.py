"""The zoo's last two families on the card: ``swa_attention`` at the MTP
head's layout (DeepSeek-V3's dense block: H = KV = 128, hd 56, the
``fp32`` route) at a reduced sequence length against its plain version,
and DeepSeek-V3's smoke variant (MLA, the MoE layer, the MTP head) and
xLSTM's (both mLSTM forms, sLSTM) on the card against the same models on
the CPU. Marked ``gpu``: without a card every test skips (decided in the
``cuda`` fixture, never at import). Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_zoo_late_gpu.py

Tolerances: the kernel's ``fp32`` route 3e-5; a smoke forward, MTP head
or serve step on the card against the CPU 1e-4 (fp32)."""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swa_attention as swa_mod
from repro_torch.models import zoo
from repro_torch.models.modules import tree_leaves, tree_map

pytestmark = pytest.mark.gpu
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); the CPU tests cover the plain versions")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_swa_at_the_mtp_head_layout_matches_plain(cuda, dtype):
    """hd 56 is no tensor-core head dim: the fp32 route pads it to 64."""
    B, S, H, hd = 2, 256, 128, 56
    q, k, v = (torch.randn((B, S, H, hd), generator=cuda, device="cuda").to(
        dtype) for _ in range(3))
    assert swa_mod._route(dtype, dtype, hd) == "fp32"
    ops.reset_launch_counts()
    got = swa_mod.swa_attention(q, k, v, window=None, causal=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["swa_attention.fp32"] == 1
    want = ref.swa_attention_ref(q, k, v, window=None, causal=True)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


def _both(arch, **kw):
    """(config, CPU params, the same params on the card) of the smoke
    variant."""
    cfg = registry.smoke_variant(registry.get(arch)).replace(**kw)
    params = zoo.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    return cfg, params, tree_map(lambda t: t.cuda(), params)


def _tokens(cfg, B, S, seed):
    return torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def test_deepseek_smoke_forward_and_mtp_on_card_match_cpu(cuda):
    """MLA and the MoE layer launch no kernel; the MTP head's dense block
    launches one swa_attention (fp32 here: the fp32 route)."""
    cfg, params, gp = _both("deepseek-v3-671b", mtp=True)
    tok = _tokens(cfg, 2, 48, 1)
    want, waux = zoo.forward(params, cfg, {"tokens": tok}, return_hidden=True)
    ops.reset_launch_counts()
    got, aux = zoo.forward(gp, cfg, {"tokens": tok.cuda()},
                           return_hidden=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["swa_attention"] == 0
    torch.testing.assert_close(got.cpu(), want, **TOL)
    for k in ("load_balance_loss", "router_z_loss"):
        torch.testing.assert_close(aux[k].cpu(), waux[k], atol=1e-5,
                                   rtol=1e-5)
    want_m = zoo.mtp_logits(params, cfg, waux["hidden"], tok)
    got_m = zoo.mtp_logits(gp, cfg, aux["hidden"], tok.cuda())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["swa_attention"] == counts["swa_attention.fp32"] == 1
    torch.testing.assert_close(got_m.cpu(), want_m, **TOL)


@pytest.mark.parametrize("arch,kw", [
    ("deepseek-v3-671b", {}), ("deepseek-v3-671b", {"window": 4}),
    ("xlstm-350m", {})], ids=["deepseek", "deepseek-ring4", "xlstm"])
def test_smoke_serve_on_card_matches_cpu(cuda, arch, kw):
    """8 decode steps (no kernel) on the card against the CPU: logits and
    the caches (MLA's compressed latent, xLSTM's states)."""
    cfg, params, gp = _both(arch, **kw)
    tok = _tokens(cfg, 2, 8, 2)
    slots = kw.get("window", 8)
    cc = zoo.init_cache(cfg, 2, slots, device="cpu")
    gc = zoo.init_cache(cfg, 2, slots, device="cuda")
    for t in range(8):
        pos = torch.full((2,), t)
        want, cc = zoo.serve_step(params, cfg, cc, tok[:, t:t + 1], pos)
        got, gc = zoo.serve_step(gp, cfg, gc, tok[:, t:t + 1].cuda(),
                                 pos.cuda())
        torch.testing.assert_close(got.cpu(), want, **TOL)
    for a, b in zip(tree_leaves(gc), tree_leaves(cc)):
        torch.testing.assert_close(a.cpu(), b, **TOL)


@pytest.mark.parametrize("impl", ["recurrent", "chunkwise"])
def test_xlstm_smoke_forward_on_card_matches_cpu(cuda, impl):
    cfg, params, gp = _both("xlstm-350m", mlstm_impl=impl)
    tok = _tokens(cfg, 2, 48, 3)
    want, _ = zoo.forward(params, cfg, {"tokens": tok})
    ops.reset_launch_counts()
    got, _ = zoo.forward(gp, cfg, {"tokens": tok.cuda()})
    torch.cuda.synchronize()
    assert ops.launch_counts()["swa_attention"] == 0
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_xlstm_bf16_chunkwise_prefill_on_card_is_finite(cuda):
    """bf16 at the smoke widths through the chunkwise mLSTM: finite logits
    of the expected shape, within 5 % of the fp32 forward in norm (2.1 %
    on the CPU: bf16 activations through two blocks)."""
    cfg, _, gp = _both("xlstm-350m", mlstm_impl="chunkwise")
    tok = _tokens(cfg, 2, 64, 4).cuda()
    want, _ = zoo.forward(gp, cfg, {"tokens": tok})
    got, _ = zoo.forward(gp, cfg.replace(dtype="bfloat16"), {"tokens": tok})
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want).norm() / want.norm()) < 0.05
