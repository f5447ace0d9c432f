"""LM training on the card: both backward kernels against their plain
versions and against ``torch.autograd.grad`` through the plain forward,
each call repeated bit for bit; one smoke-variant ``train_step`` of each
family on the card against the same step on the CPU; the MoE forward and
train step repeated bit for bit. Marked ``gpu``: without a card every test
skips (decided in the ``cuda`` fixture, never at import). Run on a GPU
machine with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_train_gpu.py

``swa_attention_bwd`` has two routes. bf16 q, k, v take ``tc``
(``csrc/swa_attention_bwd_tc.cu``, bf16 tensor cores: dO, P and dS rounded
to bf16 as SDPA's backward rounds them), held within RND_TOL of each
gradient's largest magnitude of the plain version that rounds where it
rounds (``ref.swa_attention_bwd_ref(..., rounded=True)``; the kernel's
fp32 scores differ from the plain version's in the last bits, which can
flip a P or dS element by one bf16 step), and within 2e-2 of the fp32
plain version and of autograd (``chip_smoke.py``'s
``TRAIN_TOL["bfloat16"]``: rounding P and dS to bf16 moves a gradient by
~2^-8 of its scale). fp32 or mixed inputs take ``fp32``
(``csrc/swa_attention_bwd.cu``), within 1e-4 of both. ``ssd_intra_chunk_bwd``
(``csrc/ssd_chunk_bwd.cu``, TF32 tensor cores at fp32 accuracy)
elementwise within 2e-4 (atol and rtol, as its forward) of the plain
version evaluated in float64 on the same inputs, with B and C by group
(one group, two, three, one a head): a group's dB and dC sum up to 64
heads x 128 rows, and at that size the plain version in fp32 is itself
~0.9 of 2e-4 away from the exact answer, so two fp32-accurate results
can differ by more than the tolerance. A
train step's loss 1e-4, its gradients (``mu`` after one step is 0.1 · g)
1e-4 of each leaf's largest, and the params after the update 1e-3 in
Frobenius norm over the whole tree relative to the CPU's (one AdamW update
is about lr·sign(g): an element whose gradient is ~0 may step either
way)."""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk_bwd
from repro_torch.kernels.swa_attention import swa_attention_bwd
from repro_torch.launch.train import lm_batch
from repro_torch.models import zoo
from repro_torch.models.modules import tree_leaves, tree_map

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); the CPU tests cover the plain versions")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _fro(got, want) -> float:
    return float(torch.linalg.norm(got.float() - want.float())
                 / torch.linalg.norm(want.float()).clamp_min(1e-30))


RND_TOL = 5e-3
BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,window,causal,dtype", [
    (2, 256, 256, 8, 8, 64, None, True, BF),
    (1, 256, 256, 8, 1, 256, None, True, BF),
    (2, 128, 128, 4, 4, 80, None, False, BF),
    (1, 100, 300, 4, 2, 56, 64, True, F32),
    (1, 77, 77, 3, 1, 40, 9, False, F32),
    (1, 100, 300, 4, 2, 56, 64, True, BF),
    (2, 200, 200, 6, 2, 128, None, True, BF),
    (1, 90, 130, 8, 1, 256, 40, True, BF),
    (1, 77, 77, 3, 1, 40, 9, False, BF),
    (2, 70, 70, 4, 4, 64, None, False, BF)],
    ids=["zamba2-like", "gemma-like", "hubert-like", "window-sq<sk",
         "ragged", "tc-hd56-gqa-window-sq<sk", "tc-hd128-gqa-ragged",
         "tc-hd256-mqa-window-sq<sk", "tc-hd40-mqa-bidir-window",
         "tc-hd64-bidir-ragged"])
def test_swa_bwd_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, hd, window,
                                      causal, dtype):
    q = torch.randn((B, Sq, H, hd), generator=cuda, device="cuda").to(dtype)
    k, v = (torch.randn((B, Sk, KV, hd), generator=cuda,
                        device="cuda").to(dtype) for _ in range(2))
    do = torch.randn((B, Sq, H, hd), generator=cuda, device="cuda")
    o = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    ops.reset_launch_counts()
    got = swa_attention_bwd(q, k, v, o, do, window=window, causal=causal)
    again = swa_attention_bwd(q, k, v, o, do, window=window, causal=causal)
    torch.cuda.synchronize()
    route = "tc" if dtype == BF else "fp32"
    assert ops.backward_launch_counts()["swa_attention_bwd"] == 2
    assert ops.backward_route_counts() == {
        f"swa_attention_bwd.{r}": 2 * (r == route) for r in ("tc", "fp32")}
    want = ref.swa_attention_bwd_ref(q, k, v, o, do, window=window,
                                     causal=causal)
    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(ref.swa_attention_ref(
        *leaves, window=window, causal=causal), leaves, do)
    tol = 2e-2 if route == "tc" else 1e-4
    for g, a, w, au in zip(got, again, want, auto):
        assert torch.equal(g, a)
        assert _rel(g, w) <= tol and _rel(g, au) <= tol
    if route == "tc":
        rounded = ref.swa_attention_bwd_ref(q, k, v, o, do, window=window,
                                            causal=causal, rounded=True)
        for g, r in zip(got, rounded):
            assert _rel(g, r) <= RND_TOL


@pytest.mark.parametrize("b,c,Q,h,p,n,g", [
    (2, 4, 128, 8, 64, 64, 1), (2, 3, 64, 4, 32, 128, 2),
    (1, 2, 128, 4, 64, 128, 4), (1, 2, 64, 6, 32, 64, 3),
    (1, 3, 50, 4, 24, 40, 2)],
    ids=["q128-g1", "q64-p32-n128-g2", "q128-n128-per-head",
         "q64-g3", "ragged-g2"])
@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "fp32"])
def test_ssd_bwd_kernel_matches_plain(cuda, dtype, b, c, Q, h, p, n, g):
    X = torch.randn((b, c, Q, h, p), generator=cuda, device="cuda").to(dtype)
    A_cs = torch.cumsum(-0.1 * torch.rand((b, h, c, Q), generator=cuda,
                                          device="cuda"), -1)
    Bm, Cm = (torch.randn((b, c, Q, g, n), generator=cuda,
                          device="cuda").to(dtype) for _ in range(2))
    dY = torch.randn((b, c, Q, h, p), generator=cuda, device="cuda")
    dS = torch.randn((b, c, h, p, n), generator=cuda, device="cuda")
    got = ssd_intra_chunk_bwd(X, A_cs, Bm, Cm, dY, dS)
    again = ssd_intra_chunk_bwd(X, A_cs, Bm, Cm, dY, dS)
    want = ref.ssd_intra_chunk_bwd_ref(*(t.double() for t in (
        X, A_cs, Bm, Cm, dY, dS)))
    torch.cuda.synchronize()
    assert got[2].shape == (b, c, Q, g, n)
    for gt, a, w in zip(got, again, want):
        assert gt.dtype == torch.float32 and torch.equal(gt, a)
        torch.testing.assert_close(gt.double(), w, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ["gemma-2b", "hubert-xlarge",
                                  "internvl2-1b", "granite-moe-1b-a400m",
                                  "deepseek-v3-671b", "zamba2-1.2b",
                                  "xlstm-350m"])
def test_smoke_train_step_on_card_matches_cpu(cuda, arch):
    cfg = registry.smoke_variant(registry.get(arch)).replace(remat=True)
    st_cpu = zoo.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  device="cpu")
    st_gpu = tree_map(lambda t: t.cuda(), st_cpu)
    batch = lm_batch(torch.Generator().manual_seed(1), cfg, 2, 32, "cpu")
    ops.reset_launch_counts()
    st_gpu, m_gpu = zoo.train_step(st_gpu, tree_map(lambda t: t.cuda(),
                                                    batch), cfg)
    bwd = ops.backward_launch_counts()
    st_cpu, m_cpu = zoo.train_step(st_cpu, batch, cfg)
    if arch in ("gemma-2b", "hubert-xlarge", "internvl2-1b",
                "granite-moe-1b-a400m"):
        assert bwd["swa_attention_bwd"] == cfg.n_layers
    if arch == "zamba2-1.2b":
        assert bwd == {"swa_attention_bwd": 1, "ssd_intra_chunk_bwd": 2}
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) <= 1e-4
    # mu is 0.1 · the gradient after one step from zero moments
    for a, b in zip(tree_leaves(st_gpu["mu"]), tree_leaves(st_cpu["mu"])):
        assert _rel(a.cpu(), b) <= 1e-4
    got = torch.cat([t.cpu().reshape(-1) for t in tree_leaves(
        st_gpu["params"])])
    assert _fro(got, torch.cat([t.reshape(-1) for t in tree_leaves(
        st_cpu["params"])])) <= 1e-3


def test_moe_forward_and_train_step_repeat_bit_for_bit(cuda):
    cfg = registry.smoke_variant(registry.get("granite-moe-1b-a400m"))
    st = zoo.init_train_state(cuda, cfg, device="cuda")
    batch = lm_batch(cuda, cfg, 4, 64, "cuda")
    with torch.no_grad():
        a, _ = zoo.forward(st["params"], cfg, batch)
        b, _ = zoo.forward(st["params"], cfg, batch)
    assert torch.equal(a, b)
    one = zoo.train_step(tree_map(torch.clone, st), batch, cfg)
    two = zoo.train_step(tree_map(torch.clone, st), batch, cfg)
    assert torch.equal(one[1]["loss"], two[1]["loss"])
    for x, y in zip(tree_leaves(one[0]), tree_leaves(two[0])):
        assert torch.equal(x, y)
