"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``gpu``: without a card every test skips (decided in the
``cuda`` fixture, never at import). Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance 3e-5 (SSD 2e-4, whose outputs are sums of ~Q products of size
~N): the kernels sum in fp32 in another order than the plain versions,
from the same inputs (tests/test_kernels.py holds the Pallas kernels to
the same tolerances). ``swa_attention``'s tensor-core route (bf16 q, k, v,
hd 64 or 128) rounds P to bf16 before P·V, as the JAX zoo's ``sdpa`` does,
while the plain version keeps P in fp32: 1e-2 there (2⁻⁹ relative per
probability, over |v| ≲ 4; tests/test_torch_kernel_routes.py emulates the
route on the CPU against the same bound). ``ssd_intra_chunk``'s
tensor-core route (bf16 X, B, C with Q 64 or 128, P = N = 64) splits its
fp32 operands into three bf16 terms and is held to the same 2e-4 as the
fp32 route, in both decay regimes (tests/test_torch_ssd_routes.py
emulates it on the CPU)."""
import pytest
import torch

from repro_torch.core.measures import cosine_similarity_matrix
from repro_torch.kernels import edc_cosine as edc_mod
from repro_torch.kernels import madc as madc_mod
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import ssd_chunk as ssd_mod
from repro_torch.kernels import swa_attention as swa_mod

pytestmark = pytest.mark.gpu
TOL = 3e-5
SSD_TOL = 2e-4
SWA_TOL = {"tc": 1e-2, "fp32": TOL}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); the CPU tests cover the plain versions")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n,d,m,dtype", [
    (100, 415_258, 5, torch.float32),     # main path: FEMNIST MLP-512
    (200, 415_258, 20, torch.float32),    # 20 groups: two column tiles
    (37, 100_003, 3, torch.bfloat16),
    (130, 4_097, 16, torch.float32),
    (9, 333, 11, torch.bfloat16),
    (1, 1, 1, torch.float32),
] + [(70, 5_000, m, dt) for m in (1, 5, 16, 17, 32, 100)
     for dt in (torch.float32, torch.bfloat16)])
def test_edc_cosine_kernel_matches_plain(cuda, n, d, m, dtype):
    dW = torch.randn((n, d), generator=cuda, device="cuda").to(dtype)
    V = torch.randn((d, m), generator=cuda, device="cuda").to(dtype)
    before = edc_mod.launches
    got = edc_mod.edc_cosine(dW, V)
    torch.cuda.synchronize()
    assert edc_mod.launches == before + 1
    assert (got - ref.cosine_block_ref(dW, V)).abs().max().item() <= TOL
    again = edc_mod.edc_cosine(dW, V)
    assert torch.equal(got, again)               # deterministic reduction


@pytest.mark.parametrize("m", [5, 32])
def test_edc_cosine_is_bit_repeatable(cuda, m):
    """Runs with other plans between them, sharing the partials'
    workspace, give the same bits (no float atomics)."""
    dW = torch.randn((200, 415_258), generator=cuda, device="cuda")
    V = torch.randn((415_258, m), generator=cuda, device="cuda")
    first = edc_mod.edc_cosine(dW, V)
    small = torch.randn((9, 333), generator=cuda, device="cuda")
    for _ in range(3):
        edc_mod.edc_cosine(small, torch.randn((333, 100), generator=cuda,
                                              device="cuda"))
        assert torch.equal(edc_mod.edc_cosine(dW, V), first)
    lib = build.library()
    p = edc_mod.plan(200, 415_258, m, build.sm_count(0))
    assert lib.edc_cosine_scratch(200, m, p.ns) == p.scratch_floats


@pytest.mark.parametrize("n", [1, 2, 3, 15, 16, 17, 63, 64, 65, 100, 257,
                               1024])
def test_madc_kernel_matches_plain(cuda, n):
    M = cosine_similarity_matrix(
        torch.randn((n, 64), generator=cuda, device="cuda")).contiguous()
    before = madc_mod.launches
    got = madc_mod.madc(M)
    torch.cuda.synchronize()
    assert madc_mod.launches == before + 1
    assert (got - ref.madc_ref(M)).abs().max().item() <= TOL
    assert torch.equal(got, got.T)               # only one triangle computed
    assert (got.diagonal() == 0).all()


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_madc_every_tile_edge_gives_the_same_result(cuda, tile):
    M = cosine_similarity_matrix(
        torch.randn((200, 64), generator=cuda, device="cuda")).contiguous()
    got = madc_mod.madc(M, tile=tile)
    assert (got - ref.madc_ref(M)).abs().max().item() <= TOL
    assert torch.equal(got, got.T)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    dW = torch.randn((4, 64), generator=cuda, device="cuda")
    V = torch.randn((64, 2), generator=cuda, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        edc_mod.edc_cosine(dW, V.T.contiguous().T)
    with pytest.raises(TypeError):
        edc_mod.edc_cosine(dW.half(), V)
    with pytest.raises(ValueError, match="range"):
        edc_mod.edc_cosine(dW, torch.randn((64, 0), device="cuda"))
    with pytest.raises(ValueError, match="one CUDA device"):
        edc_mod.edc_cosine(dW, V.cpu())
    with pytest.raises(TypeError):
        madc_mod.madc(torch.eye(4, device="cuda", dtype=torch.float64))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,window,causal,dtype", [
    (4, 2048, 2048, 32, 32, 64, None, True, torch.bfloat16),  # Zamba2 prefill
    (4, 2048, 2048, 32, 32, 64, 512, True, torch.bfloat16),
    (4, 1, 2048, 32, 32, 64, None, True, torch.bfloat16),     # decode tail
    (2, 33, 65, 2, 2, 40, 16, True, torch.float32),           # unaligned
    (1, 96, 96, 2, 2, 80, None, False, torch.float32),        # bidirectional
    (2, 70, 70, 4, 2, 256, 20, True, torch.float32),          # GQA, hd 256
    (1, 5, 300, 3, 1, 128, 7, False, torch.bfloat16),
    # the tensor-core route
    (2, 256, 256, 4, 4, 128, None, True, torch.bfloat16),     # hd 128
    (2, 300, 300, 8, 2, 64, None, True, torch.bfloat16),      # GQA, KV < H
    (1, 200, 333, 4, 4, 64, None, True, torch.bfloat16),      # Sk % 128 != 0
    (2, 100, 700, 4, 4, 64, None, True, torch.bfloat16),      # Sq < Sk
    (1, 1024, 1024, 4, 4, 64, 512, True, torch.bfloat16),     # row's first
    (1, 512, 512, 4, 4, 64, 40, True, torch.bfloat16),        # tile masked
    (1, 300, 300, 2, 2, 64, None, False, torch.bfloat16),     # non-causal
    (1, 300, 300, 2, 1, 128, 64, False, torch.bfloat16),
    # the fp32 route: Zamba2's fp32 forward, bf16 at another head dim
    (1, 256, 256, 32, 32, 64, None, True, torch.float32),
    (1, 130, 130, 2, 2, 80, 32, True, torch.bfloat16),
])
def test_swa_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, hd, window, causal,
                                  dtype):
    q = torch.randn((B, Sq, H, hd), generator=cuda, device="cuda").to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=cuda, device="cuda").to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=cuda, device="cuda").to(dtype)
    route = swa_mod._route(dtype, dtype, hd)
    before, by_route = swa_mod.launches, dict(swa_mod.launches_by_route)
    got = swa_mod.swa_attention(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert swa_mod.launches == before + 1
    assert swa_mod.launches_by_route[route] == by_route[route] + 1
    want = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    assert torch.isfinite(got).all()
    tol = SWA_TOL[route]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("window,causal", [(None, True), (512, True),
                                           (None, False)])
def test_swa_routes_agree(cuda, window, causal):
    """The same bf16 inputs on the tensor-core route, and upcast to fp32 on
    the CUDA-core route."""
    q, k, v = (torch.randn((2, 1024, 8, 64), generator=cuda,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    tc = swa_mod.swa_attention(q, k, v, window=window, causal=causal)
    before = swa_mod.launches_by_route["fp32"]
    f32 = swa_mod.swa_attention(q.float(), k.float(), v.float(),
                                window=window, causal=causal)
    assert swa_mod.launches_by_route["fp32"] == before + 1
    torch.testing.assert_close(tc, f32, atol=1e-2, rtol=1e-2)


def test_swa_tc_route_raises_on_what_tma_cannot_load(cuda):
    q = torch.randn((1, 128, 2, 68), generator=cuda, device="cuda").to(
        torch.bfloat16)[..., :64]                 # head stride 136 bytes
    k = torch.randn((1, 128, 2, 64), generator=cuda, device="cuda").to(
        torch.bfloat16)
    before = dict(swa_mod.launches_by_route)
    with pytest.raises(ValueError, match="16 bytes"):
        swa_mod.swa_attention(q, k, k)
    flat = torch.randn(1 + 128 * 2 * 64, generator=cuda, device="cuda").to(
        torch.bfloat16)
    shifted = flat[1:].view(1, 128, 2, 64)        # 2 bytes past alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        swa_mod.swa_attention(shifted, k, k)
    assert swa_mod.launches_by_route == before    # never another route


def _ssd_cells(gen, BH, NC, Q, P, N, dtype):
    X = torch.randn((BH, NC, Q, P), generator=gen, device="cuda").to(dtype)
    dtA = -torch.nn.functional.softplus(
        torch.randn((BH, NC, Q), generator=gen, device="cuda"))
    B = torch.randn((BH, NC, Q, N), generator=gen, device="cuda").to(dtype)
    C = torch.randn((BH, NC, Q, N), generator=gen, device="cuda").to(dtype)
    return X, torch.cumsum(dtA, -1), B, C


@pytest.mark.parametrize("BH,NC,Q,P,N,dtype", [
    (256, 16, 128, 64, 64, torch.bfloat16),    # Zamba2 prefill, B = 4
    (256, 16, 128, 64, 64, torch.float32),
    (6, 3, 37, 23, 11, torch.float32),         # unaligned
    (2, 2, 16, 8, 128, torch.bfloat16),
])
def test_ssd_kernel_matches_plain(cuda, BH, NC, Q, P, N, dtype):
    X, A_cs, B, C = _ssd_cells(cuda, BH, NC, Q, P, N, dtype)
    before = ssd_mod.launches
    Y, S = ssd_mod.ssd_intra_chunk_cells(X, A_cs, B, C)
    torch.cuda.synchronize()
    assert ssd_mod.launches == before + 1
    Yr, Sr = ref.ssd_intra_chunk_ref(X[:, :, :, None], A_cs[:, None],
                                     B[:, :, :, None], C[:, :, :, None])
    torch.testing.assert_close(Y, Yr[:, :, :, 0], atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(S, Sr[:, :, 0].transpose(-1, -2),
                               atol=SSD_TOL, rtol=SSD_TOL)


def test_ssd_kernel_reads_the_models_layout(cuda):
    """(b, l, h, p) X and stride-0 head-expanded B/C, as ``ssd_chunked``
    passes them."""
    b, c, Q, h, p, n = 2, 3, 128, 8, 64, 64
    X = torch.randn((b, c * Q, h, p), generator=cuda, device="cuda").to(
        torch.bfloat16)
    Bg = torch.randn((b, c * Q, 1, n), generator=cuda, device="cuda").to(
        torch.bfloat16)
    Cg = torch.randn((b, c * Q, 1, n), generator=cuda, device="cuda").to(
        torch.bfloat16)
    dtA = -torch.nn.functional.softplus(
        torch.randn((b, h, c, Q), generator=cuda, device="cuda"))
    args = (X.reshape(b, c, Q, h, p), torch.cumsum(dtA, -1),
            Bg.expand(b, c * Q, h, n).reshape(b, c, Q, h, n),
            Cg.expand(b, c * Q, h, n).reshape(b, c, Q, h, n))
    assert args[2].stride(3) == 0
    Y, S = ssd_mod.ssd_intra_chunk(*args)
    Yr, Sr = ref.ssd_intra_chunk_ref(*args)
    torch.testing.assert_close(Y, Yr, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(S, Sr, atol=SSD_TOL, rtol=SSD_TOL)


SSD_DECAY = {"fast": 1.0, "slow": 0.01}   # dtA = -scale · softplus(randn)


def _ssd_model_args(gen, b, c, Q, h, *, decay="fast", per_head=False,
                    p=64, n=64, dtype=torch.bfloat16):
    """As ``ssd_chunked`` passes them: X (b, l, h, p) split into chunks by a
    view; B/C one group expanded over the heads with stride 0, or one per
    head (``per_head``). ``decay="slow"`` keeps L ~ 1 across the chunk."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    X = randn(b, c * Q, h, p).to(dtype).reshape(b, c, Q, h, p)
    dtA = -SSD_DECAY[decay] * torch.nn.functional.softplus(randn(b, h, c, Q))
    if per_head:
        Bc, Cc = (randn(b, c * Q, h, n).to(dtype).reshape(b, c, Q, h, n)
                  for _ in range(2))
    else:
        Bc, Cc = (randn(b, c * Q, 1, n).to(dtype).expand(
            b, c * Q, h, n).reshape(b, c, Q, h, n) for _ in range(2))
    return X, torch.cumsum(dtA, -1), Bc, Cc


@pytest.mark.parametrize("b,c,Q,h,decay,per_head", [
    (4, 16, 128, 64, "fast", False),   # Zamba2 prefill, B = 4
    (4, 16, 128, 64, "slow", False),
    (2, 3, 128, 8, "fast", True),      # B/C per head
    (2, 3, 128, 8, "slow", True),
    (2, 4, 64, 8, "fast", False),      # Q = 64
    (2, 4, 64, 8, "slow", True),
    (1, 2, 128, 1, "slow", False),     # one head
    (4, 16, 128, 13, "fast", False),   # a last head block of one head
])
def test_ssd_tc_route_matches_plain(cuda, b, c, Q, h, decay, per_head):
    args = _ssd_model_args(cuda, b, c, Q, h, decay=decay, per_head=per_head)
    if h > 1 and not per_head:
        assert args[2].stride(3) == 0 and args[3].stride(3) == 0
    assert ssd_mod._route(args[0].dtype, args[2].dtype, Q, 64, 64) == "tc"
    before = dict(ssd_mod.launches_by_route)
    Y, S = ssd_mod.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_mod.launches_by_route == {"tc": before["tc"] + 1,
                                         "fp32": before["fp32"]}
    Yr, Sr = ref.ssd_intra_chunk_ref(*args)
    assert torch.isfinite(Y).all() and torch.isfinite(S).all()
    torch.testing.assert_close(Y, Yr, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(S, Sr, atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("decay", ["fast", "slow"])
def test_ssd_routes_agree(cuda, decay):
    """The same bf16 inputs on the tensor-core route, and cast exactly to
    fp32 on the CUDA-core route."""
    args = _ssd_model_args(cuda, 2, 4, 128, 8, decay=decay)
    Y, S = ssd_mod.ssd_intra_chunk(*args)
    before = dict(ssd_mod.launches_by_route)
    Y32, S32 = ssd_mod.ssd_intra_chunk(*(t.float() for t in args))
    assert ssd_mod.launches_by_route == {"tc": before["tc"],
                                         "fp32": before["fp32"] + 1}
    torch.testing.assert_close(Y, Y32, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(S, S32, atol=SSD_TOL, rtol=SSD_TOL)


def test_ssd_tc_route_raises_on_what_tma_cannot_load(cuda):
    X, A_cs, Bc, Cc = _ssd_model_args(cuda, 1, 2, 128, 2)
    before = dict(ssd_mod.launches_by_route)
    wide = torch.randn((1, 256, 2, 68), generator=cuda, device="cuda").to(
        torch.bfloat16)[..., :64].reshape(1, 2, 128, 2, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        ssd_mod.ssd_intra_chunk(wide, A_cs, Bc, Cc)   # head stride 136 B
    flat = torch.randn(1 + X.numel(), generator=cuda, device="cuda").to(
        torch.bfloat16)
    shifted = flat[1:].view(X.shape)                  # 2 bytes past alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_mod.ssd_intra_chunk(shifted, A_cs, Bc, Cc)
    a_qmajor = A_cs.transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_mod.ssd_intra_chunk(X, a_qmajor, Bc, Cc)
    assert ssd_mod.launches_by_route == before        # never another route


@pytest.mark.parametrize("window", [None, 8])
def test_zamba2_smoke_forward_on_card_matches_cpu(cuda, window):
    """One smoke forward through both kernels against the same forward on
    the CPU (plain versions), fp32: 38-layer launch counts scale down to
    the smoke's 2 Mamba2 layers and 1 shared-block application."""
    from repro_torch.configs import registry
    from repro_torch.models import zoo
    from repro_torch.models.modules import tree_map
    cfg = registry.smoke_variant(registry.get("zamba2-1.2b"))
    if window:
        cfg = cfg.with_window(window)
    params = zoo.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 48),
                        generator=torch.Generator().manual_seed(1))
    want, _ = zoo.forward(params, cfg, {"tokens": tok})
    ops.reset_launch_counts()
    got, _ = zoo.forward(tree_map(lambda t: t.cuda(), params), cfg,
                         {"tokens": tok.cuda()})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ssd_intra_chunk"] == 2 and counts["swa_attention"] == 1
    assert counts["swa_attention.fp32"] == 1
    assert counts["ssd_intra_chunk.fp32"] == 2
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_zoo_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn((1, 8, 2, 64), generator=cuda, device="cuda")
    with pytest.raises(TypeError):
        swa_mod.swa_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="range"):
        big = torch.zeros((1, 8, 2, 264), device="cuda")
        swa_mod.swa_attention(big, big, big)
    with pytest.raises(ValueError, match="one CUDA device"):
        swa_mod.swa_attention(q, q.cpu(), q.cpu())
    X, A_cs, B, C = _ssd_cells(cuda, 2, 1, 256, 8, 8, torch.float32)
    with pytest.raises(ValueError, match="range"):
        ssd_mod.ssd_intra_chunk_cells(X, A_cs, B, C)
    X, A_cs, B, C = _ssd_cells(cuda, 2, 1, 16, 8, 8, torch.float32)
    with pytest.raises(TypeError):
        ssd_mod.ssd_intra_chunk_cells(X, A_cs.double(), B, C)


# ---------------------------------------------------------------------------
# the fp32 routes (3xTF32 tensor-core kernels), every input they take
# ---------------------------------------------------------------------------

f32, bf = torch.float32, torch.bfloat16


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,window,causal,dq,dkv", [
    (1, 256, 256, 32, 32, 64, None, True, f32, f32),    # Zamba2 fp32: split
    (1, 256, 256, 32, 32, 64, 64, True, f32, f32),
    (4, 2048, 2048, 32, 32, 64, None, True, f32, f32),  # fp32 prefill
    (2, 33, 65, 2, 2, 40, 16, True, f32, f32),          # hd 40, Sq < Sk
    (1, 96, 96, 2, 2, 80, None, False, f32, f32),       # hd 80
    (2, 70, 70, 4, 2, 256, 20, True, f32, f32),         # hd 256, GQA
    (1, 300, 300, 2, 2, 192, None, True, f32, f32),     # hd 192
    (2, 100, 700, 4, 4, 64, None, True, bf, f32),       # mixed dtypes
    (2, 100, 700, 4, 1, 64, 50, True, f32, bf),
    (1, 130, 130, 2, 2, 80, 32, True, bf, bf),          # bf16, hd 80
    (1, 77, 77, 3, 3, 37, None, False, bf, bf),         # odd hd: no vector
    (1, 1, 2048, 8, 8, 64, None, True, f32, f32),       # decode tail
])
def test_swa_fp32_route_matches_plain(cuda, B, Sq, Sk, H, KV, hd, window,
                                      causal, dq, dkv):
    q = torch.randn((B, Sq, H, hd), generator=cuda, device="cuda").to(dq)
    k = torch.randn((B, Sk, KV, hd), generator=cuda, device="cuda").to(dkv)
    v = torch.randn((B, Sk, KV, hd), generator=cuda, device="cuda").to(dkv)
    assert swa_mod._route(dq, dkv, hd) == "fp32"
    before = swa_mod.launches_by_route["fp32"]
    got = swa_mod.swa_attention(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert swa_mod.launches_by_route["fp32"] == before + 1
    want = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    again = swa_mod.swa_attention(q, k, v, window=window, causal=causal)
    assert torch.equal(got, again)             # the cached plan, same result


@pytest.mark.parametrize("b,c,Q,h,p,n,decay,per_head,dtype", [
    (1, 2, 128, 64, 64, 64, "fast", False, f32),   # Zamba2's fp32 forward
    (1, 2, 128, 64, 64, 64, "slow", False, f32),
    (4, 16, 128, 64, 64, 64, "fast", False, f32),  # its fp32 prefill
    (4, 16, 128, 64, 64, 64, "slow", False, f32),
    (2, 3, 128, 8, 64, 64, "slow", True, f32),     # B/C per head
    (2, 3, 37, 5, 23, 11, "slow", True, f32),      # unaligned
    (2, 3, 37, 5, 23, 11, "fast", False, bf),
    (2, 3, 100, 4, 64, 128, "slow", False, f32),   # N = 128
    (2, 4, 64, 6, 33, 100, "fast", True, bf),
    (1, 2, 96, 13, 64, 64, "fast", False, bf),     # bf16, Q = 96
])
def test_ssd_fp32_route_matches_plain(cuda, b, c, Q, h, p, n, decay,
                                      per_head, dtype):
    args = _ssd_model_args(cuda, b, c, Q, h, decay=decay, per_head=per_head,
                           p=p, n=n, dtype=dtype)
    assert ssd_mod._route(args[0].dtype, args[2].dtype, Q, p, n) == "fp32"
    before = dict(ssd_mod.launches_by_route)
    Y, S = ssd_mod.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_mod.launches_by_route == {"tc": before["tc"],
                                         "fp32": before["fp32"] + 1}
    Yr, Sr = ref.ssd_intra_chunk_ref(*args)
    assert torch.isfinite(Y).all() and torch.isfinite(S).all()
    torch.testing.assert_close(Y, Yr, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(S, Sr, atol=SSD_TOL, rtol=SSD_TOL)


def test_fp32_routes_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn((1, 8, 2, 48), generator=cuda, device="cuda")
    kt = torch.randn((1, 8, 2, 48), generator=cuda,
                     device="cuda").transpose(1, 3).contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        swa_mod.swa_attention(q, kt.transpose(1, 3), q)
    with pytest.raises(TypeError):
        swa_mod.swa_attention(q, q, q.to(torch.bfloat16))
    for p, n, Q in ((65, 8, 16), (8, 129, 16)):
        X, A_cs, B, C = _ssd_cells(cuda, 2, 1, Q, p, n, torch.float32)
        for _ in range(2):                     # a refusal is never cached
            with pytest.raises(ValueError, match="range"):
                ssd_mod.ssd_intra_chunk_cells(X, A_cs, B, C)
    X, A_cs, B, C = _ssd_cells(cuda, 2, 1, 16, 8, 8, torch.float32)
    with pytest.raises(TypeError):
        ssd_mod.ssd_intra_chunk_cells(X, A_cs, B.to(torch.bfloat16), C)


def test_swa_split_workspace_is_shared_in_order(cuda):
    """Split-KV launches of different plans, one after another on one
    stream, share the partials' workspace: each result still matches its
    plain version, also after the workspace has grown."""
    shapes = [(1, 256, 256, 32, 64), (1, 1, 2048, 8, 64),
              (1, 256, 256, 32, 64), (2, 200, 900, 8, 80),
              (1, 1, 2048, 8, 64)]
    for B, Sq, Sk, H, hd in shapes:
        q = torch.randn((B, Sq, H, hd), generator=cuda, device="cuda")
        k = torch.randn((B, Sk, H, hd), generator=cuda, device="cuda")
        v = torch.randn((B, Sk, H, hd), generator=cuda, device="cuda")
        assert swa_mod.swa_plan(B * H, Sq, Sk, hd, None, True,
                                build.sm_count(0))[1] > 1
        got = swa_mod.swa_attention(q, k, v)
        want = ref.swa_attention_ref(q, k, v, window=None, causal=True)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
