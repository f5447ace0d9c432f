"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``gpu``: without a card every test skips (decided in the
``cuda`` fixture, never at import). Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance 3e-5: the kernels sum in fp32 in another order than the plain
versions (and tests/test_kernels.py holds the Pallas kernels to 3e-5)."""
import pytest
import torch

from repro_torch.core.measures import cosine_similarity_matrix
from repro_torch.kernels import edc_cosine as edc_mod
from repro_torch.kernels import madc as madc_mod
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu
TOL = 3e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); the CPU tests cover the plain versions")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n,d,m,dtype", [
    (100, 415_258, 5, torch.float32),     # main path: FEMNIST MLP-512
    (37, 100_003, 3, torch.bfloat16),
    (130, 4_097, 16, torch.float32),
    (9, 333, 11, torch.bfloat16),
    (1, 1, 1, torch.float32),
])
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


@pytest.mark.parametrize("n", [3, 100, 257, 1024])
def test_madc_kernel_matches_plain(cuda, n):
    M = cosine_similarity_matrix(
        torch.randn((n, 64), generator=cuda, device="cuda")).contiguous()
    before = madc_mod.launches
    got = madc_mod.madc(M)
    torch.cuda.synchronize()
    assert madc_mod.launches == before + 1
    assert (got - ref.madc_ref(M)).abs().max().item() <= TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    dW = torch.randn((4, 64), generator=cuda, device="cuda")
    V = torch.randn((64, 2), generator=cuda, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        edc_mod.edc_cosine(dW, V.T.contiguous().T)
    with pytest.raises(TypeError):
        edc_mod.edc_cosine(dW.half(), V)
    with pytest.raises(ValueError, match="range"):
        edc_mod.edc_cosine(dW, torch.randn((64, 17), device="cuda"))
    with pytest.raises(ValueError, match="one CUDA device"):
        edc_mod.edc_cosine(dW, V.cpu())
    with pytest.raises(TypeError):
        madc_mod.madc(torch.eye(4, device="cuda", dtype=torch.float64))
