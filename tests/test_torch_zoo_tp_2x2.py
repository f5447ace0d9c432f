"""The zoo's tensor parallelism for serving on a (2, 2) gloo world: two
data slices of two ranks, so the batch is split over the slices too (the
MoE routing then counts the slices before a rank). Every family's
prefill (``zoo.forward``, DeepSeek's ``mtp_logits``) and four
``serve_step`` calls, each rank holding only its spec blocks of the
parameters, the batch and the decode cache (a slot-split cache through
``kv_spec`` where the kv heads are fewer than the model ranks), held to
the port's run without a mesh (``TP_TOL``) and, for Zamba2 and Gemma, to
the JAX package's ``zoo.forward`` / ``serve_step`` (1e-4).

The ranks are ``tests/_torch_zoo_tp_driver.py`` processes (one spawn of
the world for the module); ``tests/test_torch_zoo_tp.py`` runs the same
on (1, 2), and the world of one.
"""
import numpy as np
import pytest

import _torch_zoo_tp as ztp
import _torch_zoo_tp_driver as drv
from _torch_threads import one_torch_thread  # noqa: F401

WORLD, MODEL = 4, 2
NAMES = list(drv.SCENARIOS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_tp_2x2")
    return drv.spawn_world(WORLD, MODEL, d, ztp.write_params(d / "jax.npz"))


@pytest.mark.parametrize("name", NAMES)
def test_outputs_match_mesh_free(ranks, name):
    for res in ranks:
        errs = ztp.values(res, name, "err")
        outs = {k: v for k, v in errs.items() if "/cache/" not in k}
        assert outs and max(outs.values()) <= ztp.TP_TOL, outs


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if drv.config(n).decode_supported])
def test_cache_blocks_match_mesh_free(ranks, name):
    for res in ranks:
        errs = {k: v for k, v in ztp.values(res, name, "err").items()
                if "/cache/" in k}
        assert errs and max(errs.values()) <= ztp.TP_TOL, errs


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_only_its_blocks(ranks, name):
    """Every param and cache leaf a rank holds is exactly its block's
    shape, and the model axis splits some of them."""
    for res in ranks:
        runs = [k for k in res if k.startswith(name + "/")
                and k.endswith("/blocks")]
        assert runs
        for k in runs:
            assert bool(res[k]), k
            assert int(res[k[:-len("blocks")] + "split"]) > 0, k


@pytest.mark.parametrize("arch", ztp.JAX_ARCHS)
def test_ranks_match_the_jax_package(ranks, arch):
    _, runs = ztp.jax_runs()
    for r, res in enumerate(ranks):
        rows = ztp.rank_rows(WORLD, MODEL, r)
        got = ztp.values(res, arch, "out")
        for key, want in runs[arch].items():
            np.testing.assert_allclose(got["plain/" + key], want[rows],
                                       **ztp.JAX_TOL)
            if arch == "gemma-2b":
                np.testing.assert_allclose(got["seq/" + key], want[rows],
                                           **ztp.JAX_TOL)
