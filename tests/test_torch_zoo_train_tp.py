"""The zoo's tensor parallelism for training on a (1, 2) gloo world: every
family's ``zoo.loss_and_grads`` and three ``zoo.train_step`` calls on two
ranks, each holding only its ``state_specs`` blocks of the train state
(``zoo.shard_state``), held to the port's run without a mesh
(``tests/_torch_zoo_train_tp.py``'s tolerances: the loss and every
gathered gradient within 1e-5), the gradients the specs replicate equal
on both ranks; Zamba2 and Gemma from the JAX package's
``init_train_state`` (``train_state_from_numpy(mesh=)``) against its
``loss_fn`` gradients and three ``train_step``s at its training tests'
tolerances; and a world of one made in this process, equal to
``mesh=None`` bit for bit.

The ranks are ``tests/_torch_zoo_train_tp_driver.py`` processes (one spawn
of the world for the module); ``_2x2.py`` runs the same on (2, 2),
``_flags.py`` the layouts' flags.
"""
import pytest
import torch

import _torch_zoo_train_tp as ztt
import _torch_zoo_train_tp_driver as drv
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import zoo
from repro_torch.models.modules import tree_leaves

WORLD, MODEL = 2, 2
SHAPE = {"data": WORLD // MODEL, "model": MODEL}
NAMES = list(drv.SCENARIOS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_train_tp_1x2")
    return drv.spawn_world(WORLD, MODEL, d, "plain",
                           ztt.jax_npz(str(d / "jax.npz")))


@pytest.mark.parametrize("name", NAMES)
def test_loss_grads_and_steps_match_mesh_free(ranks, name):
    ztt.check_runs(ranks, name)


@pytest.mark.parametrize("name", NAMES)
def test_replicated_gradients_equal_on_the_model_group(ranks, name):
    ztt.check_replicated(ranks, name, MODEL)


@pytest.mark.parametrize("arch", ztt.JAX_ARCHS)
def test_ranks_match_the_jax_package(ranks, arch):
    ztt.check_jax(ranks, arch, SHAPE)


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    store = tmp_path_factory.mktemp("zoo_train_tp_1x1") / "store"
    mesh_lib.init_process_group("cpu", init_method=f"file://{store}",
                                rank=0, world_size=1)
    try:
        yield mesh_lib.make_fed_mesh(1, 1, device="cpu")
    finally:
        mesh_lib.destroy_process_group()


@pytest.mark.parametrize("name", NAMES)
def test_world_of_one_is_mesh_free_bit_for_bit(world_of_one, name):
    """The loss, every gradient and the state after three steps: with the
    layout flags too (a data axis of one splits nothing)."""
    cfg = drv.config(name)
    state, batch = drv.whole_state(cfg), drv.train_batch(cfg, drv.B)
    r_loss, r_grads, r_losses, r_st = drv.none_run(cfg, state, batch)
    flags = {"zero": True, "fsdp": True, "batch_over_model": True}
    if cfg.n_experts:
        flags["moe_2d"] = True
    for kw in ({}, flags):
        local = zoo.shard_state(drv.clone(state), cfg, world_of_one, **{
            k: v for k, v in kw.items() if k != "batch_over_model"})
        g_loss, g_grads, g_losses, g_st = drv.mesh_run(
            cfg, local, batch, world_of_one, kw)
        assert g_loss == r_loss and g_losses == r_losses, kw
        for a, b in zip(g_grads, r_grads):
            assert torch.equal(a, b), kw
        for key in ("params", "mu", "nu"):
            for a, b in zip(tree_leaves(g_st[key]), tree_leaves(r_st[key])):
                assert torch.equal(a, b), (kw, key)
        assert int(g_st["step"]) == 3 and g_st["step"].dtype == torch.int32
