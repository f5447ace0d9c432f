"""The zoo's tensor parallelism for training on a (2, 2) gloo world: two
data slices of two ranks, so the batch is split over the slices too (the
cross-entropy's count and the MoE aux losses summed over them, each
gradient summed over them after the backward, the MoE routing counting
the slices before a rank). Every family's ``zoo.loss_and_grads`` and
three ``zoo.train_step`` calls, each rank holding only its
``state_specs`` blocks, held to the port's run without a mesh
(``tests/_torch_zoo_train_tp.py``'s tolerances: the loss and every
gathered gradient within 1e-5), the gradients the specs replicate equal
on each model group.

The ranks are ``tests/_torch_zoo_train_tp_driver.py`` processes (one spawn
of the world for the module); ``tests/test_torch_zoo_train_tp.py`` runs
the same on (1, 2) with the JAX package and the world of one.
"""
import pytest

import _torch_zoo_train_tp as ztt
import _torch_zoo_train_tp_driver as drv
from _torch_threads import one_torch_thread  # noqa: F401

WORLD, MODEL = 4, 2
NAMES = list(drv.SCENARIOS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return drv.spawn_world(WORLD, MODEL,
                           tmp_path_factory.mktemp("zoo_train_tp_2x2"),
                           "plain")


@pytest.mark.parametrize("name", NAMES)
def test_loss_grads_and_steps_match_mesh_free(ranks, name):
    ztt.check_runs(ranks, name)


@pytest.mark.parametrize("name", NAMES)
def test_replicated_gradients_equal_on_each_model_group(ranks, name):
    ztt.check_replicated(ranks, name, MODEL)
