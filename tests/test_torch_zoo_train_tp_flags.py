"""The train-state layouts of the zoo's tensor parallelism on a (2, 2)
gloo world: ``zero`` (ZeRO-1: the moments' blocks over "data"),
``fsdp`` (ZeRO-3: the params over "data" too, gathered where a layer uses
them), ``batch_over_model`` (the batch over the model axis too, gathered
over the model group at entry) and ``moe_2d`` (Granite-MoE's four smoke
experts over ("data", "model"), one a rank, tokens exchanged over the
world). Each flag's loss, gradients and three steps are held to the port's
run without a mesh (``tests/_torch_zoo_train_tp.py``'s tolerances), and
``zero`` / ``fsdp`` / ``batch_over_model`` to the plain (2, 2) run bit for
bit (every loss, gradient and state block). ``batch_over_model`` where no
leaf is split over "model" (xLSTM on a (1, 3) world: 512 vocab rows do
not divide three) is a data mesh of every rank, held to the run without a
mesh.

The ranks are ``tests/_torch_zoo_train_tp_driver.py`` processes.
"""
import pytest

import _torch_zoo_train_tp as ztt
import _torch_zoo_train_tp_driver as drv
from _torch_threads import one_torch_thread  # noqa: F401

RUNS = [f"{n}/{f}" for n, f in drv.FLAG_RUNS]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return drv.spawn_world(4, 2, tmp_path_factory.mktemp("zoo_train_flags"),
                           "flags")


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    return drv.spawn_world(3, 3, tmp_path_factory.mktemp("zoo_train_flat"),
                           "flat")


@pytest.mark.parametrize("run", RUNS)
def test_flag_matches_mesh_free(ranks, run):
    name, flag = run.split("/")
    for res in ranks:
        assert f"{run}/loss" in res
    ztt.check_runs([{k: v for k, v in res.items()
                     if not k.startswith(name + "/")
                     or k.startswith(run + "/")} for res in ranks], name)
    ztt.check_replicated([{k: v for k, v in res.items()
                           if k.startswith(run + "/")} for res in ranks],
                         name, 2)


@pytest.mark.parametrize("run", [r for r in RUNS
                                 if r.split("/")[1] in drv.BITWISE])
def test_flag_equals_the_plain_mesh_run_bit_for_bit(ranks, run):
    for res in ranks:
        assert ztt.value(res, f"{run}/vs_plain") == 0.0


def test_batch_over_a_model_axis_that_splits_nothing(flat):
    for res in flat:
        assert ztt.value(res, "xlstm-350m/flat/rows") == \
            drv.FLAT_B // len(flat)
    ztt.check_runs(flat, "xlstm-350m")
