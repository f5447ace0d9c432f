"""The zoo's dry run of train pairs on the production meshes
(``repro_torch.launch.dryrun`` with ``--mesh production``): rank 0's
``zoo.train_step(mesh=)`` at ``train_4k`` on its blocks of the train state
(``state_specs(zero=, fsdp=, moe_2d=)``) and of the batch
(``data_specs(include_model=--batch-over-model)``), plain and with each
flag, on 2 × 16 × 16 in a ``fake`` world made in a child process (never in
the test's own; ``tests/test_torch_zoo_dryrun_mesh_train.py``
runs the other mesh; helpers in ``tests/_torch_zoo_dryrun_train.py``).

Each record's argument bytes equal the bytes the reference's specs imply
for rank 0 (``repro.sharding.specs.state_specs`` / ``data_specs`` on the
same shapes), its donated bytes the state's; the collective inventory of a
dense pair (Gemma-2B) and a hybrid pair (Zamba2-1.2B) equals the count
worked out from the reference's param specs (``expected_train``): the
forward's, the backward's, each remat recompute's and the gradient's
reduction over the data group, ``CommDebugMode`` agreeing with the mesh's
log (``run_one`` raises otherwise); the CLI tags a flag's record.
"""
import pytest

import _torch_zoo_dryrun_train as zdt
from _torch_threads import one_torch_thread  # noqa: F401

MULTI_POD = True


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("zoo_dryrun_mesh_train")
    return zdt.run_child(MULTI_POD, out), out


def test_train_records_are_rank0_of_the_production_mesh(records):
    zdt.check_records(MULTI_POD, records[0])


def test_layouts_cut_rank0s_state(records):
    """ZeRO-1 cuts the moments' bytes, ZeRO-3 the params' too; the batch
    over the model axis cuts none."""
    zdt.check_layouts(records[0])


@pytest.mark.parametrize("pair", [0, 1], ids=["dense", "hybrid"])
def test_train_collectives_match_the_spec_count(records, pair):
    zdt.check_collectives(records[0], pair)


def test_the_cli_tags_a_flag_record(records):
    zdt.check_cli(MULTI_POD, *records)
