"""A train state's blocks on the production meshes against the reference's
``repro.sharding.specs.state_specs`` (``tests/test_torch_zoo_specs.py``
holds the specs themselves leaf by leaf): rank 0's blocks of every
registry arch's state at full size on ``meta``, from
``zoo.init_train_state(mesh=)`` and from ``zoo.shard_state``, with each
layout flag on and off, on a stand-in mesh of 16 × 16 and of 2 × 16 × 16
(``.shape``, ``.axis_names``, ``.rank``); and the leaves ZeRO-3 splits on
the stacked layer dim. No process group is made here.
"""
import itertools

import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo_tp import implied_bytes, jax_items, leaf_shapes
from repro.configs import registry as jreg
from repro.sharding import specs as jspecs
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.models import zoo
from repro_torch.sharding import specs
from test_torch_zoo_specs import ARCHS, MESHES, jax_state, stand_in


def _shard(shape, spec, ms: dict) -> tuple:
    out = []
    for d, e in zip(shape, spec):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        n = 1
        for a in axes:
            n *= ms[a]
        out.append(d // n)
    return tuple(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_blocks_match_reference_specs(arch):
    """Rank 0's blocks of a train state at full size (``meta``), from
    ``init_train_state(mesh=)`` and from ``shard_state`` of the whole
    state, with ``zero``, ``fsdp`` and ``moe_2d`` on and off, on both
    production meshes: every leaf has the shape the reference's
    ``state_specs`` implies, and the blocks hold its bytes."""
    cfg, jcfg = registry.get(arch), jreg.get(arch)
    js = jax_state(arch)
    shapes = leaf_shapes(js, True)
    whole = zoo.init_train_state(None, cfg, device="meta")
    assert leaf_shapes(whole, False) == shapes
    size = {tuple(n): l.element_size() for n, l in specs.spec_items(whole)}
    # moe_2d changes only the expert stacks' specs
    moe = (False, True) if cfg.n_experts else (False,)
    for ms, zero, fsdp, moe_2d in itertools.product(
            MESHES.values(), (False, True), (False, True), moe):
        mesh = stand_in(ms)
        want = jax_items(jspecs.state_specs(js, jcfg, 16, zero=zero,
                                            fsdp=fsdp, moe_2d=moe_2d))
        kw = dict(zero=zero, fsdp=fsdp, moe_2d=moe_2d)
        for st in (zoo.init_train_state(None, cfg, "meta", mesh=mesh, **kw),
                   zoo.shard_state(whole, cfg, mesh, **kw)):
            got = leaf_shapes(st, False)
            assert got == {p: _shard(s, want[p], ms)
                           for p, s in shapes.items()}, (ms, kw)
            assert dryrun.nbytes(st) == implied_bytes(shapes, want, ms,
                                                      size), (ms, kw)


# the stacked ``blocks`` leaves ZeRO-3 splits on the layer dim (``zoo``
# gathers them whole before the layers' unbind): none at full size, M = 16
# or 2. xLSTM's ``blocks_list`` is read as if stacked, so its dim 0 is a
# leaf's own first dim; ``_add_fsdp`` takes it for these (a tie of d_model
# rows and columns, or the larger dim)
LAYER_DIM_SPLIT = {}
BLOCKS_LIST_DIM0 = {"xlstm-350m": {"wq", "wk", "wv", "w_if", "w_down",
                                   "w_up", "w_gate"}}


def test_fsdp_splits_on_the_layer_dim():
    layer, dim0 = {}, {}
    for arch, mp in itertools.product(ARCHS, (2, 16)):
        cfg = registry.get(arch)
        tp = zoo.init_params(None, cfg, device="meta")
        for names, spec in specs.spec_items(
                specs.param_specs(tp, cfg, mp, fsdp_axis="data")):
            if spec and spec[0] == "data":
                if names[0] == "blocks":
                    layer.setdefault(arch, set()).add("/".join(names))
                elif names[0] == "blocks_list":
                    dim0.setdefault(arch, set()).add(names[-1])
    assert layer == LAYER_DIM_SPLIT
    assert dim0 == BLOCKS_LIST_DIM0
