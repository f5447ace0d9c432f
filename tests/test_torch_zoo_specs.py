"""The architecture half of ``repro_torch.sharding.specs`` against
``repro.sharding.specs``, leaf by leaf, for every registry arch at full
size (shapes only: the JAX trees from ``jax.eval_shape``, the port's on
``meta``), and a rank's blocks (``shard_shape``, ``local_block``).

The JAX functions read a mesh only through ``.shape`` and ``.axis_names``,
so one stand-in serves both packages: the production meshes 16 × 16 and
2 × 16 × 16 without their 512 devices. No process group is made here.
"""
import itertools
import types

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo_tp import implied_bytes, jax_items, leaf_shapes
from repro.configs import registry as jreg
from repro.configs import shapes as jshp
from repro.models import zoo as jzoo
from repro.sharding import specs as jspecs
from repro_torch.configs import registry
from repro_torch.configs import shapes as shp
from repro_torch.launch import dryrun
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import zoo
from repro_torch.sharding import specs

ARCHS = list(registry.ARCHS)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
DECODE = ("decode_32k", "long_500k")


def stand_in(shape: dict, rank: int = 0):
    """A mesh as the specs read it (and ``zoo.init_cache(mesh=)``)."""
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape),
                                 rank=rank, model_shards=shape["model"])


def port_items(tree) -> dict:
    return {tuple(n): s for n, s in specs.spec_items(tree)}


def jax_params(arch: str):
    return jax.eval_shape(lambda k: jzoo.init_params(k, jreg.get(arch)),
                          jax.random.PRNGKey(0))


def jax_state(arch: str):
    return jax.eval_shape(lambda k: jzoo.init_train_state(k, jreg.get(arch)),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch,mp", list(itertools.product(ARCHS, (16, 2))))
def test_param_specs_match_reference(arch, mp):
    jp = jax_params(arch)
    tp = zoo.init_params(None, registry.get(arch), device="meta")
    for fsdp, moe_2d in itertools.product((None, "data"), (False, True)):
        want = jax_items(jspecs.param_specs(jp, jreg.get(arch), mp,
                                            fsdp_axis=fsdp, moe_2d=moe_2d))
        got = port_items(specs.param_specs(tp, registry.get(arch), mp,
                                           fsdp_axis=fsdp, moe_2d=moe_2d))
        assert got == want, (fsdp, moe_2d)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(arch):
    js = jax_state(arch)
    ts = zoo.init_train_state(None, registry.get(arch), device="meta")
    for zero, fsdp in itertools.product((False, True), (False, True)):
        want = jspecs.state_specs(js, jreg.get(arch), zero=zero, fsdp=fsdp)
        got = specs.state_specs(ts, registry.get(arch), zero=zero,
                                fsdp=fsdp)
        for k in ("params", "mu", "nu"):
            assert port_items(got[k]) == jax_items(want[k]), (k, zero, fsdp)
        assert got["step"] == tuple(want["step"]) == ()


def _caches(arch: str, shape_name: str):
    shape, jshape = shp.SHAPES[shape_name], jshp.SHAPES[shape_name]
    cfg = shp.config_for(registry.get(arch), shape)
    jcfg = jshp.config_for(jreg.get(arch), jshape)
    slots = shp.cache_len(cfg, shape)
    jc = jax.eval_shape(lambda: jzoo.init_cache(jcfg, jshape.global_batch,
                                                slots))
    tc = zoo.init_cache(cfg, shape.global_batch, slots, device="meta")
    return cfg, jcfg, jc, tc


@pytest.mark.parametrize("arch,shape_name", [
    (a, s) for a in ARCHS for s in DECODE
    if registry.get(a).decode_supported])
def test_cache_specs_match_reference(arch, shape_name):
    cfg, jcfg, jc, tc = _caches(arch, shape_name)
    assert leaf_shapes(tc, False) == leaf_shapes(jc, True)
    for (name, ms), seq in itertools.product(MESHES.items(), (False, True)):
        mesh = stand_in(ms)
        want = jax_items(jspecs.cache_specs(jc, jcfg, mesh, seq_shard=seq))
        got = port_items(specs.cache_specs(tc, cfg, mesh, seq_shard=seq))
        assert got == want, (name, seq)


@pytest.mark.parametrize("arch", ARCHS)
def test_data_specs_and_batch_axes_match_reference(arch):
    cfg, jcfg = registry.get(arch), jreg.get(arch)
    for name in shp.SHAPES:
        shape, jshape = shp.SHAPES[name], jshp.SHAPES[name]
        ok, _ = shp.supported(cfg, shape)
        if not ok:
            continue
        ins = dryrun.input_specs(shp.config_for(cfg, shape), shape)
        ins.pop("cache", None)
        jins = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.int32)
                for k, v in ins.items()}
        for ms, inc in itertools.product(MESHES.values(), (False, True)):
            mesh = stand_in(ms)
            assert specs.batch_axes(mesh) == jspecs.batch_axes(mesh)
            want = jax_items(jspecs.data_specs(jins, mesh, include_model=inc))
            got = port_items(specs.data_specs(ins, mesh, include_model=inc))
            assert got == want, (name, ms, inc)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_blocks_hold_the_bytes_the_reference_spec_implies(arch):
    """Rank 0's blocks (``shard_shape``) of the params and of each decode
    cache hold exactly the bytes the reference's specs imply on both
    production meshes."""
    cfg = registry.get(arch)
    tp = zoo.init_params(None, cfg, device="meta")
    jp = jax_params(arch)
    items = {tuple(n): l.element_size() for n, l in specs.spec_items(tp)}
    for ms in MESHES.values():
        mesh = stand_in(ms)
        want = implied_bytes(leaf_shapes(jp, True), jax_items(
            jspecs.param_specs(jp, jreg.get(arch), 16)), ms, items)
        blocks = specs.tree_blocks(tp, specs.param_specs(tp, cfg, 16), mesh)
        assert dryrun.nbytes(blocks) == want
        for name in DECODE if cfg.decode_supported else ():
            c, jcfg, jc, tc = _caches(arch, name)
            for seq in (False, True):
                sz = {tuple(n): l.element_size()
                      for n, l in specs.spec_items(tc)}
                want = implied_bytes(leaf_shapes(jc, True), jax_items(
                    jspecs.cache_specs(jc, jcfg, mesh, seq_shard=seq)), ms,
                    sz)
                got = zoo.init_cache(c, shp.SHAPES[name].global_batch,
                                     shp.cache_len(c, shp.SHAPES[name]),
                                     device="meta", mesh=mesh,
                                     seq_shard=seq)
                assert dryrun.nbytes(got) == want, (name, seq)


def test_local_block_and_coords():
    """Rank r's coordinates are row-major over the axes (model fastest, as
    ``launch.mesh`` numbers ranks); a block is the rank's slice of each
    dim, an entry of two axes counting them row-major."""
    ms = {"pod": 2, "data": 2, "model": 2}
    mesh = stand_in(ms, rank=6)
    assert specs.mesh_coords(mesh) == {"pod": 1, "data": 1, "model": 0}
    t = torch.arange(8 * 6).reshape(8, 6)
    spec = (("pod", "data"), "model")
    assert specs.shard_shape(t.shape, spec, mesh) == (2, 3)
    blk = specs.local_block(t, spec, mesh)
    assert torch.equal(blk, t[6:8, 0:3])
    assert specs.local_block(t, (None, None), mesh) is t
    with pytest.raises(ValueError, match="does not divide"):
        specs.shard_shape((5, 6), ("model", None), mesh)
    whole = torch.cat([specs.local_block(t, (None, "model"),
                                         stand_in(ms, rank=r))
                       for r in (0, 1)], 1)
    assert torch.equal(whole, t)


@pytest.mark.parametrize("mp", (2, 16))
def test_local_heads_and_kv_groups_divide(mp):
    """Every registry arch at M = 2 and 16: where the axis splits the q
    heads but not the kv heads, H / M and H / KV divide one another (the
    contiguous kv slice of ``attention._kv_for_heads``); and no Mamba2
    config has d_inner split with its SSD heads cut (the refusal)."""
    for arch in ARCHS:
        cfg = registry.get(arch)
        H, KV = cfg.n_heads, cfg.n_kv_heads
        if H % mp == 0 and KV % mp:
            a, b = H // mp, H // KV
            assert a % b == 0 or b % a == 0, arch
        di = cfg.ssm_expand * cfg.d_model
        if cfg.family == "hybrid" and di % mp == 0:
            assert ssm_lib.local_heads(di, cfg.ssm_head_dim, mp) * mp == \
                di // cfg.ssm_head_dim
    with pytest.raises(ValueError, match="cut in two"):
        ssm_lib.local_heads(96, 32, 2)          # 3 heads over 2 ranks
    bad = registry.smoke_variant(registry.get("zamba2-1.2b")).replace(
        ssm_head_dim=256)                       # d_inner 512: 2 heads
    mesh = types.SimpleNamespace(model_shards=4, shape={"data": 1,
                                                        "model": 4},
                                 axis_names=("data", "model"), rank=0)
    with pytest.raises(ValueError, match="cut in two"):
        zoo.shard_params(zoo.init_params(None, bad, device="meta"), bad,
                         mesh)


def test_kv_slice_maps_local_heads_to_their_kv_heads():
    """Rank r's local q head j is global head r·H/M + j and reads kv head
    (r·H/M + j) // (H/KV): the slice the kernel gets, with its own ratio,
    maps every local head there."""
    from repro_torch.models.attention import _kv_for_heads
    for H, KV, M in ((8, 1, 2), (32, 2, 16), (48, 1, 16), (48, 8, 16),
                     (4, 2, 4), (16, 8, 4)):
        k = torch.arange(KV).reshape(1, 1, KV, 1)
        for r in range(M):
            n, h0 = H // M, r * (H // M)
            sl = _kv_for_heads(k, h0, n, H, KV)[0, 0, :, 0]
            ratio = n // sl.numel()
            for j in range(n):
                assert int(sl[j // ratio]) == (h0 + j) // (H // KV)
