"""The port's dry run without a mesh (``repro_torch.configs.shapes``'
``batch_specs`` / ``decode_specs``, ``repro_torch.launch.dryrun``) against
the JAX package.

The reference's ``repro.launch.dryrun`` forces 512 host devices when
imported (``tests/conftest.py``), so it is not imported here: its
``input_specs`` (``dryrun.py:50-54``) is ``batch_specs`` for train and
prefill and ``decode_specs`` for decode, both from
``repro.configs.shapes``, which the tests call directly.
"""
import itertools

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import registry as jreg
from repro.configs import shapes as jshp
from repro.models import zoo as jzoo
from repro_torch.configs import registry, shapes as shp
from repro_torch.launch import dryrun
from repro_torch.models import zoo
from repro_torch.models.modules import tree_leaves

PAIRS = list(itertools.product(registry.ARCHS, shp.SHAPES))
SKIPPED = {("hubert-xlarge", "decode_32k"), ("hubert-xlarge", "long_500k")}
KINDS = ("train", "prefill", "decode")
TINY = {k: shp.InputShape(f"tiny_{k}", 32, 2, k) for k in KINDS}


def _port_paths(tree, prefix=()):
    """{path: (shape, dtype name)}; dict keys sorted, list items by index,
    as JAX flattens."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_paths(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_paths(v, prefix + (i,)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _jax_paths(tree) -> dict:
    def key(p):
        return p.key if hasattr(p, "key") else p.idx
    return {tuple(key(p) for p in path): (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def _ref_specs(arch: str, shape_name: str):
    jcfg = jshp.config_for(jreg.get(arch), jshp.SHAPES[shape_name])
    shape = jshp.SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return jshp.batch_specs(jcfg, shape)
    return jshp.decode_specs(jcfg, shape)


def test_shapes_table_matches_reference():
    assert list(shp.SHAPES) == list(jshp.SHAPES)
    for name, s in shp.SHAPES.items():
        j = jshp.SHAPES[name]
        assert (s.seq_len, s.global_batch, s.kind) == (j.seq_len,
                                                       j.global_batch, j.kind)
    assert len(PAIRS) == 40


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_input_specs_match_reference(arch, shape_name):
    """Published widths: the meta inputs (and cache) leaf for leaf, or the
    same skip with the same reason."""
    shape = shp.SHAPES[shape_name]
    ok, why = shp.supported(registry.get(arch), shape)
    assert (ok, why) == jshp.supported(jreg.get(arch),
                                       jshp.SHAPES[shape_name])
    assert ok == ((arch, shape_name) not in SKIPPED)
    if not ok:
        return
    cfg = shp.config_for(registry.get(arch), shape)
    ours = dryrun.input_specs(cfg, shape)
    assert all(t.is_meta for t in tree_leaves(ours))
    assert _port_paths(ours) == _jax_paths(_ref_specs(arch, shape_name))


def test_skip_list_and_reasons_match_reference():
    ours = {(a, s): shp.supported(registry.get(a), shp.SHAPES[s])[1]
            for a, s in PAIRS
            if not shp.supported(registry.get(a), shp.SHAPES[s])[0]}
    ref = {(a, s): jshp.supported(jreg.get(a), jshp.SHAPES[s])[1]
           for a, s in PAIRS
           if not jshp.supported(jreg.get(a), jshp.SHAPES[s])[0]}
    assert ours == ref
    assert set(ours) == SKIPPED
    for a, s in SKIPPED:
        rec = dryrun.run_one(a, s, save=False, verbose=False)
        assert rec == {"arch": a, "shape": s, "status": "skip",
                       "reason": ref[(a, s)]}


@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_params_and_train_state_match_reference(arch):
    """Published widths: ``init_train_state`` on meta leaf for leaf against
    ``jax.eval_shape`` of the reference's, and its params subtree against
    the port's ``init_params``."""
    ref = jax.eval_shape(lambda k: jzoo.init_train_state(k, jreg.get(arch)),
                         jax.random.PRNGKey(0))
    cfg = registry.get(arch)
    state = zoo.init_train_state(None, cfg, device="meta")
    assert _port_paths(state) == _jax_paths(ref)
    assert _port_paths(zoo.init_params(None, cfg, device="meta")) == \
        _jax_paths(ref["params"])
    assert list(_port_paths(state)) == list(_jax_paths(ref))


def _cpu_step(arch: str, shape: shp.InputShape):
    cfg = shp.config_for(dryrun.arch_config(arch, smoke=True), shape)
    gen = torch.Generator().manual_seed(0)
    return dryrun.build_step(cfg, shape, device="cpu", gen=gen)


@pytest.mark.parametrize("arch,kind", list(itertools.product(registry.ARCHS,
                                                             KINDS)))
def test_smoke_variant_record_matches_a_real_cpu_step(arch, kind):
    """A smoke variant's meta record: ok, argument bytes the real tensors'
    bytes, FLOPs those of the same step run for real on the CPU."""
    shape = TINY[kind]
    rec = dryrun.run_one(arch, shape.name, shape=shape, smoke=True,
                         mesh="1", save=False, verbose=False)
    if kind == "decode" and arch == "hubert-xlarge":
        assert rec["status"] == "skip"
        return
    assert rec["status"] == "ok" and rec["mesh"] == "1"
    fn, args = _cpu_step(arch, shape)
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == dryrun.nbytes(args)
    assert mem["alias_size_in_bytes"] == dryrun.donated(shape, args)
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    assert rec["cost_analysis"]["flops"] == fc.get_total_flops() > 0
    assert mem["output_size_in_bytes"] == dryrun.nbytes(out)
    assert "temp_size_in_bytes" not in mem
    assert set(rec["differences"]) == {"temp_size_in_bytes", "flops",
                                       "collectives"}


def test_kernel_wrappers_on_meta_are_shapes_only():
    from repro_torch.kernels.ssd_chunk import ssd_intra_chunk
    from repro_torch.kernels.swa_attention import swa_attention

    def m(*shape):
        return torch.empty(shape, device="meta")
    o = swa_attention(m(2, 4096, 8, 256), m(2, 4096, 1, 256),
                      m(2, 4096, 1, 256), window=None)
    assert o.is_meta and tuple(o.shape) == (2, 4096, 8, 256)
    Y, S = ssd_intra_chunk(m(2, 32, 128, 64, 64), m(2, 64, 32, 128),
                           m(2, 32, 128, 1, 64), m(2, 32, 128, 1, 64))
    assert Y.is_meta and tuple(Y.shape) == (2, 32, 128, 64, 64)
    assert S.is_meta and tuple(S.shape) == (2, 32, 64, 64, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        swa_attention(m(1, 8, 2, 64), torch.zeros(1, 8, 2, 64),
                      m(1, 8, 2, 64))


@pytest.mark.parametrize("seq,batch", [(32, 2), (128, 1)])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["recurrent", "chunkwise"])
def test_xlstm_folded_time_loop_counts_the_loops_flops(impl, remat, seq,
                                                       batch):
    """On meta the xLSTM time loops run as one folded step
    (``models.xlstm._folded``): shapes and FLOPs those of the loop run
    for real on the CPU, with and without remat. With chunks of 32, S = 32
    is one chunk and S = 128 four (four ``torch.utils.checkpoint`` runs of
    each loop on the CPU, one of the folded step on meta), as the
    published-width pairs run S / chunk of them."""
    cfg = dryrun.arch_config("xlstm-350m", smoke=True).replace(
        mlstm_impl=impl, remat=remat, xlstm_chunk=32)
    shape = shp.InputShape(f"tiny_train_{seq}", seq, batch, "train")
    fn, args = dryrun.build_step(cfg, shape)
    out, flops, by_op = dryrun.count_flops(fn, args)
    fn, args = dryrun.build_step(cfg, shape, device="cpu",
                                 gen=torch.Generator().manual_seed(0))
    cpu_out, cpu_flops, cpu_by_op = dryrun.count_flops(fn, args)
    assert (flops, by_op) == (cpu_flops, cpu_by_op)
    assert _port_paths(out) == _port_paths(cpu_out)


def test_published_width_step_on_meta():
    """One published-width pair end to end on meta: Gemma-2B decode over a
    32,768-slot cache (nothing is allocated)."""
    rec = dryrun.run_one("gemma-2b", "decode_32k", mesh="1", save=False,
                         verbose=False)
    cfg = registry.get("gemma-2b")
    params = zoo.init_params(None, cfg, device="meta")
    cache = zoo.init_cache(cfg, 128, 32768, device="meta")
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == (
        dryrun.nbytes(params) + dryrun.nbytes(cache) + 128 * 4 * 2)
    assert mem["alias_size_in_bytes"] == dryrun.nbytes(cache)
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["window"] is None


@pytest.mark.parametrize("flag", list(dryrun.SHARDING_FLAGS))
def test_sharding_flags_need_the_production_mesh(flag):
    """Every flag that shards over a mesh (the multi-pod mesh, the
    slot-split cache, and since 16d-ii those of a train state or batch)
    runs on the production mesh (tests/test_torch_zoo_dryrun_mesh.py runs
    them in a child process: no process group is made here) and is a
    ValueError with ``--mesh 1``, from ``run_one`` and the CLI."""
    dryrun.check_flags("production", **{flag: True})
    with pytest.raises(ValueError, match="production mesh"):
        dryrun.run_one("gemma-2b", "train_4k", mesh="1", save=False,
                       verbose=False, **{flag: True})
    with pytest.raises(ValueError, match="production mesh"):
        dryrun.run_one("gemma-2b", "decode_32k", mesh="1", save=False,
                       verbose=False, **{flag: True})
    with pytest.raises(SystemExit):
        dryrun.main(["--all", "--mesh", "1", "--" + flag.replace("_", "-")])


def test_config_flags_and_xlstm_opt_record():
    cfg = dryrun.arch_config("xlstm-350m", bf16_params=True,
                             moe_grouped=True, attn_chunk=64, xlstm_opt=True)
    assert (cfg.param_dtype, cfg.moe_impl, cfg.attn_q_chunk,
            cfg.mlstm_impl, cfg.xlstm_chunk, cfg.xlstm_scan_units) == (
        "bfloat16", "grouped", 64, "chunkwise", 256, True)
    assert dryrun.arch_config("xlstm-350m",
                              mlstm_chunkwise=True).mlstm_impl == "chunkwise"
    rec = dryrun.run_one("xlstm-350m", "tiny_prefill",
                         shape=shp.InputShape("tiny_prefill", 256, 1,
                                              "prefill"),
                         smoke=True, xlstm_opt=True, mesh="1", save=False,
                         verbose=False)
    assert rec["status"] == "ok"
    # its batch-over-model half runs on the production mesh (16d-ii)
    assert "sharding_left_out" not in rec and "batch_over_model" not in rec


def test_main_summary_and_records(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape",
                        "decode_32k"]) == 0
    assert "== dry-run summary: 0 ok, 1 skip, 0 fail ==" in \
        capsys.readouterr().out
    assert dryrun.main(["--arch", "granite-20b", "--shape",
                        "long_500k", "--mesh", "1"]) == 0
    assert "== dry-run summary: 1 ok, 0 skip, 0 fail ==" in \
        capsys.readouterr().out
    assert [p.name for p in tmp_path.iterdir()] == \
        ["granite-20b_long_500k_1.json"]


def test_a_failing_pair_is_reported_and_the_sweep_goes_on(monkeypatch,
                                                           capsys):
    calls = []

    def fake(a, s, **kw):
        calls.append((a, s))
        if len(calls) == 1:
            raise RuntimeError("boom")
        return {"arch": a, "shape": s, "status": "ok"}
    monkeypatch.setattr(dryrun, "run_one", fake)
    assert dryrun.main(["--all"]) == 1
    out = capsys.readouterr().out
    assert "FAIL glm4-9b x train_4k: RuntimeError: boom" in out
    assert "== dry-run summary: 39 ok, 0 skip, 1 fail ==" in out
    assert len(calls) == 40
