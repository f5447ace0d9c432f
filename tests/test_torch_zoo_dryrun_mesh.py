"""The zoo's dry run on the production meshes (``repro_torch.launch.dryrun``
with its default ``--mesh production``): rank 0's program of a few
production-size prefill and decode pairs, a slot-split decode
(``--cache-seq-shard``) and a ``long_500k`` one among them, on 16 × 16
and on 2 × 16 × 16, each in a ``fake`` world of 256 / 512 ranks made in a
child process (never in the test's own).

Each record's argument bytes equal the bytes the reference's specs imply
for rank 0 (``repro.sharding.specs`` on the same shapes); the collective
inventory of a dense pair (Gemma-2B prefill) and a hybrid pair (Zamba2
decode) equals the count worked out from the specs (a sum for each split
row-parallel product, an embedding sum, a head gather, and for Mamba2
the gated norm's sum of squares), ``CommDebugMode`` agreeing with the
mesh's log (``run_one`` raises otherwise); a train pair (Gemma-2B
``train_4k``) is rank 0's ``zoo.train_step(mesh=)`` on its train state's
blocks (``tests/test_torch_zoo_dryrun_mesh_train.py`` runs the train
pairs with each flag and counts their collectives).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo_tp import implied_bytes, jax_items, leaf_shapes
from repro.configs import registry as jreg
from repro.configs import shapes as jshp
from repro.models import zoo as jzoo
from repro.sharding import specs as jspecs
from repro_torch.configs import registry
from repro_torch.configs import shapes as shp
from repro_torch.launch import dryrun
from repro_torch.models import zoo
from repro_torch.sharding import specs

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}
# (arch, shape, --cache-seq-shard)
PAIRS = (("gemma-2b", "prefill_32k", False),
         ("zamba2-1.2b", "decode_32k", False),
         ("gemma-2b", "decode_32k", True),
         ("glm4-9b", "long_500k", True),
         ("gemma-2b", "train_4k", False))

CHILD = """
import json, sys
from repro_torch.launch import dryrun
pairs, multi_pod, out = json.loads(sys.argv[1]), sys.argv[2] == "1", \
    sys.argv[3]
recs = [dryrun.run_one(a, s, multi_pod=multi_pod, cache_seq_shard=q,
                       save=False, verbose=False) for a, s, q in pairs]
dryrun.OUT_DIR = out
rc = dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                  "--cache-seq-shard"] + (["--multi-pod"] if multi_pod
                                          else []))
print(json.dumps({"recs": recs, "rc": rc}))
"""


@pytest.fixture(scope="module", params=[False, True],
                ids=["16x16", "2x16x16"])
def records(request, tmp_path_factory):
    out = tmp_path_factory.mktemp("zoo_dryrun_mesh")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(PAIRS),
         "1" if request.param else "0", str(out)], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    return request.param, res, out


def spec_bytes(arch: str, shape_name: str, seq: bool, mesh: dict) -> int:
    """Rank 0's argument bytes by the reference's specs on ``mesh``."""
    shape = shp.SHAPES[shape_name]
    cfg = shp.config_for(registry.get(arch), shape)
    jcfg = jshp.config_for(jreg.get(arch), jshp.SHAPES[shape_name])
    stand = type("Mesh", (), {"shape": mesh, "axis_names": tuple(mesh)})()
    ins = dryrun.input_specs(cfg, shape)
    tp = zoo.init_params(None, cfg, device="meta")
    jp = jax.eval_shape(lambda k: jzoo.init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    size = {tuple(n): l.element_size() for n, l in specs.spec_items(tp)}
    total = implied_bytes(leaf_shapes(jp, True), jax_items(
        jspecs.param_specs(jp, jcfg, 16)), mesh, size)
    cache = ins.pop("cache", None)
    jins = {k: jax.ShapeDtypeStruct(tuple(v.shape), "int32")
            for k, v in ins.items()}
    size = {(k,): v.element_size() for k, v in ins.items()}
    total += implied_bytes(leaf_shapes(jins, True), jax_items(
        jspecs.data_specs(jins, stand)), mesh, size)
    if cache is not None:
        jc = jax.eval_shape(lambda: jzoo.init_cache(
            jcfg, shape.global_batch, shp.cache_len(cfg, shape)))
        size = {tuple(n): l.element_size()
                for n, l in specs.spec_items(cache)}
        total += implied_bytes(leaf_shapes(jc, True), jax_items(
            jspecs.cache_specs(jc, jcfg, stand, seq_shard=seq)), mesh, size)
    return total


def _split(spec) -> int:
    return int(any(e == "model" or (isinstance(e, tuple) and "model" in e)
                   for e in spec))


def expected_collectives(arch: str) -> int:
    """A dense or hybrid pair's collectives, from the reference's param
    specs at 16: the embedding's sum and the head's gather where the vocab
    is split; a layer's sum for each split row-parallel product (``wo``,
    ``w_down``; Mamba2's ``out_proj``, with its gated norm's sum of
    squares)."""
    cfg = jreg.get(arch)
    jp = jax.eval_shape(lambda k: jzoo.init_params(k, cfg),
                        jax.random.PRNGKey(0))
    s = jax_items(jspecs.param_specs(jp, cfg, 16))
    head = ("embed",) if cfg.tie_embeddings else ("lm_head",)
    n = _split(s[("embed",)]) + _split(s[head])
    if cfg.family == "hybrid":
        n += cfg.n_layers * 2 * _split(s[("blocks", "mixer", "out_proj")])
        apps = cfg.n_layers // cfg.shared_attn_period
        n += apps * (_split(s[("shared_attn", "attn", "wo")])
                     + _split(s[("shared_attn", "mlp", "w_down")]))
    else:
        n += cfg.n_layers * (_split(s[("blocks", "attn", "wo")])
                             + _split(s[("blocks", "mlp", "w_down")]))
    return n


def test_records_are_rank0_of_the_production_mesh(records):
    multi_pod, res, _ = records
    name = "2x16x16" if multi_pod else "16x16"
    for (arch, shape_name, seq), rec in zip(PAIRS, res["recs"]):
        if shp.SHAPES[shape_name].kind == "train":
            continue
        assert rec["status"] == "ok" and rec["mesh"] == name
        assert rec["axes"] == list(MESHES[multi_pod])
        assert rec["cache_seq_shard"] == seq
        assert rec["n_collectives"] == sum(
            g["n"] for g in rec["collectives_by_group"].values())
        assert rec["n_collectives"] == sum(rec["collectives_by_op"].values())
        assert rec["memory_analysis"]["argument_size_in_bytes"] == \
            spec_bytes(arch, shape_name, seq, MESHES[multi_pod]), arch
        assert "collectives" in rec["differences"]


@pytest.mark.parametrize("pair", [0, 1], ids=["dense", "hybrid"])
def test_collectives_match_the_spec_count(records, pair):
    _, res, _ = records
    arch = PAIRS[pair][0]
    rec = res["recs"][pair]
    want = expected_collectives(arch)
    assert rec["n_collectives"] == want
    assert rec["collectives_by_group"] == {"model": {
        "n": want, "bytes": rec["collective_bytes_total"]}}
    assert rec["collectives_by_op"] == {"c10d.allreduce_": want - 1,
                                        "c10d._allgather_base_": 1}


def test_train_pair_is_rank0_of_the_train_step(records):
    multi_pod, res, _ = records
    rec = res["recs"][-1]
    assert rec["status"] == "ok"
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert not any(rec[k] for k in ("zero", "fsdp", "batch_over_model",
                                    "moe_2d"))
    mem = rec["memory_analysis"]
    assert 0 < mem["alias_size_in_bytes"] < mem["argument_size_in_bytes"]
    assert "backward" in rec["differences"]["train"]


def test_the_cli_writes_the_mesh_record(records):
    multi_pod, res, out = records
    assert res["rc"] == 0
    name = "2x16x16" if multi_pod else "16x16"
    rec = json.loads((out / f"gemma-2b_decode_32k_{name}_seqshard.json")
                     .read_text())
    assert rec["mesh"] == name and rec["cache_seq_shard"]
    assert rec["memory_analysis"] == res["recs"][2]["memory_analysis"]
