"""Shared helpers of the zoo's dry-run train-pair tests on the production
meshes (``tests/test_torch_zoo_dryrun_mesh_train.py`` on 16 × 16,
``_train_pod.py`` on 2 × 16 × 16): the pairs run in a child process's
``fake`` world, the bytes the reference's specs imply for rank 0, the
collective count worked out from them, and the checks."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax

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
FLAGS = ("zero", "fsdp", "batch_over_model", "moe_2d")
# (arch, flags)
PAIRS = (("gemma-2b", {}), ("zamba2-1.2b", {}),
         ("gemma-2b", {"zero": True}), ("gemma-2b", {"fsdp": True}),
         ("gemma-2b", {"batch_over_model": True}),
         ("deepseek-v3-671b", {"moe_2d": True}))

CHILD = """
import json, sys
from repro_torch.launch import dryrun
pairs, multi_pod, out = json.loads(sys.argv[1]), sys.argv[2] == "1", \\
    sys.argv[3]
recs = [dryrun.run_one(a, "train_4k", multi_pod=multi_pod, save=False,
                       verbose=False, **f) for a, f in pairs]
dryrun.OUT_DIR = out
rc = dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k", "--zero"]
                 + (["--multi-pod"] if multi_pod else [])) \
    if pairs[0][0] == "gemma-2b" else 0
print(json.dumps({"recs": recs, "rc": rc}))
"""




def run_child(multi_pod: bool, out: Path) -> dict:
    """The records of PAIRS and the CLI run, from two child processes run
    side by side (each makes its own ``fake`` world)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    halves = (PAIRS[:1] + PAIRS[2:5], PAIRS[1:2] + PAIRS[5:])
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps(h),
         "1" if multi_pod else "0", str(out / str(i))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, h in enumerate(halves)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    a, b = (json.loads(o.strip().splitlines()[-1]) for o, _ in outs)
    recs = [a["recs"][0], b["recs"][0]] + a["recs"][1:] + b["recs"][1:]
    return {"recs": recs, "rc": max(a["rc"], b["rc"])}


def train_bytes(arch: str, flags: dict, mesh: dict) -> tuple:
    """(rank 0's argument bytes, its state's bytes) by the reference's
    specs on ``mesh``."""
    shape = shp.SHAPES["train_4k"]
    cfg = shp.config_for(registry.get(arch), shape)
    jcfg = jshp.config_for(jreg.get(arch), jshp.SHAPES["train_4k"])
    stand = type("Mesh", (), {"shape": mesh, "axis_names": tuple(mesh)})()
    js = jax.eval_shape(lambda k: jzoo.init_train_state(k, jcfg),
                        jax.random.PRNGKey(0))
    ts = zoo.init_train_state(None, cfg, device="meta")
    size = {tuple(n): t.element_size() for n, t in specs.spec_items(ts)}
    st = jspecs.state_specs(js, jcfg, 16, zero=flags.get("zero", False),
                            fsdp=flags.get("fsdp", False),
                            moe_2d=flags.get("moe_2d", False))
    state = implied_bytes(leaf_shapes(js, True), jax_items(st), mesh, size)
    ins = dryrun.input_specs(cfg, shape)
    jins = {k: jax.ShapeDtypeStruct(tuple(v.shape), "int32")
            for k, v in ins.items()}
    size = {(k,): v.element_size() for k, v in ins.items()}
    batch = implied_bytes(leaf_shapes(jins, True), jax_items(
        jspecs.data_specs(jins, stand, include_model=flags.get(
            "batch_over_model", False))), mesh, size)
    return state + batch, state


def _split(spec) -> int:
    return int(any(e == "model" or (isinstance(e, tuple) and "model" in e)
                   for e in spec))


def expected_train(arch: str) -> dict:
    """A plain dense or hybrid train pair's collectives by group, from the
    reference's param specs at 16 with the data axes splitting the batch:

    - model group: the embedding's sum where the vocab is split; the
      vocab-parallel cross-entropy's row-max gather, its two sums and its
      entry's backward sum; each split row-parallel product's forward sum
      and the backward sum of the entry of its input (attention: x, the
      heads' own k / v here; MLP: x); Mamba2's gated norm's sum of squares
      and the backward sums of its entries: x, B, C, dt, the four cut 1-D
      params, the sum of squares and the norm's scale. Under remat a
      layer body is recomputed in the backward up to its last tensor the
      backward needs, so every forward collective but the body's last
      sum runs again.
    - data group: the mask count's and the cross-entropy's sums, and one
      gradient sum a leaf."""
    cfg = jreg.get(arch)
    jp = jax.eval_shape(lambda k: jzoo.init_params(k, cfg),
                        jax.random.PRNGKey(0))
    s = jax_items(jspecs.param_specs(jp, cfg, 16))
    head = ("embed",) if cfg.tie_embeddings else ("lm_head",)
    model = _split(s[("embed",)]) + 4 * _split(s[head])

    def dense(pre) -> list:
        """A dense block's (forward sums, backward sums)."""
        a = _split(s[pre + ("attn", "wo")])
        m = _split(s[pre + ("mlp", "w_down")])
        kv_whole = a and not _split(s[pre + ("attn", "wk")])
        return [a + m, a * (1 + 2 * kv_whole) + m]

    if cfg.family == "hybrid":
        o = _split(s[("blocks", "mixer", "out_proj")])
        mamba = [2 * o, 10 * o]
        apps = cfg.n_layers // cfg.shared_attn_period
        sh_f, sh_b = dense(("shared_attn",))
        for n, f, b in ((cfg.n_layers - apps, mamba[0], mamba[1]),
                        (apps, mamba[0] + sh_f, mamba[1] + sh_b)):
            model += n * (f + b + max(f - 1, 0))
    else:
        f, b = dense(("blocks",))
        model += cfg.n_layers * (f + b + max(f - 1, 0))
    return {"model": model, "data": 2 + len(jax.tree_util.tree_leaves(jp))}


def check_records(multi_pod: bool, res: dict):
    name = "2x16x16" if multi_pod else "16x16"
    for (arch, flags), rec in zip(PAIRS, res["recs"]):
        assert rec["status"] == "ok" and rec["mesh"] == name, arch
        assert rec["axes"] == list(MESHES[multi_pod])
        assert {f: rec[f] for f in FLAGS} == {
            f: flags.get(f, False) for f in FLAGS}
        arg, state = train_bytes(arch, flags, MESHES[multi_pod])
        mem = rec["memory_analysis"]
        assert mem["argument_size_in_bytes"] == arg, (arch, flags)
        assert mem["alias_size_in_bytes"] == state, (arch, flags)
        assert rec["n_collectives"] == sum(
            g["n"] for g in rec["collectives_by_group"].values())
        assert "backward" in rec["differences"]["train"]


def check_layouts(res: dict):
    """ZeRO-1 cuts the moments' bytes, ZeRO-3 the params' too; the batch
    over the model axis cuts none."""
    alias = [r["memory_analysis"]["alias_size_in_bytes"]
             for r in res["recs"]]
    assert alias[3] < alias[2] < alias[0] == alias[4]


def check_collectives(res: dict, pair: int):
    rec = res["recs"][pair]
    want = expected_train(PAIRS[pair][0])
    got = {g: v["n"] for g, v in rec["collectives_by_group"].items()}
    assert got == want
    assert rec["collectives_by_op"] == {
        "c10d.allreduce_": sum(want.values()) - 1,
        "c10d._allgather_base_": 1}


def check_cli(multi_pod: bool, res: dict, out: Path):
    assert res["rc"] == 0
    name = "2x16x16" if multi_pod else "16x16"
    rec = json.loads((out / "0" / f"gemma-2b_train_4k_{name}_zero.json")
                     .read_text())
    assert rec["zero"] and rec["mesh"] == name
    assert rec["memory_analysis"] == res["recs"][2]["memory_analysis"]
