"""The port's checkpoint archives (``repro_torch.checkpoint``) against the
JAX package's (``repro.checkpoint.io``), both ways: what one package
writes, the other reads back equal (exactly: the arrays are stored, not
recomputed), and a damaged archive raises the port's corrupt error."""
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.checkpoint import io as ref_io
from repro_torch import checkpoint as ckpt
from repro_torch.launch import train as train_cli


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((6, 4)).astype(np.float32),
            "b1": rng.standard_normal(4).astype(np.float32),
            "head": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                     "b": np.arange(3, dtype=np.int32)}}


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def test_port_archive_reads_with_the_reference(tmp_path):
    tree = _tree(0)
    path = tmp_path / "model.npz"
    ckpt.save_pytree(str(path), _map(torch.as_tensor, tree),
                     {"framework": "fedgroup", "max_acc": 0.5})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model.npz"]
    assert ref_io.load_metadata(str(path)) == {"framework": "fedgroup",
                                               "max_acc": 0.5}
    got = ref_io.load_pytree(str(path), _map(np.zeros_like, tree))
    for key in ("w1", "b1"):
        np.testing.assert_array_equal(got[key], tree[key])
    for key in ("w", "b"):
        np.testing.assert_array_equal(got["head"][key], tree["head"][key])
    # the keys in the order jax.tree_util flattens the dict
    names = list(np.load(str(path)).files)
    assert names == ["__meta__", "b1", "head/b", "head/w", "w1"]


def test_reference_archive_reads_with_the_port(tmp_path):
    tree = _tree(1)
    path = str(tmp_path / "ref.npz")
    ref_io.save_pytree(path, tree, {"dataset": "mnist"})
    got = ckpt.load_pytree(path, device="cpu")
    assert ckpt.load_metadata(path) == {"dataset": "mnist"}
    for key in ("w1", "b1"):
        np.testing.assert_array_equal(got[key].numpy(), tree[key])
    for key in ("w", "b"):
        np.testing.assert_array_equal(got["head"][key].numpy(),
                                      tree["head"][key])
    raw = bytearray(open(path, "rb").read())
    at = bytes(raw).index(tree["w1"].tobytes())
    raw[at + 5] ^= 0x10                          # one bit inside "w1"
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_pytree(path, device="cpu")


def test_train_cli_writes_the_reference_format(tmp_path, capsys):
    out = tmp_path / "run"
    rc = train_cli.main(["--mode", "fed", "--device", "cpu",
                         "--framework", "fedgroup", "--dataset", "synthetic",
                         "--rounds", "1", "--k", "4", "--epochs", "1",
                         "--groups", "2", "--alpha", "2", "--clients", "12",
                         "--out", str(out)])
    assert rc == 0
    printed = capsys.readouterr().out
    meta = ref_io.load_metadata(str(out / "model.npz"))
    assert meta["framework"] == "fedgroup"
    assert meta["dataset"] == "synthetic"
    assert f"max_acc={meta['max_acc']:.4f}" in printed
    params = ckpt.load_pytree(str(out / "model.npz"), device="cpu")
    assert sorted(params) == ["b", "w"]          # mclr(60, 10)
    assert params["w"].shape == (60, 10)


@pytest.mark.parametrize("framework", ["ifca", "fesem"])
def test_train_cli_dynamic_assignment_writes_group_zero(framework, tmp_path,
                                                        capsys):
    out = tmp_path / framework
    rc = train_cli.main(["--mode", "fed", "--device", "cpu",
                         "--framework", framework, "--dataset", "synthetic",
                         "--rounds", "2", "--k", "4", "--epochs", "1",
                         "--groups", "2", "--clients", "12",
                         "--out", str(out)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert printed.count(" acc=") == 2
    meta = ref_io.load_metadata(str(out / "model.npz"))
    assert meta["framework"] == framework
    assert f"max_acc={meta['max_acc']:.4f}" in printed
    params = ref_io.load_pytree(str(out / "model.npz"),
                                {"b": np.zeros(10, np.float32),
                                 "w": np.zeros((60, 10), np.float32)})
    assert params["w"].shape == (60, 10)          # group 0 of mclr(60, 10)
    assert np.isfinite(params["w"]).all()


def test_load_pytree_defaults_to_the_card(tmp_path):
    """Without ``device=`` the tensors go to ``cuda``: where there is no
    card that raises instead of quietly loading onto the CPU."""
    path = str(tmp_path / "ref.npz")
    ref_io.save_pytree(path, _tree(2), {})
    if torch.cuda.is_available():
        got = ckpt.load_pytree(path)
        assert got["w1"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ckpt.load_pytree(path)
