"""The port's host-resident client stores and state table
(``repro_torch.fed.store``, the virtual generators of
``repro_torch.data.generators``) against the JAX package's: the same
inputs give the same bytes (every gather is numpy in both packages), and
the state table reads back what the reference's reads after the same
sequence of writes."""
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.data import generators as jgen
from repro.fed import store as jstore
from repro_torch.data import generators as tgen
from repro_torch.fed import store as tstore

SPLITS = ("gather_train", "gather_test")


@pytest.fixture(scope="module")
def small_data():
    kw = dict(seed=0, n_clients=40, classes_per_client=2, total_train=2000,
              dim=16)
    return jgen.mnist_like(**kw), tgen.mnist_like(**kw)


def _assert_same_gather(a, b):
    for u, v in zip(a, b, strict=True):
        assert u.dtype == v.dtype and u.shape == v.shape
        assert u.tobytes() == v.tobytes()


def test_select_stream_tag_is_the_reference():
    assert tstore.SELECT_STREAM == jstore.SELECT_STREAM


def test_array_store_matches_reference(small_data):
    jdata, tdata = small_data
    js, ts = jstore.ArrayClientStore(jdata), tstore.ArrayClientStore(tdata)
    for attr in ("n_clients", "n_classes", "max_train", "max_test", "feat"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    np.testing.assert_array_equal(ts.n_train, js.n_train)
    np.testing.assert_array_equal(ts.n_test, js.n_test)
    idx = np.array([3, 17, 0, 39])
    for split in SPLITS:
        _assert_same_gather(getattr(ts, split)(idx), getattr(js, split)(idx))
    # FederatedData.store() is the same store
    _assert_same_gather(tdata.store().gather_train(idx),
                        ts.gather_train(idx))


@pytest.mark.parametrize("make", ["virtual_synthetic", "virtual_mnist_like"])
def test_virtual_generators_match_reference(make):
    kw = dict(seed=3, n_clients=5_000, mean_size=20, max_size=40)
    js, ts = getattr(jgen, make)(**kw), getattr(tgen, make)(**kw)
    assert ts.name == js.name
    assert (ts.max_train, ts.max_test, ts.feat) == \
        (js.max_train, js.max_test, js.feat)
    np.testing.assert_array_equal(ts.n_train, js.n_train)
    np.testing.assert_array_equal(ts.n_test, js.n_test)
    idx = np.array([0, 4_999, 1_234, 77])
    for split in SPLITS:
        _assert_same_gather(getattr(ts, split)(idx), getattr(js, split)(idx))
    assert ts.generated_clients == js.generated_clients == len(idx)


def test_virtual_sizes_match_reference():
    for args in ((0, 1_000, 40, 10, 120), (7, 333, 15, 5, 30)):
        for a, b in zip(tgen._virtual_sizes(*args), jgen._virtual_sizes(*args)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_lru_backend_evicts_and_regenerates_the_same_bytes():
    ts = tgen.virtual_synthetic(seed=1, n_clients=1_000, mean_size=15,
                                max_size=30, cache_clients=3)
    idx = np.array([5, 6, 7, 8, 9])
    first = ts.gather_train(idx)
    assert len(ts._cache) == 3                    # the LRU's bound
    assert list(ts._cache) == [7, 8, 9]           # least recent evicted
    again = ts.gather_train(idx[::-1])
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b[::-1])
    assert ts.generated_clients == 5              # distinct ids, counted once
    ref = jgen.virtual_synthetic(seed=1, n_clients=1_000, mean_size=15,
                                 max_size=30)
    _assert_same_gather(first, ref.gather_train(idx))


def test_memmap_backend_and_done_marker(tmp_path):
    kw = dict(seed=3, n_clients=300, dim=8, mean_size=15, max_size=30)
    mem = tgen.virtual_mnist_like(memmap_dir=str(tmp_path),
                                  shard_clients=16, **kw)
    ref = jgen.virtual_mnist_like(**kw)
    idx = np.array([0, 17, 255, 18])
    for split in SPLITS:
        _assert_same_gather(getattr(mem, split)(idx),
                            getattr(ref, split)(idx))
    assert sorted(p.name for p in tmp_path.glob("done_*")) == \
        ["done_000000", "done_000001", "done_000015"]
    # a fresh store over the same directory reads the shards back
    reread = tgen.virtual_mnist_like(memmap_dir=str(tmp_path),
                                     shard_clients=16, **kw)
    _assert_same_gather(reread.gather_train(idx), ref.gather_train(idx))
    assert reread.generated_clients == 0
    # a shard without its marker (a fill cut short) is rebuilt, not served
    (tmp_path / "done_000000").unlink()
    again = tgen.virtual_mnist_like(memmap_dir=str(tmp_path),
                                    shard_clients=16, **kw)
    _assert_same_gather(again.gather_train(idx), ref.gather_train(idx))
    assert again.generated_clients == 16          # shard 0 only
    assert (tmp_path / "done_000000").exists()


def test_virtual_store_checks_its_size_table():
    with pytest.raises(ValueError, match="exceeds"):
        tstore.VirtualClientStore(
            "bad", 2, None, max_train=3, max_test=1, feat=(2,), n_classes=2,
            n_train=np.array([4, 1]), n_test=np.array([1, 1]))
    ts = tgen.virtual_synthetic(n_clients=10, mean_size=15, max_size=30)
    ts.client_fn = lambda i: {"x": np.zeros((1, 60)), "y": np.zeros(1),
                              "x_test": np.zeros((0, 60)),
                              "y_test": np.zeros(0)}
    with pytest.raises(ValueError, match="size table"):
        ts.gather_train(np.array([0]))


def test_materialize_matches_reference():
    kw = dict(n_clients=25, mean_size=15, max_size=30)
    tdata = tgen.virtual_synthetic(**kw).materialize()
    jdata = jgen.virtual_synthetic(**kw).materialize()
    assert tdata.name == jdata.name and tdata.meta == jdata.meta
    for f in ("x_train", "y_train", "n_train", "x_test", "y_test", "n_test"):
        assert getattr(tdata, f).tobytes() == getattr(jdata, f).tobytes(), f


def _np(rows):
    return rows.numpy() if isinstance(rows, torch.Tensor) else rows


def test_state_table_matches_reference():
    """The same sequence of membership writes, scatters, deletes and
    gathers on both tables reads back the same values; the port's rows
    stay on the CPU whatever device the written rows came from."""
    rng = np.random.default_rng(0)
    N, d = 500, 6
    jt, tt = jstore.ClientStateTable(N), tstore.ClientStateTable(N)
    default = rng.standard_normal(d).astype(np.float32)
    jt.init_local_flat(default)
    tt.init_local_flat(torch.as_tensor(default))
    tt.init_local_flat(torch.zeros(d))            # a second init is a no-op
    assert tt.get_pretrain_dir(np.array([1])) is None
    assert not tt.has_pretrain_dir(np.array([1, 2])).any()
    for step in range(6):
        ids = rng.choice(N, 7, replace=False)
        rows = rng.standard_normal((7, d))
        jt.scatter_local_flat(ids, rows)
        tt.scatter_local_flat(ids, torch.as_tensor(rows))
        jt.set_pretrain_dir(ids[:4], rows[:4])
        tt.set_pretrain_dir(ids[:4], torch.as_tensor(rows[:4]))
        gone = ids[:2] if step % 2 else rng.choice(N, 3)
        jt.invalidate_pretrain_dir(gone)
        tt.invalidate_pretrain_dir(gone)
        jt.membership[ids[::2]] = step
        tt.membership[ids[::2]] = step
        probe = rng.choice(N, 40, replace=False)
        got = tt.gather_local_flat(probe)
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      jt.gather_local_flat(probe))
        np.testing.assert_array_equal(_np(tt.get_pretrain_dir(probe)),
                                      jt.get_pretrain_dir(probe))
        np.testing.assert_array_equal(tt.has_pretrain_dir(probe),
                                      jt.has_pretrain_dir(probe))
        np.testing.assert_array_equal(tt.cold_ids(probe), jt.cold_ids(probe))
    np.testing.assert_array_equal(tt.membership, jt.membership)
    np.testing.assert_array_equal(tt.cold_mask(), jt.cold_mask())
    assert tt.touched_rows() == jt.touched_rows()
    assert tt.init_group_version(3) is tt.init_group_version(5)
    np.testing.assert_array_equal(tt.group_version, jt.init_group_version(3))
    with pytest.raises(RuntimeError, match="init_local_flat"):
        tstore.ClientStateTable(3).gather_local_flat([0])
