"""What ``edc_cosine``'s Hopper kernel decides in Python, and its
arithmetic, on the CPU (the kernel itself runs only on the card,
``tests/test_torch_kernels_gpu.py``):

- the plan: the d-slices cover [0, d) once, the row blocks [0, n) once,
  the column tiles [0, m) once with a width the kernel is built for, and
  the partials the CTAs write fill the scratch exactly once;
- a torch emulation of the kernel's order of sums (each lane's columns in
  order, the shuffle tree across lanes, the per-slice partials summed by
  lanes strided over the slices, then the tree) against the Pallas kernel
  in interpret mode and against the plain version within 3e-5 (fp32 sums
  in another order, as tests/test_kernels.py holds the Pallas kernel);
- FedGroup's EDC group cold start with 20 groups (m > 16, which the
  kernel before this design refused), port against the JAX trainer with
  the draws replayed: the same labels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import ReplayDraws
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed.engine import FedConfig as JFedConfig
from repro.kernels.edc_cosine import edc_cosine as j_edc_cosine
from repro.models.paper_models import mlp as j_mlp
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed.engine import FedConfig
from repro_torch.kernels import edc_cosine as edc
from repro_torch.kernels import ref
from repro_torch.models.paper_models import mlp

TOL = 3e-5
EPS = 1e-12
MS = [1, 5, 8, 16, 17, 32, 100]


N_SM = 132     # an H100 SXM; the plan is also held at other SM counts


@pytest.mark.parametrize("n_sm", [N_SM, 114, 4])
@pytest.mark.parametrize("d", [1, 31, 1023, 1024, 1025, 4097, 415_258])
def test_d_slices_cover_d_once(d, n_sm):
    p = edc.plan(100, d, 5, n_sm)
    sl = edc.d_slices(d, p.slice)
    assert len(sl) == p.ns
    assert sl[0][0] == 0 and sl[-1][1] == d
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    assert all(0 < c1 - c0 <= p.slice for c0, c1 in sl)
    assert p.slice % 32 == 0 and p.slice <= edc.max_slice(p.width)


@pytest.mark.parametrize("m", MS)
def test_grid_is_whole_waves_at_the_main_shapes(m):
    """At FedGroup's shapes the CTAs fill at least 90 % of the whole waves
    of CTAS_PER_SM an SM they take, each slice fitting shared memory."""
    p = edc.plan(200, 415_258, m, N_SM)
    wave = N_SM * edc.CTAS_PER_SM
    ctas = p.ns * p.nrb * p.ncb
    assert ctas >= 0.9 * -(-ctas // wave) * wave
    smem = (-(-p.slice // edc.step(p.width)) * edc.step(p.width)
            * edc.stride(p.width) + 2 * edc.WARPS * edc.ROWS_PER_WARP
            * (p.width + 1)) * 4
    assert smem <= edc.SMEM_MAX


@pytest.mark.parametrize("m", MS)
def test_col_tiles_cover_m_once(m):
    p = edc.plan(1, 1, m, N_SM)
    tiles = edc.col_tiles(m)
    assert len(tiles) == p.ncb and p.width in edc.TILE_WIDTHS
    assert tiles[0][0] == 0 and tiles[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    assert all(k1 - k0 == p.width for k0, k1 in tiles[:-1])
    # the launcher's own check: the tiles reach m, the last one is used
    assert p.ncb * p.width >= m > (p.ncb - 1) * p.width
    assert p.ncb == -(-m // edc.MAX_TILE)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 200, 256, 257, 1000])
def test_row_blocks_cover_n_once(n):
    p = edc.plan(n, 1, 1, N_SM)
    rb = edc.row_blocks(n, p.rows)
    assert len(rb) == p.nrb and p.rows % edc.ROWS_PER_WARP == 0
    assert p.rows <= edc.ROWS_MAX
    assert rb[0][0] == 0 and rb[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(rb, rb[1:]))


@pytest.mark.parametrize("groups", [1, 3, 7, 8, 9, 25, 50, 64])
@pytest.mark.parametrize("nb", [1, 2, 7, 13])
def test_warp_steps_split_each_row_group_at_most_once(groups, nb):
    ws = edc.warp_steps(groups, nb)
    assert len(ws) == min(edc.WARPS, groups)
    assert ws[0][0] == 0 and ws[-1][1] == groups * nb
    assert all(a[1] == b[0] for a, b in zip(ws, ws[1:]))
    lens = [t1 - t0 for t0, t1 in ws]
    assert max(lens) - min(lens) <= 1 and min(lens) >= nb
    for g in range(groups):
        owners = [w for w, (t0, t1) in enumerate(ws)
                  if t0 < (g + 1) * nb and t1 > g * nb]
        assert 1 <= len(owners) <= 2


@pytest.mark.parametrize("n,d,m,n_sm", [(1, 1, 1, N_SM), (37, 2500, 5, N_SM),
                                        (70, 1024, 17, N_SM),
                                        (33, 3000, 32, 4), (5, 1100, 100, 4),
                                        (300, 20_000, 5, 4)])
def test_partials_fill_the_scratch_once(n, d, m, n_sm):
    """Every CTA's writes, at the kernel's indices: part[(r·(m+1) + j)·ns
    + s] (j = m: the row's sum of squares, by column tile 0) and, by row
    block 0, vpart[k·ns + s] after them."""
    p = edc.plan(n, d, m, n_sm)
    hits = np.zeros(p.scratch_floats, np.int64)
    vbase = n * (m + 1) * p.ns
    for s, _ in enumerate(edc.d_slices(d, p.slice)):
        for rb, (r0, r1) in enumerate(edc.row_blocks(n, p.rows)):
            for b, (k0, k1) in enumerate(edc.col_tiles(m)):
                for r in range(r0, r1):
                    for k in range(k0, k1):
                        hits[(r * (m + 1) + k) * p.ns + s] += 1
                    if b == 0:
                        hits[(r * (m + 1) + m) * p.ns + s] += 1
                if rb == 0:
                    for k in range(k0, k1):
                        hits[vbase + k * p.ns + s] += 1
    assert (hits == 1).all()


def _lane_tree(x: torch.Tensor) -> torch.Tensor:
    """Lane 0's value after ``warp_sum``'s xor butterfly over the last
    dim (32 lanes): v += shfl_xor(v, off) for off = 16, 8, 4, 2, 1."""
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., idx ^ off]
    return x[..., 0]


def _strided(x: torch.Tensor) -> torch.Tensor:
    """``strided_sum``: lane l adds x[l], x[l + 32], ... in order, then the
    tree. x (..., ns)."""
    ns = x.shape[-1]
    x = F.pad(x, (0, -ns % 32)).unflatten(-1, (-1, 32))
    acc = torch.zeros(x.shape[:-2] + (32,))
    for j in range(x.shape[-2]):
        acc = acc + x[..., j, :]
    return _lane_tree(acc)


def emulate(dW: torch.Tensor, V: torch.Tensor, n_sm: int) -> torch.Tensor:
    """The kernel's arithmetic in fp32, CTA by CTA and warp by warp, into
    a flat scratch laid out as the kernel lays it out, then the finalize
    kernel's."""
    n, d = dW.shape
    m = V.shape[1]
    p = edc.plan(n, d, m, n_sm)
    st = edc.step(p.width)
    W, Vf = dW.float(), V.float()
    part = torch.full((p.scratch_floats,), float("nan"))
    vbase = n * (m + 1) * p.ns
    for s, (c0, c1) in enumerate(edc.d_slices(d, p.slice)):
        nb = -(-(c1 - c0) // st)
        pad = nb * st - (c1 - c0)
        # column c0 + 32·q + lane is lane `lane`'s q-th column
        w = F.pad(W[:, c0:c1], (0, pad)).unflatten(1, (-1, 32))
        for b, (k0, k1) in enumerate(edc.col_tiles(m)):
            v = F.pad(Vf[c0:c1, k0:k1], (0, 0, 0, pad)).unflatten(0, (-1, 32))
            vq = torch.zeros((32, k1 - k0))
            for q in range(v.shape[0]):
                vq = vq + v[q] * v[q]
            part[vbase + torch.arange(k0, k1) * p.ns + s] = _lane_tree(vq.T)
            for r0, r1 in edc.row_blocks(n, p.rows):
                groups = -(-(r1 - r0) // edc.ROWS_PER_WARP)
                ws = edc.warp_steps(groups, nb)
                for g in range(groups):
                    rows = torch.arange(r0 + 4 * g, min(r0 + 4 * g + 4, r1))
                    total = None
                    for t0, t1 in ws:                   # pieces, in order
                        ja, jb = max(t0, g * nb), min(t1, (g + 1) * nb)
                        if ja >= jb:
                            continue
                        acc = torch.zeros((len(rows), 32, k1 - k0))
                        sq = torch.zeros((len(rows), 32))
                        for q in range((ja - g * nb) * st // 32,
                                       (jb - g * nb) * st // 32):
                            x = w[rows, q]
                            sq = sq + x * x
                            acc = acc + x[:, :, None] * v[q][None]
                        piece = torch.cat([_lane_tree(acc.transpose(1, 2)),
                                           _lane_tree(sq)[:, None]], 1)
                        total = piece if total is None else total + piece
                    idx = rows[:, None] * (m + 1)
                    part[(idx + torch.arange(k0, k1)) * p.ns + s] = \
                        total[:, :k1 - k0]
                    if b == 0:
                        part[(idx[:, 0] + m) * p.ns + s] = total[:, -1]
    assert not torch.isnan(part).any()
    sums = _strided(part[:vbase].view(n, m + 1, p.ns))          # (n, m + 1)
    vn = torch.clamp(torch.sqrt(_strided(part[vbase:].view(m, p.ns))),
                     min=EPS)
    rn = torch.sqrt(sums[:, m:])
    return sums[:, :m] / torch.clamp(rn * vn[None], min=EPS)


@pytest.mark.parametrize("n,d,m,n_sm", [(37, 2500, 5, N_SM),
                                        (37, 20_000, 5, 4),     # split groups
                                        (40, 9_000, 17, 4),
                                        (9, 1500, 100, N_SM)])
def test_emulation_matches_pallas_and_plain(n, d, m, n_sm):
    rng = np.random.default_rng(n + m)
    dW = rng.standard_normal((n, d)).astype(np.float32)
    V = rng.standard_normal((d, m)).astype(np.float32)
    dW[3] = 0.0                                  # both eps clamps
    V[:, m // 2] = 0.0
    got = emulate(torch.as_tensor(dW), torch.as_tensor(V), n_sm).numpy()
    want = np.asarray(j_edc_cosine(jnp.asarray(dW), jnp.asarray(V),
                                   interpret=True))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    plain = ref.cosine_block_ref(torch.as_tensor(dW),
                                 torch.as_tensor(V)).numpy()
    np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)
    assert np.all(got[3] == 0.0) and np.all(got[:, m // 2] == 0.0)


def test_group_cold_start_with_20_groups_matches_reference():
    """EDC with m = 20 (two column tiles on the card): the port's cold
    start against the JAX trainer's, the draws replayed."""
    data_kw = dict(seed=0, n_clients=60, classes_per_client=2,
                   total_train=3000, dim=32)
    jcfg = JFedConfig(n_rounds=1, clients_per_round=8, local_epochs=1,
                      batch_size=10, lr=0.05, n_groups=20, pretrain_scale=2,
                      measure="edc", seed=0)
    jtr = JFedGroup(j_mlp(32, 16, 10), j_mnist_like(**data_kw), jcfg)
    ttr = FedGroupTrainer(mlp(32, 16, 10), mnist_like(**data_kw),
                          FedConfig(**dataclasses.asdict(jcfg)),
                          device="cpu",
                          init_params=params_from_numpy(
                              jax.tree_util.tree_map(np.asarray, jtr.params)),
                          draws=ReplayDraws(jcfg.seed))
    assert edc.plan(40, ttr.model_size, 20, N_SM).ncb == 2
    jpre, jlab = jtr.group_cold_start()
    tpre, tlab = ttr.group_cold_start()
    assert len(tpre) == 40
    assert np.array_equal(tpre, jpre)
    assert np.array_equal(np.asarray(tlab), np.asarray(jlab))
    assert set(np.asarray(tlab).tolist()) <= set(range(20))
