"""The port's multi-device execution on the CPU against the JAX package
(tests/test_distributed.py): the eight sharded queries through the
reference's connect(config=Config(num_shards=8)) on the conftest's
8-device CPU mesh, the port's on 8 virtual shards, and the port without
shards give the same rows; the mesh; and the five shard-map steps of
parallel/dist_query.py against the reference's shard_map over the same
numpy inputs (counts exact, float32 sums within rtol 1e-5, top-k values and
payloads exact, the repartitioned rows, counts and overflow equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu.config import Config as JConfig
from heavydb_tpu.parallel import dist_query as jdq
from heavydb_tpu.parallel.mesh import make_mesh as jmake_mesh
from heavydb_tpu_torch.config import Config as TConfig
from heavydb_tpu_torch.parallel import dist_query as tdq
from heavydb_tpu_torch.parallel.mesh import (SHARD_AXIS, Mesh, make_mesh, replicated,
                                             row_sharding)

QUERIES = [
    "SELECT count(*), sum(x), min(v), max(v) FROM t",
    "SELECT count(*) FROM t WHERE x > 0 AND v < 1.0",
    "SELECT k, count(*), sum(x), avg(v) FROM t GROUP BY k ORDER BY k",
    "SELECT k, count(DISTINCT x) FROM t GROUP BY k ORDER BY k",
    "SELECT x % 7, count(*) FROM t WHERE x IS NOT NULL GROUP BY 1 ORDER BY 1",
    "SELECT d.name, count(*) FROM t JOIN d ON t.k = d.k GROUP BY d.name ORDER BY d.name",
    "SELECT k, v FROM t ORDER BY v DESC, k LIMIT 20",
    "SELECT DISTINCT k FROM t ORDER BY k",
]
S = 8


def _load(db, data):
    db.sql("CREATE TABLE t (k INT, x INT, v DOUBLE)")
    db.load_table("t", data)
    db.sql("CREATE TABLE d (k INT, name TEXT)")
    db.sql("INSERT INTO d VALUES (1,'one'),(2,'two'),(3,'three'),(4,'four')")
    return db


@pytest.fixture(scope="module")
def dbs():
    """(reference 8-shard, port 8-shard, port single) with the same data."""
    rng = np.random.default_rng(2019)
    n = 10_000
    data = {
        "k": rng.integers(0, 50, n),
        "x": np.where(rng.random(n) < 0.1, np.nan, rng.integers(-100, 100, n)),
        "v": rng.normal(size=n),
    }
    return (_load(hdt.connect(config=JConfig(num_shards=S)), data),
            _load(hdt_torch.connect(config=TConfig(num_shards=S), device="cpu"), data),
            _load(hdt_torch.connect(device="cpu"), data))


def _canon(rows):
    """tests/test_distributed.py's: floats rounded to 8 decimals."""
    return [tuple(round(v, 8) if isinstance(v, float) else v for v in r) for r in rows]


@pytest.mark.parametrize("sql", QUERIES, ids=lambda q: q[:48])
def test_sharded_matches_reference(dbs, sql):
    ref, sharded, single = dbs
    want = _canon(ref.sql(sql).rows())
    for db in (sharded, single):
        got = _canon(db.sql(sql).rows())
        if "ORDER BY" in sql:
            assert got == want
        else:
            assert sorted(map(repr, got)) == sorted(map(repr, want))


def test_mesh_created(dbs):
    ref, sharded, single = dbs
    assert sharded.executor.mesh.devices.size == ref.executor.mesh.devices.size == S
    assert sharded.executor.mesh.shape[SHARD_AXIS] == S
    assert sharded.executor.mesh.distinct_devices() == [torch.device("cpu")]
    assert single.executor.mesh is None


def test_make_mesh_needs_the_cards():
    k = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"requested {k + 1} devices, only {k} available"):
        make_mesh(k + 1, "cuda")


def test_several_cards_in_one_process_raise(monkeypatch):
    """Shards on distinct cards: a mesh of the cards, the Database's first
    (the sharded path runs on it; tests/test_torch_sharded.py); one card
    short: the reference's ValueError; one shard: no mesh."""
    ex = hdt_torch.connect(device="cpu").executor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for home, other in ((0, 1), (1, 0)):
        ex.device = torch.device("cuda", home)
        mesh = ex._make_mesh(2)
        assert mesh.devices.tolist() == [torch.device("cuda", home), torch.device("cuda", other)]
        assert len(mesh.distinct_devices()) == 2
    with pytest.raises(ValueError, match="requested 3 devices, only 2 available"):
        ex._make_mesh(3)
    assert ex._make_mesh(1) is None


def test_shardings_describe_row_blocks():
    mesh = Mesh(["cpu"] * 4)
    assert row_sharding(mesh).block_rows(10) == 3
    assert row_sharding(mesh).shard_slices(10) == [slice(0, 3), slice(3, 6), slice(6, 9),
                                                   slice(9, 10)]
    assert replicated(mesh).shard_slices(10) == [slice(0, 10)] * 4


def test_shard_hash_bit_exact():
    rng = np.random.default_rng(5)
    keys = np.concatenate([rng.integers(-2**63, 2**63 - 1, 5000, dtype=np.int64),
                           [0, -1, 1, 2**31 - 1, -2**31, 2**63 - 1, -2**63]])
    for dt in (np.int64, np.int32):
        k = keys.astype(dt)
        h = (k.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)
        for n in (1, 3, 8):
            want = (h % np.uint64(n)).astype(np.int32)
            assert np.array_equal(tdq.shard_hash(torch.from_numpy(k), n).numpy(), want)


def _inputs(seed, n_slots, skew):
    rng = np.random.default_rng(seed)
    n = S * 1000
    keys = rng.integers(0, n_slots, n).astype(np.int32)
    if skew:
        keys[: n // 2] = 7  # one key on half the rows
    vals = rng.random(n).astype(np.float32)
    nrows = rng.integers(600, 1001, S).astype(np.int32)
    return keys, vals, nrows


def _both(jfn, tfn, *arrays):
    got = [t.numpy() for t in tfn(*[torch.from_numpy(a) for a in arrays])]
    want = [np.asarray(x) for x in jfn(*[jnp.asarray(a) for a in arrays])]
    assert [g.shape for g in got] == [w.shape for w in want]
    return got, want


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("n_slots", [64, 100])
def test_groupby_sum_count(skew, n_slots):
    args = _inputs(1, n_slots, skew)
    (gc, gs), (wc, ws) = _both(jdq.distributed_groupby_sum_count(jmake_mesh(S), n_slots),
                               tdq.distributed_groupby_sum_count(make_mesh(S, "cpu"), n_slots),
                               *args)
    assert gc.dtype == wc.dtype and np.array_equal(gc, wc)
    assert gs.dtype == np.float32 and np.allclose(gs, ws, rtol=1e-5)


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("n_slots", [64, 100])
def test_groupby_reduce_scatter(skew, n_slots):
    args = _inputs(2, n_slots, skew)
    (gc, gs), (wc, ws) = _both(
        jdq.distributed_groupby_reduce_scatter(jmake_mesh(S), n_slots),
        tdq.distributed_groupby_reduce_scatter(make_mesh(S, "cpu"), n_slots), *args)
    assert gc.dtype == wc.dtype and np.array_equal(gc, wc)
    assert gs.dtype == np.float32 and np.allclose(gs, ws, rtol=1e-5)


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("k", [1, 25, 300])
def test_topk(descending, k):
    keys, vals, nrows = _inputs(3, 100, False)
    vals = np.round(vals * 50).astype(np.float32)  # ties across and within shards
    payload = np.arange(vals.shape[0], dtype=np.int64)
    (gv, gp), (wv, wp) = _both(jdq.distributed_topk(jmake_mesh(S), k, descending),
                               tdq.distributed_topk(make_mesh(S, "cpu"), k, descending),
                               vals, payload, nrows)
    assert np.array_equal(gv, wv) and np.array_equal(gp, wp)


@pytest.mark.parametrize("skew,row_block", [(False, 400), (True, 400), (True, 4000)])
def test_join_groupby(skew, row_block):
    rng = np.random.default_rng(4)
    pk, pv, pn = _inputs(5, 500, skew)
    pk = pk.astype(np.int64)
    pg = rng.integers(0, 16, pk.shape[0]).astype(np.int32)
    bk = rng.permutation(np.arange(0, 1000, 2)).astype(np.int64)
    bk = np.concatenate([bk, np.full(S * 125 - bk.shape[0], -5, np.int64)])
    bn = np.full(S, 125, np.int32)
    bn[3] = 60
    (gc, gs, go), (wc, ws, wo) = _both(
        jdq.distributed_join_groupby(jmake_mesh(S), row_block, 16),
        tdq.distributed_join_groupby(make_mesh(S, "cpu"), row_block, 16),
        pk, pg, pv, pn, bk, bn)
    assert gc.dtype == wc.dtype and np.array_equal(gc, wc)
    assert np.allclose(gs, ws, rtol=1e-5)
    assert go.dtype == wo.dtype and np.array_equal(go, wo)
    assert (wo[0] > 0) == (skew and row_block == 400)


@pytest.mark.parametrize("skew,row_block", [(False, 300), (True, 300), (True, 1000)])
def test_hash_repartition(skew, row_block):
    keys, vals, nrows = _inputs(6, 1000, skew)
    got, want = _both(jdq.hash_repartition(jmake_mesh(S), row_block),
                      tdq.hash_repartition(make_mesh(S, "cpu"), row_block),
                      keys, vals, nrows)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # each shard received exactly the rows hashed to it (up to row_block a sender)
    rk, rv, rc, _ = got
    h = tdq.shard_hash(torch.from_numpy(keys), S).numpy()
    blk = keys.shape[0] // S
    for r in range(S):
        recv = []
        for s in range(S):
            base = (r * S + s) * row_block
            recv += list(zip(rk[base:base + rc[r * S + s]], rv[base:base + rc[r * S + s]]))
        sent = []
        for s in range(S):
            mine = [i for i in range(s * blk, s * blk + nrows[s]) if h[i] == r]
            sent += [(keys[i], vals[i]) for i in mine[:row_block]]
        assert sorted(recv) == sorted(sent)
