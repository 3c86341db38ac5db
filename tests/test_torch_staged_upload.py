"""Staged host-to-device upload of scanned columns in the port against the
JAX package, and eager staging at load.

The reference's three cases of tests/test_staged_upload.py with its
lowered thresholds (a 1 KB staging minimum, 4 KB chunks), through both
packages: a BIGINT of small range with NULLs sent narrow, wide values sent
wide, a pad tail of NULLs.  Then the port's own: the narrow type is the
reference's choice over a grid of ranges (each dtype's edges, with and
without NULLs); every column kind scans bit-equal through the staging ring
and through one pageable copy, across fragments and chunk edges; the
bytes that cross are counted in `h2d_bytes`; the staged path makes no
host copy of the column (numpy's allocations traced); test_eager_prestage
of tests/test_buffer_mgr.py; and a prestage that fails raises, where the
reference swallows the error (a port difference).
"""

import math
import tracemalloc

import jax
import numpy as np
import pytest
import torch

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu import types as JT
from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.exec import batch as B
from heavydb_tpu_torch.exec.executor import _narrow_dtype
from heavydb_tpu_torch.plan import rel_alg as R


def _lowered(db):
    db.executor._STAGE_MIN_BYTES = 1 << 10
    db.executor._STAGE_CHUNK_BYTES = 1 << 12
    return db


@pytest.fixture()
def sdbs():
    return _lowered(hdt.connect()), _lowered(hdt_torch.connect(device="cpu"))


def _both_rows(dbs, sql):
    ref, port = dbs
    want, got = ref.sql(sql).rows(), port.sql(sql).rows()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert a == pytest.approx(b, rel=1e-9)
            else:
                assert a == b
    return got


# ---------------------------------------------------------------------------
# tests/test_staged_upload.py
# ---------------------------------------------------------------------------

def test_narrowed_bigint_with_nulls(sdbs):
    n = 10_000
    rng = np.random.default_rng(1)
    k = rng.integers(-100, 900, n).astype(np.float64)
    k[rng.random(n) < 0.1] = np.nan
    v = rng.random(n)
    kk = np.where(np.isnan(k), np.iinfo(np.int64).min, k).astype(np.int64)
    for db in sdbs:
        db.sql("CREATE TABLE st (k BIGINT, v DOUBLE)")
        db.catalog.get_table("st").insert_columns({1: kk, 2: v})
    ex = sdbs[1].executor
    h2d = ex.h2d_bytes
    nn = int(np.isnan(k).sum())
    rows = _both_rows(sdbs, "SELECT count(*), count(k), min(k), max(k), sum(v) FROM st")
    got_n, got_k, got_min, got_max, got_sv = rows[0]
    assert got_n == n and got_k == n - nn
    assert got_min == int(np.nanmin(k)) and got_max == int(np.nanmax(k))
    assert got_sv == pytest.approx(float(v.sum()), rel=1e-9)
    # k crossed as int16, v as float64
    assert ex.h2d_bytes - h2d == n * 2 + n * 8
    want = int(((k >= 0) & (k < 100)).sum())
    assert _both_rows(sdbs, "SELECT count(*) FROM st WHERE k >= 0 AND k < 100") == [(want,)]
    assert _both_rows(sdbs, "SELECT count(*) FROM st WHERE k IS NULL") == [(nn,)]


def test_wide_values_not_narrowed(sdbs):
    n = 5_000
    rng = np.random.default_rng(2)
    k = rng.integers(-(2 ** 60), 2 ** 60, n)
    for db in sdbs:
        db.sql("CREATE TABLE wt (k BIGINT)")
        db.catalog.get_table("wt").insert_columns({1: k})
    ex = sdbs[1].executor
    h2d = ex.h2d_bytes
    assert _both_rows(sdbs, "SELECT min(k), max(k) FROM wt") == [(int(k.min()), int(k.max()))]
    assert ex.h2d_bytes - h2d == n * 8


def test_pad_tail_is_null(sdbs):
    n = 3_001
    for db in sdbs:
        db.sql("CREATE TABLE pt (k INT)")
        db.catalog.get_table("pt").insert_columns({1: np.arange(n, dtype=np.int32)})
    assert _both_rows(sdbs, "SELECT count(*), sum(k) FROM pt") == [(n, n * (n - 1) // 2)]
    port = sdbs[1]
    t = port.catalog.get_table("pt")
    col = port.executor.scan_cache.get((t.table_id, t.generation, 1, B.bucket(n), None))
    assert col.dtype == torch.int32 and col.shape[0] == B.bucket(n) > n
    assert (col[n:] == np.iinfo(np.int32).min).all()
    assert torch.equal(col[:n], torch.arange(n, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------

def _ranges():
    out = []
    for dt in (np.int16, np.int32, np.int64):
        ii = np.iinfo(dt)
        for lo, hi in ((-127, 127), (-128, 127), (-127, 128), (0, 200), (-32767, 32767),
                       (-32768, 5), (1, 70_000), (-2 ** 31 + 1, 2 ** 31 - 1),
                       (-2 ** 31, 0), (3, 3)):
            if ii.min <= lo and hi <= ii.max:
                out.extend((np.dtype(dt), lo, hi, nulls) for nulls in (False, True))
    return out


@pytest.mark.parametrize("dt, lo, hi, nulls", _ranges(), ids=repr)
def test_narrow_dtype_matches_reference_rule(dt, lo, hi, nulls, monkeypatch):
    """The dtype a column crosses as, in the port and the reference, over
    each edge of the rule (the narrow type's minimum is kept for NULL);
    the port's column comes out bit-equal to the padded host column."""
    n = 700
    rng = np.random.default_rng(lo & 0xFFFF)
    host = rng.integers(lo, hi, n, endpoint=True).astype(dt)
    host[0], host[-1] = lo, hi
    kinds = {np.dtype(np.int16): (JT.smallint, T.smallint),
             np.dtype(np.int32): (JT.integer, T.integer),
             np.dtype(np.int64): (JT.bigint, T.bigint)}[dt]
    sent = np.iinfo(dt).min
    if nulls:
        host[5::11] = sent
    size = B.bucket(n)
    sent_dtypes = []
    real_put = jax.device_put

    def spy(x, *a, **k):
        if isinstance(x, np.ndarray):
            sent_dtypes.append(x.dtype)
        return real_put(x, *a, **k)

    ref = _lowered(hdt.connect())
    monkeypatch.setattr(jax, "device_put", spy)
    ref_out = np.asarray(ref.executor._staged_put(host, size, kinds[0](), rng=(lo, hi, nulls)))
    monkeypatch.undo()
    want = _narrow_dtype(dt, (lo, hi, nulls))
    assert {np.dtype(d) for d in sent_dtypes} == {want if want is not None else dt}
    ex = _lowered(hdt_torch.connect(device="cpu")).executor
    out = ex._staged_put([host[:300], host[300:]], size, kinds[1](), (lo, hi, nulls))
    padded = np.concatenate([host, np.full(size - n, sent, dt)])
    assert out.dtype == torch.from_numpy(padded).dtype
    assert np.array_equal(out.numpy(), padded) and np.array_equal(ref_out, padded)
    assert ex.h2d_bytes == n * (want or dt).itemsize


def _every_kind(n, rng):
    ints = rng.integers(-1000, 1000, n).astype(np.int32)
    ints[rng.random(n) < 0.05] = np.iinfo(np.int32).min
    f = rng.random(n).astype(np.float32)
    f[rng.random(n) < 0.05] = np.nan
    words = np.array([None if i % 13 == 0 else f"w{i % 37}" for i in range(n)], object)
    return {"i": ints, "b": rng.integers(0, 50_000, n).astype(np.int64) * 3,
            "w": rng.integers(-(2 ** 62), 2 ** 62, n), "s": rng.integers(-90, 90, n),
            "f": f, "d": rng.normal(size=n), "t": words, "tn": words.copy()}


def test_staged_scan_equals_pageable():
    """Every column kind scans bit-equal through the staging ring (chunks
    of 4 KB, across fragment edges) and through one pageable copy, whole
    and over a subset of fragments."""
    rng = np.random.default_rng(9)
    n = 9_000
    data = _every_kind(n, rng)
    ddl = ("CREATE TABLE e (i INT, b BIGINT, w BIGINT, s SMALLINT, f FLOAT, d DOUBLE, "
           "t TEXT, tn TEXT ENCODING NONE) WITH (fragment_size=2500)")
    outs = []
    for lowered in (False, True):
        db = hdt_torch.connect(device="cpu")
        if lowered:
            _lowered(db)
        db.sql(ddl)
        db.load_table("e", data)
        t = db.catalog.get_table("e")
        scan = R.Scan(t)
        outs.append((db.executor._exec_scan(scan, None),
                     db.executor._exec_scan(scan, None, frag_ids=[1, 3]),
                     db.executor.h2d_bytes))
    (whole, part, h2d_pageable), (swhole, spart, h2d_staged) = outs
    for a, b in zip(list(whole.cols) + list(part.cols), list(swhole.cols) + list(spart.cols)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            a, b = a.view(torch.int32 if a.dtype == torch.float32 else torch.int64), \
                b.view(torch.int32 if b.dtype == torch.float32 else torch.int64)
        assert torch.equal(a, b)
    # i, b, s and the dictionary ids crossed narrow; nothing crossed twice
    assert h2d_staged < h2d_pageable


def test_staged_put_makes_no_host_copy():
    """The staged path holds at most a chunk of host memory beside the
    column (numpy's allocations, traced); one pageable copy holds the whole
    padded column."""
    n = 1 << 20
    host = np.arange(n, dtype=np.int64) * 3  # 8 MB, too wide to narrow
    ex = hdt_torch.connect(device="cpu").executor
    peaks = []
    for min_bytes in (1 << 10, 1 << 30):
        ex._STAGE_MIN_BYTES = min_bytes
        tracemalloc.start()
        try:
            out = ex._staged_put([host[: n // 2], host[n // 2:]], B.bucket(n + 1),
                                 T.bigint(), (0, 3 * (n - 1), False))
            peaks.append(tracemalloc.get_traced_memory()[1])
        finally:
            tracemalloc.stop()
        assert torch.equal(out[:n], torch.from_numpy(host))
        assert (out[n:] == np.iinfo(np.int64).min).all()
    staged, pageable = peaks
    assert staged < host.nbytes // 8 and pageable >= host.nbytes


@pytest.mark.parametrize("staging", [True, None])
def test_eager_prestage(staging):
    """load_table uploads a table of eager_staging_min_rows rows or more
    when eager_device_staging is on; None means on CUDA only, so the CPU
    stages nothing at load."""
    n = 5000
    rng = np.random.default_rng(3)
    data = {"a": rng.integers(0, 9, n).astype(np.int32),
            "b": rng.random(n).astype(np.float32)}
    dbs = (hdt.connect(), hdt_torch.connect(device="cpu"))
    for db in dbs:
        db.config.eager_device_staging = staging
        db.config.eager_staging_min_rows = 10
        db.load_table("stg", data, create=True)
    ref, port = dbs
    for db in (dbs if staging else (port,)):
        t = db.catalog.get_table("stg")
        staged = [k for k, _ in db.executor.scan_cache.items()
                  if k[0] == t.table_id and k[1] == t.generation
                  and k[3] == B.bucket(t.num_rows)]
        assert len(staged) == (2 if staging else 0)
    h2d = port.executor.h2d_bytes
    rows = _both_rows(dbs, "SELECT a, count(*), sum(b) FROM stg GROUP BY a ORDER BY a")
    assert sum(c for _, c, _ in rows) == n
    assert (port.executor.h2d_bytes == h2d) == bool(staging)


def test_prestage_failure_raises(monkeypatch):
    """A staging failure at load raises in the port; the reference swallows
    it and uploads at the first query."""
    from heavydb_tpu.exec.executor import Executor as JExecutor
    from heavydb_tpu_torch.exec.executor import Executor

    def broken(self, node, needed, frag_ids=None):
        raise RuntimeError("no device memory")

    data = {"a": np.arange(100, dtype=np.int32)}
    ref, port = hdt.connect(), hdt_torch.connect(device="cpu")
    for db in (ref, port):
        db.config.eager_device_staging = True
        db.config.eager_staging_min_rows = 10
    monkeypatch.setattr(JExecutor, "_exec_scan", broken)
    monkeypatch.setattr(Executor, "_exec_scan", broken)
    ref.load_table("p", data, create=True)
    with pytest.raises(RuntimeError, match="no device memory"):
        port.load_table("p", data, create=True)
    monkeypatch.undo()
    for db in (ref, port):
        assert db.sql("SELECT COUNT(*), SUM(a) FROM p").rows() == [(100, 4950)]
    assert not math.isnan(port.sql("SELECT AVG(a) FROM p").scalar())
