"""The state DistEngine carries, in one process, against the JAX package:
with a one-process MultiHostRuntime (whose initialize() is a no-op in both
packages), every query of the multi-host rig (tools/synthetic.py
MULTIHOST_QUERIES, the reference's tests/multihost_worker.py) through the
reference's DistEngine and the port's on the same data gives the same rows
(FLOAT sums within rtol 1e-4); and a database directory whose
dist_meta.json one package's DistEngine wrote reopens in the other's with
its partitioned set and global row counts, consistent, with the same
rows.  An aggregate over the rows that reach a host from the others (the
repartitioned aggregate's) is held to the free device memory before they
upload."""

import json
import os

import numpy as np
import pytest

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu.parallel.dist_engine import DistEngine as JDistEngine
from heavydb_tpu.parallel.multihost import MultiHostRuntime as JRuntime
from heavydb_tpu_torch.errors import DeviceMemoryExceeded
from heavydb_tpu_torch.exec import executor as EX
from heavydb_tpu_torch.parallel.dist_engine import DistEngine as TDistEngine
from heavydb_tpu_torch.parallel.multihost import MultiHostRuntime as TRuntime
from heavydb_tpu_torch.tools.synthetic import (MULTIHOST_QUERIES, load_multihost,
                                               multihost_data)
from torch_cluster import assert_rows_close

ROWS = 20_000
REF = ("ref", lambda path=None: hdt.connect(path), JDistEngine, JRuntime)
PORT = ("port", lambda path=None: hdt_torch.connect(path, device="cpu"), TDistEngine,
        TRuntime)
PERSIST_QUERIES = ["MH_KEYLESS", "MH_GROUPBY", "MH_STRING_GROUPBY", "MH_JOIN_GROUPBY",
                   "MH_FACT_FACT_JOIN", "MH_GROUPBY_K"]


def _engine(pkg, path=None):
    _, connect, engine, runtime = pkg
    rt = runtime()
    assert rt.initialize() is False  # one process: no group
    return engine(connect(path), rt)


@pytest.fixture(scope="module")
def engines():
    data = multihost_data(ROWS)
    out = []
    for pkg in (REF, PORT):
        dist = _engine(pkg)
        load_multihost(dist, data, 0, 1)
        out.append(dist)
    return out


@pytest.mark.parametrize("label", list(MULTIHOST_QUERIES))
def test_dist_engine_matches_reference(engines, label):
    ref, port = engines
    sql = MULTIHOST_QUERIES[label]
    assert_rows_close(label, port.sql(sql).rows(), ref.sql(sql).rows())


def test_state_matches_reference(engines):
    ref, port = engines
    assert port.partitioned == ref.partitioned == {"fact", "orders", "sharded"}
    assert port.global_rows == ref.global_rows
    assert port.global_rows["fact"] == ROWS
    assert port.check_table_consistency()["ok"] and ref.check_table_consistency()["ok"]
    assert sorted(port.snapshot()) == sorted(ref.snapshot())


def test_leader_gather_mode(engines):
    ref, port = engines
    sql = "SELECT k, g FROM fact WHERE k < 3"
    got = port.sql(sql, gather="leader").rows()
    assert sorted(got) == sorted(ref.sql(sql, gather="leader").rows())
    assert len(got) == int((multihost_data(ROWS)["k"] < 3).sum())


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)], ids=["ref_to_port",
                                                                           "port_to_ref"])
def test_dist_meta_reopens_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "host0")
    data = multihost_data(ROWS // 4, seed=7)
    dist = _engine(writer, path)
    dist.load_table("fact", {c: data[c] for c in ("k", "g", "v", "s")})
    dim_k = np.arange(400, dtype=np.int32)
    dist.load_table("dim", {"k": dim_k, "nm": (dim_k % 11).astype(np.int32)},
                    replicated=True)
    dist.load_table("orders", {"ok": data["ok"], "w": data["w"]})
    want = {q: dist.sql(MULTIHOST_QUERIES[q]).rows() for q in PERSIST_QUERIES}
    with open(os.path.join(path, "dist_meta.json")) as f:
        meta = json.load(f)
    assert meta == {"num_processes": 1, "process_id": 0, "tables": {
        "fact": {"partitioned": True, "global_rows": ROWS // 4},
        "dim": {"partitioned": False, "global_rows": 400},
        "orders": {"partitioned": True, "global_rows": 2000}}}
    del dist

    back = _engine(reader, path)
    assert back.partitioned == {"fact", "orders"}
    assert back.global_rows == {"fact": ROWS // 4, "dim": 400, "orders": 2000}
    assert back.check_table_consistency()["ok"]
    for q in PERSIST_QUERIES:
        assert_rows_close(q, back.sql(MULTIHOST_QUERIES[q]).rows(), want[q])


def test_exchanged_rows_are_held_to_free_memory(monkeypatch):
    """MH_MEDIAN's approx_median does not decompose: each host aggregates
    the rows the repartition sends it, a host TableData.  With the free
    memory read stubbed below their bytes, that aggregate is refused
    before any of them uploads; with room, it answers as before."""
    port = _engine(PORT)
    load_multihost(port, multihost_data(ROWS), 0, 1)
    sql = MULTIHOST_QUERIES["MH_MEDIAN"]
    want = port.sql(sql).rows()
    uploads = []
    prepare = EX.Executor._prepare_compound
    monkeypatch.setattr(EX.Executor, "_prepare_compound",
                        lambda self, node, memo: uploads.append(
                            type(node.inputs[0]).__name__) or prepare(self, node, memo))
    monkeypatch.setattr(EX, "free_device_bytes", lambda dev, need=0: 1000)
    with pytest.raises(DeviceMemoryExceeded, match=r"merging \d+ partial rows"):
        port.sql(sql)
    assert uploads == ["Scan"]  # the leaf's projection alone
    monkeypatch.setattr(EX, "free_device_bytes", lambda dev, need=0: 1 << 40)
    assert port.sql(sql).rows() == want
    assert "TableData" in uploads
