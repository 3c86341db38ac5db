"""The port's multi-host rig on the CPU: 2- and 4-process gloo clusters of
tests/torch_multihost_worker.py, each host checking the reference worker's
distributed queries (tools/synthetic.py MULTIHOST_QUERIES) against its
per-row numpy oracle over the full data (PARITY_OK), as
tests/test_multihost.py does for the JAX package.  The 2-process cluster's
rows are also held against the JAX package's single-process connect() over
the full data (FLOAT sums within rtol 1e-4)."""

import json
import os

import numpy as np

import heavydb_tpu as hdt
from heavydb_tpu_torch.tools.synthetic import (MULTIHOST_QUERIES, MULTIHOST_SHARDED_DDL,
                                               multihost_data)
from torch_cluster import assert_rows_close, run_cluster
from torch_multihost_worker import ROWS

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_multihost_worker.py")


def _cluster(nprocs, out=None):
    outs = run_cluster(lambda pid, port: [WORKER, pid, nprocs, port]
                       + ([out] if out else []), nprocs)
    for rc, text in outs:
        assert "PARITY_OK" in text, text[-3000:]
        assert rc == 0, text[-3000:]


def _reference_rows(sqls):
    """The JAX package's single-process rows over the full data."""
    data = multihost_data(ROWS)
    db = hdt.connect()
    db.load_table("fact", {c: data[c] for c in ("k", "g", "v", "s")}, create=True)
    dim_k = np.arange(400, dtype=np.int32)
    db.load_table("dim", {"k": dim_k, "nm": (dim_k % 11).astype(np.int32)}, create=True)
    db.load_table("orders", {"ok": data["ok"], "w": data["w"]}, create=True)
    db.sql(MULTIHOST_SHARDED_DDL)
    db.load_table("sharded", {"k": data["k"], "v": data["v"]})
    return {label: [list(r) for r in db.sql(sql).rows()] for label, sql in sqls.items()}


def test_two_process_cluster_parity(tmp_path):
    out = str(tmp_path / "rows.json")
    _cluster(2, out)
    with open(out) as f:
        got = json.load(f)
    assert list(got) == list(MULTIHOST_QUERIES)
    want = _reference_rows({label: r["sql"] for label, r in got.items()})
    for label, r in got.items():
        g, w = r["rows"], want[label]
        if label == "MH_KEYLESS_DISTINCT":
            # the exact count is equal; each host's HyperLogLog estimate over
            # its value partition sums to within the sketch's error
            assert g[0][0] == w[0][0]
            assert abs(g[0][1] - w[0][1]) <= 0.1 * w[0][0], (g, w)
            continue
        assert_rows_close(label, g, w)


def test_four_process_cluster_parity():
    _cluster(4)
