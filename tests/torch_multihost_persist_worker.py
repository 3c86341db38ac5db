"""Distributed-persistence worker of the port
(tests/test_torch_multihost_persist.py): tests/multihost_persist_worker.py
with the port's modules, on the CPU.  Phase
"load" builds a persistent partitioned cluster and records query
results; phase "restart" joins a FRESH cluster over the same per-host
paths, restores the partition metadata (dist_meta.json), validates
cross-host consistency (reference check_table_consistency,
heavy.thrift:710-716), and re-verifies the recorded results; phase
"diverge" corrupts one host's partition locally and asserts the
consistency check catches it.

    python tests/torch_multihost_persist_worker.py PHASE PID NPROCS PORT ROOT
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


QUERIES = [
    "SELECT count(*), sum(v) FROM fact",
    "SELECT g, count(*), sum(v) FROM fact GROUP BY g ORDER BY g",
    "SELECT s, count(*) FROM fact GROUP BY s ORDER BY s",
    "SELECT d.nm, count(*) FROM fact f JOIN dim d ON f.k = d.k "
    "GROUP BY d.nm ORDER BY d.nm",
]


def main(phase: str, pid: int, nprocs: int, port: int, root: str):
    import numpy as np
    import torch

    torch.set_num_threads(1)  # several workers share the CPU

    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.errors import NotSupported
    from heavydb_tpu_torch.parallel.dist_engine import DistEngine
    from heavydb_tpu_torch.parallel.multihost import MultiHostRuntime

    rt = MultiHostRuntime()
    rt.initialize(f"127.0.0.1:{port}", nprocs, pid, timeout_s=120)
    path = os.path.join(root, f"host{pid}")
    results_file = os.path.join(root, f"results{pid}.json")

    if phase == "load":
        rng = np.random.default_rng(7)
        n = 60_000
        k = rng.integers(0, 300, n).astype(np.int32)
        g = rng.integers(0, 11, n).astype(np.int32)
        v = rng.random(n).astype(np.float32)
        names = np.array([f"n{i % 13}" for i in range(n)], object)
        sel = slice(pid, None, nprocs)

        db = hdt.connect(path, device="cpu")
        dist = DistEngine(db, rt)
        dist.load_table("fact", {
            "k": k[sel], "g": g[sel], "v": v[sel], "s": names[sel],
        })
        dim_k = np.arange(300, dtype=np.int32)
        dist.load_table(
            "dim", {"k": dim_k, "nm": (dim_k % 9).astype(np.int32)},
            replicated=True,
        )
        res = [dist.sql(q).rows() for q in QUERIES]
        with open(results_file, "w") as f:
            json.dump(res, f, default=str)
        rt.shutdown()
        print(f"[{pid}] LOAD_OK", flush=True)
        return

    if phase == "restart":
        db = hdt.connect(path, device="cpu")  # epochs reload the partition
        dist = DistEngine(db, rt)  # dist_meta.json restores metadata
        assert "fact" in dist.partitioned, dist.partitioned
        report = dist.check_table_consistency()
        assert report["ok"]
        with open(results_file) as f:
            want = json.load(f)
        ok = True
        for q, w in zip(QUERIES, want):
            got = dist.sql(q).rows()
            gots = [[str(x) for x in row] for row in got]
            wants = [[str(x) for x in row] for row in w]
            if gots != wants:
                ok = False
                print(f"[{pid}] RESTART MISMATCH {q}: "
                      f"{gots[:2]} vs {wants[:2]}", flush=True)
        rt.shutdown()
        print(f"[{pid}] " + ("RESTART_OK" if ok else "RESTART_FAILED"),
              flush=True)
        sys.exit(0 if ok else 1)

    if phase == "diverge":
        db = hdt.connect(path, device="cpu")
        dist = DistEngine(db, rt)
        if pid == 1:
            # host 1 silently loses rows (simulates a missed epoch)
            db.sql("DELETE FROM fact WHERE g = 3")
        try:
            dist.check_table_consistency()
            detected = False
        except NotSupported:
            detected = True
        rt.shutdown()
        print(f"[{pid}] DIVERGENCE_" + ("DETECTED" if detected else "MISSED"),
              flush=True)
        sys.exit(0 if detected else 1)

    raise SystemExit(f"unknown phase {phase}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
         int(sys.argv[4]), sys.argv[5])
