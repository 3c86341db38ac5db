"""Worker process of the port's multi-host CPU rig
(tests/test_torch_multihost.py): tests/multihost_worker.py with the port's
modules.

Each worker joins a torch.distributed gloo group, connects the port on the
CPU, loads its row partition of a shared synthetic dataset, runs the
reference worker's distributed queries through DistEngine and checks them
against the same per-row numpy oracle over the FULL data.  Prints
PARITY_OK on success; with an output path, host 0 also writes each query's
SQL and rows there as JSON.

    python tests/torch_multihost_worker.py PID NPROCS PORT [OUT.json]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = 200_000  # as the reference worker


def main(pid: int, nprocs: int, port: int, out_path=None):
    import numpy as np
    import torch

    torch.set_num_threads(1)  # several workers share the CPU

    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.parallel.dist_engine import DistEngine
    from heavydb_tpu_torch.parallel.multihost import MultiHostRuntime
    from heavydb_tpu_torch.tools.synthetic import (MULTIHOST_QUERIES, load_multihost,
                                                   multihost_data)

    rt = MultiHostRuntime()
    rt.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs,
        process_id=pid,
        timeout_s=120,
    )

    # full dataset from a shared seed; this host takes rows pid::nprocs
    n = ROWS
    data = multihost_data(n)
    k, g, v, names, ok_keys, o_w = (data[c] for c in ("k", "g", "v", "s", "ok", "w"))
    dim_nm = (np.arange(400) % 11).astype(np.int32)

    db = hdt.connect(device="cpu")
    dist = DistEngine(db, rt)
    load_multihost(dist, data, pid, nprocs)

    snap = dist.snapshot()
    assert snap["fact"]["num_rows_global"] == n, snap["fact"]
    results = {}

    def run(label):
        sql = MULTIHOST_QUERIES[label]
        rows = dist.sql(sql).rows()
        results[label] = {"sql": sql, "rows": rows}
        return rows

    ok = True

    def check(label, got, want, approx=False):
        nonlocal ok
        good = True
        if len(got) != len(want):
            good = False
        else:
            for a, b in zip(got, want):
                for x, y in zip(a, b):
                    if approx and isinstance(y, float):
                        if not (abs((x or 0) - y) <= max(abs(y), 1) * 1e-4):
                            good = False
                    elif x != y:
                        good = False
        if not good:
            ok = False
            print(f"[{pid}] MISMATCH {label}: got={got[:3]} want={want[:3]}",
                  flush=True)

    m = ~np.isnan(v)

    # 1. keyless aggregate with filter
    r = run("MH_KEYLESS")
    f = k < 200
    fv = v[f & m]
    check("keyless", r, [(
        int(f.sum()), float(fv.sum()), float(fv.mean()),
        float(fv.min()), float(fv.max()),
    )], approx=True)

    # 2. group-by
    r = run("MH_GROUPBY")
    want = []
    for gg in sorted(set(g.tolist())):
        selg = g == gg
        vv = v[selg & m]
        want.append((gg, int(selg.sum()), float(vv.sum()), float(vv.mean())))
    check("groupby", r, want, approx=True)

    # 3. join (replicated dim) + group-by
    r = run("MH_JOIN_GROUPBY")
    nm_of = dim_nm[k]
    want = []
    for u in sorted(set(nm_of.tolist())):
        s2 = nm_of == u
        want.append((int(u), int(s2.sum()), float(v[s2 & m].sum())))
    check("join_groupby", r, want, approx=True)

    # 4. dict-string group-by (global dictionary ids)
    r = run("MH_STRING_GROUPBY")
    import collections

    cnt = collections.Counter(names.tolist())
    want = [(s2, cnt[s2]) for s2 in sorted(cnt)]
    check("string_groupby", r, want)

    # 5. distributed top-k
    r = run("MH_TOPK")
    order = np.argsort(-np.where(m, v, -np.inf), kind="stable")[:25]
    want = [(int(k[i]), float(v[i])) for i in order]
    check("topk", r, want, approx=True)

    # 5a. distributed FULL sort (no LIMIT): gather + aggregator sort
    r = run("MH_FULL_SORT")
    sel = np.flatnonzero(m & (v > 1.5))
    fo = sel[np.lexsort((k[sel], -v[sel]))]
    want = [(int(k[i]), float(v[i])) for i in fo]
    check("full_sort", r, want, approx=True)

    # 5b. non-decomposable aggregates: repartition-by-group-key path
    r = run("MH_COUNT_DISTINCT")
    want = []
    for gg in sorted(set(g.tolist())):
        selg = g == gg
        want.append((gg, len(set(k[selg].tolist())), int(selg.sum())))
    check("groupby_count_distinct", r, want)

    r = run("MH_MEDIAN")
    want = []
    for gg in range(5):
        vv = v[(g == gg) & m]
        want.append((gg, float(np.median(vv))))
    check("groupby_median", r, want, approx=True)

    # dict-string MIN/MAX (excluded from the decomposable path: merged
    # ids order by id, not lexicographic rank)
    r = run("MH_MINMAX_STRING")
    want = []
    for gg in sorted(set(g.tolist())):
        ss = sorted(names[g == gg].tolist())
        want.append((gg, ss[0], ss[-1]))
    check("groupby_minmax_string", r, want)

    # 5c. keyless DISTINCT: value-partitioned, merged by exact SUM
    r = run("MH_KEYLESS_DISTINCT")
    nd = len(set(k[g < 30].tolist()))
    got_exact, got_approx = r[0]
    if got_exact != nd or not (0.9 * nd <= got_approx <= 1.1 * nd):
        ok = False
        print(f"[{pid}] MISMATCH keyless_distinct: {r} want {nd}",
              flush=True)

    # 5d. fact-fact distributed hash join: BOTH sides partitioned → the
    # engine hash-repartitions probe and build by the join key so
    # matching rows co-locate (DistEngine._colocate_joins).  Keys are
    # SKEWED (half of all orders on key 0) — correctness must hold with
    # a hot key resident wholly on one host.
    r = run("MH_FACT_FACT_JOIN")
    # numpy oracle over the FULL data
    import collections as C

    per_key_cnt = C.Counter(ok_keys.tolist())
    per_key_w = C.defaultdict(float)
    for kk, ww in zip(ok_keys.tolist(), o_w.tolist()):
        per_key_w[kk] += ww
    cnt_j = sum(per_key_cnt.get(int(kk), 0) for kk in k)
    sv = float(sum(
        (0.0 if np.isnan(vv) else vv) * per_key_cnt.get(int(kk), 0)
        for kk, vv in zip(k, v)
    ))
    sw = float(sum(per_key_w.get(int(kk), 0.0) for kk in k))
    check("fact_fact_join", r, [(cnt_j, sv, sw)], approx=True)

    r = run("MH_FACT_FACT_JOIN_GROUPBY")
    hot = C.Counter(ok_keys[o_w > 0.5].tolist())
    want_map = C.defaultdict(int)
    for kk, gg in zip(k.tolist(), g.tolist()):
        want_map[gg] += hot.get(kk, 0)
    want = [(gg, want_map[gg]) for gg in sorted(want_map) if want_map[gg]]
    check("fact_fact_join_groupby", r, want)

    # 5e. distributed WINDOW functions: partition-key repartition →
    # complete partitions per host → local window, vs numpy oracle
    r = run("MH_WINDOW")
    sel6 = np.flatnonzero(g < 6)
    order6 = sel6[np.lexsort((names[sel6], k[sel6], g[sel6]))]
    ordered = [
        (int(g[i]), int(k[i]), names[i],
         None if np.isnan(v[i]) else float(v[i]))
        for i in order6
    ]
    # RANGE-peer semantics: rows tied on (k, s) within a partition share
    # the running sum at their LAST peer; row_number stays per-row.
    # SUM over zero non-null contributions is NULL.
    want = []
    acc = {}
    cntn = {}
    rnc = {}
    j = 0
    while j < len(ordered):
        gg, kk, ss, _ = ordered[j]
        e = j
        run_sum = 0.0
        run_cnt = 0
        while e < len(ordered) and ordered[e][:3] == (gg, kk, ss):
            if ordered[e][3] is not None:
                run_sum += ordered[e][3]
                run_cnt += 1
            e += 1
        acc[gg] = acc.get(gg, 0.0) + run_sum
        cntn[gg] = cntn.get(gg, 0) + run_cnt
        for _t in range(j, e):
            rnc[gg] = rnc.get(gg, 0) + 1
            want.append((gg, kk, acc[gg] if cntn[gg] else None, rnc[gg]))
        j = e
    if len(r) != len(want):
        ok = False
        print(f"[{pid}] MISMATCH window rows: {len(r)} != {len(want)}",
              flush=True)
    else:
        # rows tied on the final ORDER BY (g, k, s) may appear in any
        # order; (g, row_number) is unique — compare on that order
        r_s = sorted(r, key=lambda x: (x[0], x[3]))
        w_s = sorted(want, key=lambda x: (x[0], x[3]))
        for got_row, want_row in zip(r_s, w_s):
            bad = (got_row[0] != want_row[0] or got_row[1] != want_row[1]
                   or got_row[3] != want_row[3]
                   or (got_row[2] is None) != (want_row[2] is None))
            if not bad and want_row[2] is not None:
                bad = abs(got_row[2] - want_row[2]) \
                    > max(abs(want_row[2]), 1) * 1e-3
            if bad:
                ok = False
                print(f"[{pid}] MISMATCH window: {got_row} vs {want_row}",
                      flush=True)
                break

    # 5e2. LAG + RANK over the repartitioned windows (navigation +
    # ranking functions distribute through the same exchange)
    r = run("MH_WINDOW_LAG_RANK")
    sel4 = np.flatnonzero((g < 4) & m)
    o4 = sel4[np.lexsort((v[sel4], names[sel4], k[sel4], g[sel4]))]
    want = []
    prev_k = {}
    kcount = {}
    krank = {}
    for i in o4:
        gg, kk = int(g[i]), int(k[i])
        if gg not in kcount:
            kcount[gg] = 0
            krank[gg] = {}
        kcount[gg] += 1
        if kk not in krank[gg]:
            krank[gg][kk] = kcount[gg]
        want.append((gg, kk, prev_k.get(gg), krank[gg][kk]))
        prev_k[gg] = kk
    check("window_lag_rank", r, want)

    # 5f. GLOBAL window (no PARTITION BY): aggregator-window fallback
    r = run("MH_GLOBAL_WINDOW")
    selg = np.flatnonzero((k < 3) & m)
    og = selg[np.lexsort((v[selg], names[selg], k[selg]))]
    wantg = [(int(k[i]), rn + 1) for rn, i in enumerate(og)]
    check("global_window", r, wantg)

    # 6. SHARD KEY routed loading (load_multihost): identical full data
    # passed on every host; hash routing keeps disjoint row partitions
    # covering all rows
    local_n = db.catalog.get_table("sharded").num_rows
    total = sum(rt.allgather_scalar(local_n))
    r = run("MH_SHARD_LOAD")
    if total != n or r[0][0] != n:
        ok = False
        print(f"[{pid}] MISMATCH shard_load: local={local_n} total={total} "
              f"sql={r}", flush=True)

    # 7. the rig's added GROUP BY k: B2 and B3 in each leaf on the card
    r = run("MH_GROUPBY_K")
    want = []
    for kk in sorted(set(k.tolist())):
        vv = v[(k == kk) & m]
        want.append((kk, int((k == kk).sum()), float(vv.sum()),
                     float(vv.min()), float(vv.max())))
    check("groupby_k", r, want, approx=True)

    if out_path and rt.is_leader:
        with open(out_path, "w") as f:
            json.dump(results, f)
    rt.shutdown()
    print(f"[{pid}] " + ("PARITY_OK" if ok else "PARITY_FAILED"), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         sys.argv[4] if len(sys.argv) > 4 else None)
