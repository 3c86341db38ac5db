"""Session-scoped interrupts on the port's server against the JAX package's.

The two scenarios of tests/test_interrupt_sessions.py (the RPC interrupt of
two of five concurrent sessions, and KILL QUERY of one of three) against a
server of each package in this process (the port's on device="cpu").  Each
session runs one batch of GROUP BY statements; the test waits until
get_queries_info lists every session as running and then interrupts, with
no sleep.  Exactly the targeted sessions raise QueryInterrupted; the others
finish their batch with the reference's rows (the FLOAT sums within
rtol 1e-5: their order of addition differs).  The port's executor keeps
the interrupt hook per thread, so a handler thread's hook is its own
session's (heavydb_tpu_torch/exec/executor.py, _PerThread).
"""

import threading
import time

import numpy as np
import pytest

from torch_server_pair import SIDES, connected, serving

ROWS = 20_000
KEYS = 500
# one statement repeated: the reference compiles it once (a new HAVING
# constant a statement would compile it again each time)
BATCH = ";\n".join(["SELECT k, count(*), sum(v), avg(v) FROM it GROUP BY k "
                    "HAVING count(*) > 30 ORDER BY k"] * 60)
SCENARIOS = {"interrupt": (5, {1, 3}), "kill": (3, {2})}


def _scenario(side, which):
    n, victims = SCENARIOS[which]
    rng = np.random.default_rng(18)
    with serving(side) as srv:
        host, port = srv.server_address
        with connected(side, srv) as c:
            c.sql("CREATE TABLE it (k INT, v FLOAT)")
            c.load_table("it", {"k": rng.integers(0, KEYS, ROWS).astype(np.int32),
                                "v": rng.random(ROWS).astype(np.float32)})
        conns = [side.client.Connection(host, port) for _ in range(n)]
        outcomes = [None] * n
        started = threading.Barrier(n + 1)

        def run(i):
            try:
                started.wait(timeout=30)
                rs = conns[i].sql(BATCH)
                outcomes[i] = ("done", [tuple(r) for r in rs.rows()])
            except side.client.ServerError as e:
                outcomes[i] = (e.type, str(e))
            except Exception as e:  # noqa: BLE001 - reported below
                outcomes[i] = ("other", repr(e))

        threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(n)]
        for t in threads:
            t.start()
        started.wait(timeout=30)
        with side.client.Connection(host, port) as admin:
            want = {c.session[:8] for c in conns}
            deadline = time.monotonic() + 60
            while {q["session"] for q in admin.get_queries_info()} < want:
                assert time.monotonic() < deadline, "the sessions never ran together"
            listed = admin.get_queries_info()
            for i in sorted(victims):
                if which == "interrupt":
                    admin.call("interrupt", session=conns[i].session)
                else:
                    admin.sql(f"KILL QUERY '{conns[i].session}'")
        for t in threads:
            t.join(timeout=300)
        for c in conns:
            c.close()
    assert not any(t.is_alive() for t in threads)
    assert {q["query"] for q in listed} >= {BATCH[:200]}
    for i, out in enumerate(outcomes):
        if i in victims:
            assert out == ("QueryInterrupted", "QueryInterrupted: query interrupted by session"), \
                (i, out)
        else:
            assert out[0] == "done", (i, out)
    return outcomes


@pytest.mark.parametrize("which", list(SCENARIOS),
                         ids=["interrupt_kills_exactly_the_targeted_sessions",
                              "kill_query_statement_targets_one_session"])
def test_interrupt_sessions(which):
    got = {side.name: _scenario(side, which) for side in SIDES}
    kinds = {name: [o[0] for o in outs] for name, outs in got.items()}
    assert kinds["port"] == kinds["ref"]
    for o_port, o_ref in zip(got["port"], got["ref"]):
        if o_port[0] != "done":
            assert o_port == o_ref
            continue
        # keys and counts exactly; the FLOAT sum and its average within
        # float32 rounding (the order of addition differs)
        p, r = np.array(o_port[1]), np.array(o_ref[1])
        assert p.shape == r.shape and len(p)
        np.testing.assert_array_equal(p[:, :2], r[:, :2])
        np.testing.assert_allclose(p[:, 2:], r[:, 2:], rtol=1e-5)
        assert (p[:, 1] > 30).all()
