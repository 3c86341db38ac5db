"""Helpers of the port's multi-host tests: start N worker processes that
join one torch.distributed gloo group on a free localhost port, each with a
wall-clock limit, and kill the rest as soon as one fails, so that no peer
waits out gloo's timeout; and compare the rows of the rig's queries."""

import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _wait_all(procs, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = any(p.returncode not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            return
        time.sleep(0.05)


def run_cluster(args_of, nprocs: int, timeout: float = 240.0):
    """[(returncode, output)] of `python worker args...` for each pid, where
    args_of(pid, port) gives the worker and its arguments.  A second port
    is tried once if the first turns out to be taken."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for attempt in range(2):
        port = free_port()
        logs = [tempfile.TemporaryFile(mode="w+") for _ in range(nprocs)]
        procs = [subprocess.Popen([sys.executable, *map(str, args_of(pid, port))],
                                  stdout=log, stderr=subprocess.STDOUT, text=True,
                                  env=env, cwd=ROOT)
                 for pid, log in enumerate(logs)]
        try:
            _wait_all(procs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for p, log in zip(procs, logs):
            log.seek(0)
            outs.append((p.returncode, log.read()))
            log.close()
        if attempt == 0 and any("address already in use" in out.lower() for _, out in outs):
            continue
        return outs


# the rig's queries whose row order SQL leaves open among peers of a
# window's ORDER BY: their rows compare as multisets
UNORDERED = {"MH_WINDOW", "MH_WINDOW_LAG_RANK", "MH_GLOBAL_WINDOW"}


def _exact_part(row):
    """A row's sort key over its columns that are not floats, NULL first."""
    return [(x is not None, x) for x in row if not isinstance(x, float)]


def assert_rows_close(label, got, want, rtol=1e-4):
    """Rows equal, floats within rtol of max(|want|, 1) (FLOAT sums add in
    another order), in order unless the query is in UNORDERED."""
    got, want = [list(r) for r in got], [list(r) for r in want]
    if label in UNORDERED:
        got, want = sorted(got, key=_exact_part), sorted(want, key=_exact_part)
    assert len(got) == len(want), (label, len(got), len(want))
    for a, b in zip(got, want):
        ok = len(a) == len(b) and all(
            (isinstance(y, float) and isinstance(x, (int, float))
             and abs(x - y) <= max(abs(y), 1) * rtol) or x == y
            for x, y in zip(a, b))
        assert ok, (label, a, b)
