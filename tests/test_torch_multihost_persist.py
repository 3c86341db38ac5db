"""The port's distributed persistence on the CPU, as
tests/test_multihost.py's restart and divergence cases for the JAX
package: per-host epoch checkpoints and dist_meta.json survive a restart
of the whole cluster (check_table_consistency passes, the recorded rows
come back), and a host that lost rows is caught on every host."""

import os

from torch_cluster import run_cluster

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_multihost_persist_worker.py")


def _phase(phase: str, nprocs: int, root: str):
    return run_cluster(lambda pid, port: [WORKER, phase, pid, nprocs, port, root], nprocs)


def test_cluster_restart_parity(tmp_path):
    root = str(tmp_path)
    for rc, out in _phase("load", 4, root):
        assert rc == 0 and "LOAD_OK" in out, out[-3000:]
    for rc, out in _phase("restart", 4, root):
        assert rc == 0 and "RESTART_OK" in out, out[-3000:]


def test_cluster_consistency_detects_divergence(tmp_path):
    root = str(tmp_path)
    for rc, out in _phase("load", 2, root):
        assert rc == 0 and "LOAD_OK" in out, out[-3000:]
    for rc, out in _phase("diverge", 2, root):
        assert rc == 0 and "DIVERGENCE_DETECTED" in out, out[-3000:]
