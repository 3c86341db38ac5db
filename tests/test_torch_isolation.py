"""heavydb_tpu_torch stands alone: importing it loads neither jax nor any
heavydb_tpu module, no import statement in the port, in chip_smoke.py or
in the port's cluster workers names them, and connect() never quietly
falls back to the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import heavydb_tpu_torch as hdt_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import sys, heavydb_tpu_torch, heavydb_tpu_torch.kernels.gate\n"
        "import heavydb_tpu_torch.exec.radix_tier, heavydb_tpu_torch.kernels.tile_sort\n"
        "import heavydb_tpu_torch.kernels.radix_groupby\n"
        "import heavydb_tpu_torch.storage.persist, heavydb_tpu_torch.storage.refresh\n"
        "import heavydb_tpu_torch.io.csv_import, heavydb_tpu_torch.io.csv_export\n"
        "import heavydb_tpu_torch.io.geo_import, heavydb_tpu_torch.io.raster_import\n"
        "import heavydb_tpu_torch.io.stream, heavydb_tpu_torch.io.remote\n"
        "import heavydb_tpu_torch.server.server, heavydb_tpu_torch.server.http_server\n"
        "import heavydb_tpu_torch.client.client, heavydb_tpu_torch.client.dbapi\n"
        "import heavydb_tpu_torch.cli\n"
        "import heavydb_tpu_torch.parallel.mesh, heavydb_tpu_torch.parallel.dist_query\n"
        "import heavydb_tpu_torch.parallel.multihost, heavydb_tpu_torch.parallel.dist_engine\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'heavydb_tpu' or m.startswith('heavydb_tpu.')]\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _sources():
    pkg = os.path.join(ROOT, "heavydb_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    for worker in ("torch_multihost_worker.py", "torch_multihost_persist_worker.py"):
        yield os.path.join(ROOT, "tests", worker)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "heavydb_tpu")


def test_no_import_statement_names_jax_or_the_reference():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_connect_needs_cuda_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hdt_torch.connect()
    assert hdt_torch.connect(device="cpu").device == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
