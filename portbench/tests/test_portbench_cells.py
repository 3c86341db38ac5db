"""Each cell's whole run at a few thousand rows on the CPU, the result line
the contract asks for, and the same run on the card where there is one."""

import copy
import json
import os
import subprocess
import sys

import pytest

from portbench import spec
from portbench.harness import run
from portbench.spec import ROOT, Cell, benchmark, load_json

CELLS = [w["name"] for w in benchmark()["workloads"]]


def scale_of(cell):
    """The cell's configuration's `test_scale`: its sizes times it make a
    few thousand rows a table."""
    return Cell(cell).config["test_scale"]


def small_run(cell, seed, trace=False, seconds=0.5):
    return run(cell, seed, seconds, trace, "cpu", scale=scale_of(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell):
    out = small_run(cell, 2**31 + 12345)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in Cell(cell).end_to_end}
    assert out["checks"]["values_checked"]["value"] > 0


def test_every_configuration_states_its_test_scale():
    for c in benchmark()["configs"]:
        cell = next(w["name"] for w in benchmark()["workloads"] if w["config"] == c["name"])
        assert 0 < scale_of(cell) < 1e-2, c["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_cpu(cell):
    out = small_run(cell, 77, trace=True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    assert out["breakdown"]["idle_gaps"]
    # the port's spans on the host are read; the CPU has no device trace,
    # so the device metrics and the device's idle time by span are left out
    listed = {m["name"] for m in Cell(cell).per_layer}
    host = {"plan_ms", "parse_ms", "retries_per_query", "kernel_builds_per_query"}
    assert set(out["metrics"]) == listed & host
    if "parse_ms" in listed:
        assert out["metrics"]["parse_ms"]["value"] > 0


def _sharded(tmp_path, monkeypatch, shards, chips):
    """BENCHMARK.json with `tpch.sf10.power` on `chips` chips and its
    configuration's file a copy that states `shards`."""
    bench = copy.deepcopy(benchmark())
    conf = next(c for c in bench["configs"] if c["name"] == "tpch_sf10")
    path = tmp_path / "tpch_sf10.json"
    path.write_text(json.dumps({**load_json(os.path.join(ROOT, conf["file"])), "shards": shards}))
    conf["file"] = str(path)
    next(w for w in bench["workloads"] if w["name"] == "tpch.sf10.power")["chips"] = chips
    monkeypatch.setattr(spec, "benchmark", lambda: bench)


def test_sharded_cell_runs_correct_on_cpu(tmp_path, monkeypatch):
    """A configuration stating 4 shards: the port connects with
    Config(num_shards=4), a mesh of 4 virtual shards on the CPU, runs its
    leaves a shard each, and the run is correct and counts 4 cards."""
    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.exec.executor import Executor

    _sharded(tmp_path, monkeypatch, 4, 4)
    meshes, sharded = [], []
    connect, compound = hdt.connect, Executor._try_sharded_compound

    def connecting(*args, **kw):
        db = connect(*args, **kw)
        meshes.append(db.executor.mesh.size)
        return db

    def counted(self, node, memo):
        out = compound(self, node, memo)
        sharded.append(out is not None)
        return out

    monkeypatch.setattr(hdt, "connect", connecting)
    monkeypatch.setattr(Executor, "_try_sharded_compound", counted)
    out = run("tpch.sf10.power", 2**31 + 4321, 0.5, False, "cpu", scale=scale_of("tpch.sf10.power"))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["checks"]["values_checked"]["value"] > 0
    assert meshes == [4] and any(sharded)
    assert out["device"]["count"] == 4 and out["device"]["memory_peak_bytes_by_card"] == []


@pytest.mark.parametrize("shards, chips", [(4, 1), (1, 4), (2, 4)])
def test_cell_chips_must_be_its_shards(tmp_path, monkeypatch, shards, chips):
    _sharded(tmp_path, monkeypatch, shards, chips)
    with pytest.raises(ValueError, match="chips for the"):
        Cell("tpch.sf10.power")


@pytest.mark.parametrize("config", [c["name"] for c in benchmark()["configs"]])
def test_make_twice_gives_the_same_tables(config):
    """The check makes the tables again after the window: one seed, the
    same tables, bit for bit."""
    import torch

    cell = Cell(next(w["name"] for w in benchmark()["workloads"] if w["config"] == config))
    seed = 2**31 + 99
    made = [cell.generator.make(cell.config, seed, cell.config["test_scale"], torch.device("cpu"))
            for _ in range(2)]
    other = cell.generator.make(cell.config, seed + 1, cell.config["test_scale"],
                                torch.device("cpu"))
    a, b = made
    assert a.keys() == b.keys()
    for name in a:
        assert a[name]["ddl"] == b[name]["ddl"] and a[name].get("dicts") == b[name].get("dicts")
        assert a[name]["columns"].keys() == b[name]["columns"].keys()
        for c, x in a[name]["columns"].items():
            assert x.dtype == b[name]["columns"][c].dtype
            assert torch.equal(x, b[name]["columns"][c]), (name, c)
    # and the seed changes them
    assert any(not torch.equal(x, other[n]["columns"][c]) for n in a
               for c, x in a[n]["columns"].items() if x.shape == other[n]["columns"][c].shape)


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is there")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cuda, cell):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", "3",
                        "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
