"""Each cell's whole run at a few thousand rows on the CPU, the result line
the contract asks for, and the same run on the card where there is one."""

import json
import subprocess
import sys

import pytest

from portbench.harness import run
from portbench.spec import ROOT, Cell, benchmark

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
