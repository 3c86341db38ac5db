"""The check that decides `correct` fails where it should: a run with the
timed path broken underneath reads incorrect, and so does the control (the
reference in the precision below the configuration's) in place of the port."""

import pytest
import torch

from portbench.control import readings
from portbench.harness import run
from portbench.spec import Cell, benchmark
from portbench.tests.test_portbench_cells import CELLS, scale_of


def small_run(cell):
    return run(cell, 4242, 0.5, False, "cpu", scale=scale_of(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_incorrect(cell, monkeypatch):
    """One value of every answer altered where the port produces it."""
    from heavydb_tpu_torch.exec.result_set import ResultSet

    raw = ResultSet.column_raw

    def altered(self, i):
        a = raw(self, i).copy()
        if i == self.col_count - 1 and a.size and a.dtype.kind in "iuf":
            a[0] += 1
        return a

    monkeypatch.setattr(ResultSet, "column_raw", altered)
    out = small_run(cell)
    assert not out["correct"]
    assert out["failed"] == 0
    assert any(c["limit"] is not None and c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_rows_left_out_is_incorrect(cell, monkeypatch):
    """The port is given the first half of every table's rows; the
    reference all of them."""
    from heavydb_tpu_torch.api import Database

    load = Database.load_table_device

    def half(self, name, data, create=False, dicts=None):
        n = next(iter(data.values())).shape[0]
        return load(self, name, {c: a[: max(n // 2, 1)] for c, a in data.items()}, create, dicts)

    monkeypatch.setattr(Database, "load_table_device", half)
    assert not small_run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_incorrect(cell):
    got = readings(Cell(cell), 31337, scale_of(cell), "cpu")
    assert not got["correct"], got


def test_queries_failing_is_incorrect(monkeypatch):
    from heavydb_tpu_torch.api import Database

    sql = Database.sql
    calls = {"n": 0}

    def sometimes(self, text, user=None):
        calls["n"] += 1
        if text.startswith("SELECT") and calls["n"] > 60 and calls["n"] % 7 == 0:
            raise RuntimeError("injected")
        return sql(self, text, user)

    monkeypatch.setattr(Database, "sql", sometimes)
    out = small_run(CELLS[0])
    assert out["failed"] > 0 and not out["correct"]


def test_control_dtype_is_below_the_configuration():
    for c in benchmark()["configs"]:
        cell = next(w["name"] for w in benchmark()["workloads"] if w["config"] == c["name"])
        ctl = Cell(cell).config["control"]
        assert getattr(torch, ctl["float"]).itemsize < 8
