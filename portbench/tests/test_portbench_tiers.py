"""The tiers of the port that `synth.highcard.c1`'s templates drive on the
CPU, at the test scale and at 2 x 10^5 rows, read from the debug timer's
tree: the card's run drives the same ones."""

import pytest

from portbench.harness import load_tables, run_query
from portbench.spec import Cell
from portbench.tests.test_portbench_cells import scale_of

CELL = "synth.highcard.c1"
TIERS = {"BH002": "sort", "BH003": "sort", "BH004": "radix", "Q10M_AGGS": "radix"}


def _tiers(node) -> list:
    out = [node["tier"]] if "tier" in node else []
    for c in node.get("children", []):
        out += _tiers(c)
    return out


@pytest.mark.parametrize("scale", [scale_of(CELL), 0.002])
def test_highcard_templates_take_their_tiers(scale):
    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.config import Config

    cell = Cell(CELL)
    db = hdt.connect(device="cpu", config=Config(enable_debug_timer=True))
    load_tables(db, cell.generator.make(cell.config, 11, scale, db.device))
    for name, tier in TIERS.items():
        tpl = cell.templates[name]
        run_query(db, tpl.SQL.format(c=4), False)
        assert _tiers(db.last_query_timings) == [tier], name
