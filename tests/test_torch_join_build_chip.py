"""Kernel J1 (kernels/join_build.py) on the card: `ops/join.py`
`build_perfect` through the kernel against the same build through the
plain version (`perfect_count_plain`, `torch.bincount`) on the same card,
bit for bit on counts, offsets and payload, at the shapes TPC-H SF10's
builds give it.  Every test needs a CUDA card and skips without one.

This file imports no JAX, so that it runs where JAX is not installed:

    python3 -m pytest tests/test_torch_join_build_chip.py -q --noconftest -p no:cacheprovider
"""

import pytest
import torch

from heavydb_tpu_torch.kernels import join_build
from heavydb_tpu_torch.ops import join as J

LINEITEM_PADDED = 67_108_864  # 59,986,052 rows padded to their bucket
LINEITEM_ROWS = 59_986_052
ORDERKEY_RANGE = 60_000_000


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from heavydb_tpu_torch.kernels.gate import kernel_gate

    kernel_gate(torch.device("cuda"))  # builds every kernel first
    return torch.device("cuda")


def _plain_build(keys, valid, num_rows, key_min, key_range):
    slot, counts = join_build.perfect_count_plain(keys, valid, num_rows, key_min, key_range)
    offsets = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    payload = torch.sort(slot, stable=True).indices.to(torch.int32)
    return J.PerfectBuild(counts, offsets, payload, key_min)


def _same_build(keys, valid, num_rows, key_min, key_range):
    before = join_build.perfect_count.launches
    got = J.build_perfect(keys, valid, num_rows, key_min, key_range)
    assert join_build.perfect_count.launches == before + 1
    want = _plain_build(keys, valid, num_rows, key_min, key_range)
    for name in ("counts", "offsets", "payload"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.device == keys.device, name
        assert torch.equal(a, b), name
    return got


def _lineitem_keys(device, gen):
    """l_orderkey in row order: runs of 1-7 rows of one key over the first
    8 of every 32 keys (TPC-H's sparse order keys), then the padded tail."""
    n_orders = LINEITEM_ROWS // 4
    okeys = torch.arange(n_orders, device=device, dtype=torch.int64)
    okeys = (okeys // 8) * 32 + okeys % 8 + 1
    lines = torch.randint(1, 8, (n_orders,), device=device, generator=gen)
    keys = torch.repeat_interleave(okeys, lines)[:LINEITEM_ROWS]
    out = torch.zeros(LINEITEM_PADDED, dtype=torch.int64, device=device)
    out[:keys.shape[0]] = keys
    return out, int(keys.shape[0])


@pytest.mark.chip
@pytest.mark.parametrize("kept", [0.01, 0.63, 1.0])
def test_lineitem_build(card, kept):
    """67,108,864 padded rows over a range of 6 x 10^7, with 1 %, 63 % and
    every row kept by the build's pushed filter."""
    gen = torch.Generator(device=card).manual_seed(28)
    keys, live = _lineitem_keys(card, gen)
    valid = None if kept == 1.0 else (
        torch.rand(keys.shape[0], device=card, generator=gen) < kept)
    got = _same_build(keys, valid, live, 1, ORDERKEY_RANGE)
    assert int(got.counts.sum()) == (live if valid is None else int(valid[:live].sum()))


@pytest.mark.chip
def test_unique_keys(card):
    """16,777,216 unique keys in no order (a primary key's build)."""
    n = 16_777_216
    gen = torch.Generator(device=card).manual_seed(29)
    keys = torch.randperm(n, device=card, generator=gen) + 5
    got = _same_build(keys, None, n, 5, n)
    assert bool((got.counts == 1).all())


@pytest.mark.chip
def test_small_range(card):
    """key_range 25 (nation's keys) under many rows: keys outside the
    range on both sides, a validity and rows past num_rows."""
    n = 1 << 24
    gen = torch.Generator(device=card).manual_seed(30)
    keys = torch.randint(-2, 28, (n,), device=card, generator=gen)
    valid = torch.rand(n, device=card, generator=gen) < 0.9
    _same_build(keys, valid, n - 1000, 0, 25)


@pytest.mark.chip
def test_second_card(card):
    """A build on cuda:1 runs on that card, on its own stream."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    dev = torch.device("cuda:1")
    gen = torch.Generator(device=dev).manual_seed(31)
    keys = torch.randint(0, 1 << 20, (1 << 22,), device=dev, generator=gen)
    valid = torch.rand(1 << 22, device=dev, generator=gen) < 0.5
    _same_build(keys, valid, (1 << 22) - 3, 0, 1 << 20)


@pytest.mark.chip
def test_range_past_int32_slots_raises(card):
    """On the card every perfect build runs J1: a key_range whose drop slot
    int32 cannot hold raises rather than take the plain version (the
    planner never gives one)."""
    keys = torch.arange(8, device=card)
    before = join_build.perfect_count.launches
    with pytest.raises(ValueError, match="key_range"):
        join_build.perfect_count(keys, None, 8, 0, join_build.MAX_RANGE + 1)
    assert join_build.perfect_count.launches == before


@pytest.mark.chip
def test_no_host_sync_and_no_bincount(card, monkeypatch):
    """build_perfect on the card reads nothing back to the host and calls
    no torch.bincount."""
    gen = torch.Generator(device=card).manual_seed(32)
    keys = torch.randint(0, 1 << 20, (1 << 22,), device=card, generator=gen)
    valid = torch.rand(1 << 22, device=card, generator=gen) < 0.5
    J.build_perfect(keys, valid, 1 << 22, 0, 1 << 20)  # warm: allocator, sort

    def no_bincount(*a, **k):
        raise AssertionError("torch.bincount on the CUDA path")

    monkeypatch.setattr(torch, "bincount", no_bincount)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = J.build_perfect(keys, valid, 1 << 22, 0, 1 << 20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    monkeypatch.undo()
    want = _plain_build(keys, valid, 1 << 22, 0, 1 << 20)
    assert torch.equal(got.counts, want.counts) and torch.equal(got.payload, want.payload)


@pytest.mark.chip
def test_launches_on_the_query_tree(card):
    """A SQL join with a perfect build launches J1, and the root of the
    query's tree counts it under `launches`."""
    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.config import Config

    db = hdt.connect(config=Config(enable_debug_timer=True))
    db.sql("CREATE TABLE a (k INT, v INT)")
    db.sql("CREATE TABLE b (k INT, w INT)")
    db.sql("INSERT INTO a VALUES (1, 1), (2, 2), (3, 3)")
    db.sql("INSERT INTO b VALUES (1, 5), (2, 6), (2, 7), (9, 1)")
    rows = db.sql("SELECT a.k, SUM(b.w) FROM a JOIN b ON a.k = b.k GROUP BY a.k").rows()
    assert sorted(rows) == [(1, 5), (2, 13)]
    assert db.last_query_timings["launches"]["perfect_count"] >= 1
