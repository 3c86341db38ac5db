"""The port's sort and radix group-by kernels (heavydb_tpu_torch/kernels/
tile_sort.py, radix_groupby.py) against the JAX package: `sort_tiles`
against the Pallas kernel in interpret mode, `sparse_groupby` against the
reference's numpy specification `_ref_sparse_groupby`.  On the CPU each
wrapper runs its plain PyTorch version, so the launch counters stay at 0.

Tolerances: gid_out, len_out, num_groups, overflow bit 1, counts, integer
sums, MIN and MAX are exact (MIN/MAX compare -0.0 equal to +0.0 and NaN
equal to NaN); float32 sums use rtol=1e-4, atol=1e-3 (the order of
summation differs); float64 sums against the reference's hi + lo pair use
rtol=1e-9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heavydb_tpu.kernels import radix_groupby as JRG
from heavydb_tpu.kernels.tile_sort import sort_tiles as j_sort_tiles
from heavydb_tpu_torch.kernels import gate, radix_groupby, tile_sort

F32_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(autouse=True)
def no_launches():
    counters = (tile_sort.sort_tiles, radix_groupby.radix_partition,
                radix_groupby.radix_group)
    yield
    assert [c.launches for c in counters] == [0, 0, 0]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# B4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_payloads", [0, 1, 4])
def test_sort_tiles_matches_pallas_interpret(n_payloads):
    rng = np.random.default_rng(5 + n_payloads)
    T = 1024
    n = 3 * T
    # few distinct keys: many ties, where the unstable sorts may differ
    k = rng.integers(-50, 50, n).astype(np.int32)
    pays = [rng.integers(0, 10**6, n).astype(np.int32)
            for _ in range(n_payloads)]
    j = j_sort_tiles(jnp.asarray(k), [jnp.asarray(p) for p in pays],
                     rows_per_tile=T, n_payloads=n_payloads, interpret=True)
    j = [np.asarray(x) for x in j]
    out = [o.numpy() for o in tile_sort.sort_tiles(_t(k), [_t(p) for p in pays], T)]
    assert np.array_equal(out[0], j[0])
    for t in range(3):
        sl = slice(t * T, (t + 1) * T)
        for key in np.unique(out[0][sl]):
            at = out[0][sl] == key
            for pj, po, p in zip(j[1:], out[1:], pays):
                # payloads of equal keys as multisets, and each one the
                # payload of a row with that key
                assert sorted(po[sl][at]) == sorted(pj[sl][at])
                assert sorted(po[sl][at]) == sorted(p[sl][k[sl] == key])


def test_sort_tiles_rejects_bad_shapes():
    k = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError):
        tile_sort.sort_tiles(k, [], 64)        # not a multiple of the tile
    with pytest.raises(ValueError):
        tile_sort.sort_tiles(k[:96], [], 48)   # not a power of two
    with pytest.raises(ValueError):
        tile_sort.sort_tiles(k[:64], [k[:64].long()], 64)  # 8-byte payload


# ---------------------------------------------------------------------------
# B5 + B6
# ---------------------------------------------------------------------------


def _case(seed, n, num_slots):
    """gid with masked (-1) and out-of-range rows, a contribution mask and
    one stream of every class; min/max carry NaN, -0.0 and +0.0."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(-3, num_slots + 3, n).astype(np.int32)
    gid[rng.random(n) < 0.1] = -1
    cm = rng.random(n) < 0.8
    f32 = np.where(cm, rng.standard_normal(n), 0).astype(np.float32)
    f64 = np.where(cm, rng.standard_normal(n) * 1e3, 0)
    i64 = np.where(cm, rng.integers(-2**40, 2**40, n), 0).astype(np.int64)
    i32 = np.where(cm, rng.integers(-10**6, 10**6, n), 0).astype(np.int32)
    fmm = rng.choice(np.array([np.nan, -0.0, 0.0, 1.5, -2.5], np.float32), n)
    fmm = np.where(rng.random(n) < 0.5, rng.standard_normal(n), fmm).astype(np.float32)
    imin = np.where(cm, i32, np.iinfo(np.int32).max).astype(np.int32)
    fmax = np.where(cm, fmm, -np.inf).astype(np.float32)
    return dict(gid=gid, cm=cm, f32=f32, f64=f64, i64=i64, i32=i32,
                imin=imin, fmax=fmax, fmin=np.where(cm, fmm, np.inf).astype(np.float32))


def _port_streams(d):
    return [(_t(d["cm"]), "count"), (_t(d["i64"]), "sumi"),
            (_t(d["f32"]), "sumf"), (_t(d["f64"]), "sumd"),
            (_t(d["imin"]), "min"), (_t(d["fmax"]), "max"),
            (_t(d["fmin"]), "min")]


def _ref(d, num_slots, cap):
    """The reference's specification on the same rows: its stream classes
    for the same sums (int32 count, double-single f64)."""
    hi = d["f64"].astype(np.float32)
    lo = (d["f64"] - hi.astype(np.float64)).astype(np.float32)
    streams = [d["cm"].astype(np.int32), d["i32"], d["f32"], hi, lo,
               d["imin"], d["fmax"], d["fmin"]]
    ops = ("sumi32", "sumi32", "sumf", "sumds_hi", "sumds_lo", "min", "max",
           "min")
    return JRG._ref_sparse_groupby(d["gid"], streams, num_slots, ops, cap)


def _same_minmax(a, b):
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize("seed,n,num_slots", [
    (0, 3000, 1 << 12), (1, 5000, 1 << 14), (2, 6000, 1 << 16),
    (3, 4000, 300), (4, 9000, 1 << 13)])
def test_sparse_groupby_matches_reference(seed, n, num_slots):
    d = _case(seed, n, num_slots)
    cap = 1 << 14
    g, ln, tot, ng, ovf = radix_groupby.sparse_groupby(
        _t(d["gid"]), _port_streams(d), num_slots, cap)
    # the i64 sum against the reference's int32 one: same rows, int32 values
    d32 = dict(d, i64=d["i32"].astype(np.int64))
    tot32 = radix_groupby.sparse_groupby(_t(d["gid"]), _port_streams(d32),
                                         num_slots, cap)[2][1]
    rg, rln, rtot, rng_, rovf = _ref(d, num_slots, cap)
    m = int(ng)
    assert m == int(rng_) and m <= cap
    assert np.array_equal(g.numpy()[:m], rg[:m])
    assert np.array_equal(ln.numpy()[:m], rln[:m])
    assert int(ovf) & 2 == int(rovf) & 2 == 0
    assert np.array_equal(tot[0].numpy()[:m], rtot[0][:m])      # count
    assert np.array_equal(tot32.numpy()[:m], rtot[1][:m])       # sumi
    np.testing.assert_allclose(tot[2].numpy()[:m], rtot[2][:m], **F32_TOL)
    f64_ref = rtot[3][:m].astype(np.float64) + rtot[4][:m].astype(np.float64)
    np.testing.assert_allclose(tot[3].numpy()[:m], f64_ref, rtol=1e-9, atol=1e-6)
    for j, r in ((4, 5), (5, 6), (6, 7)):                       # min / max
        _same_minmax(tot[j].numpy()[:m], rtot[r][:m])
    # the exact int64 sum against numpy
    ok = (d["gid"] >= 0) & (d["gid"] < num_slots)
    want = {}
    for gg, v in zip(d["gid"][ok].tolist(), d["i64"][ok].tolist()):
        want[gg] = want.get(gg, 0) + v
    assert dict(zip(g.numpy()[:m].tolist(), tot[1].numpy()[:m].tolist())) == want


def test_radix_partition_plain_regions_follow_the_top_hash_bits():
    d = _case(11, 20_000, 1 << 16)
    gid = _t(d["gid"])
    rows = torch.arange(gid.shape[0], dtype=torch.int32)
    hb, parts, counts, offsets = radix_groupby.radix_partition_plain(
        gid, [(rows, "sumi")], 1 << 16, 3)
    ok = (d["gid"] >= 0) & (d["gid"] < 1 << 16)
    assert int(counts.sum()) == hb.shape[0] == int(ok.sum())
    assert torch.equal(offsets, torch.cumsum(counts, 0) - counts)
    # each row once, with its own hash, in the region of its top 3 bits
    src = parts[0].long()
    assert sorted(src.tolist()) == np.nonzero(ok)[0].tolist()
    h = (torch.from_numpy(d["gid"]).long()[src] * radix_groupby._MULT) & 0xFFFFFFFF
    assert torch.equal(hb, (h ^ 0x80000000).to(torch.int32))
    assert torch.equal(h >> 29, torch.repeat_interleave(torch.arange(8), counts))


def test_sparse_groupby_drops_masked_and_out_of_range_rows():
    gid = np.array([5, -1, 7, 5, 2**20, -7, 7, 9], np.int32)
    v = np.arange(8, dtype=np.int64)
    g, ln, tot, ng, ovf = radix_groupby.sparse_groupby(
        _t(gid), [(_t(v), "sumi")], 10, 8)
    rg, rln, rtot, rng_, _ = JRG._ref_sparse_groupby(
        gid, [v.astype(np.int32)], 10, ("sumi32",), 8)
    assert int(ng) == int(rng_) == 3
    assert np.array_equal(g.numpy(), rg) and np.array_equal(ln.numpy(), rln)
    assert dict(zip(g.numpy()[:3].tolist(), tot[0].numpy()[:3].tolist())) == \
        {5: 3, 7: 8, 9: 7}


def test_sparse_groupby_cap_too_small():
    d = _case(9, 4000, 1 << 13)
    cap = 256
    g, ln, tot, ng, ovf = radix_groupby.sparse_groupby(
        _t(d["gid"]), _port_streams(d), 1 << 13, cap)
    rg, rln, rtot, rng_, rovf = _ref(d, 1 << 13, cap)
    assert int(ng) == int(rng_) > cap
    assert int(ovf) & 2 == int(rovf) & 2 == 2
    assert np.array_equal(g.numpy(), rg) and np.array_equal(ln.numpy(), rln)


def test_sparse_groupby_partition_overflow_sets_bit0():
    # one hot group larger than a partition tile: bit 0 at the port's
    # partition capacity (the reference flags a group past its own tile)
    n = radix_groupby.GROUP_TILE + 500
    gid = np.full(n, 42, np.int32)
    gid[:300] = np.arange(300)
    _, _, _, ng, ovf = radix_groupby.sparse_groupby(_t(gid), [], 1 << 20, 512)
    assert int(ng) == 300 and int(ovf) == 1
    assert radix_groupby.plan(n) == 2


def test_plan_keeps_partitions_within_the_tile():
    assert radix_groupby.plan(100) == 0
    assert radix_groupby.plan(117_440_512) == 15
    mean = 117_440_512 / (1 << 15)
    assert mean < radix_groupby.GROUP_TILE / 2


def test_gate_checks_run_on_plain_versions():
    # the gate's B4-B6 checks, with both sides on their plain versions
    gate._check_sorts(torch.device("cpu"))
